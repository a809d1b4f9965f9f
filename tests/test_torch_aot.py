"""The port's program registry and its graphed programs, on the CPU.

* The registered (kernel, bucket) keys equal the JAX registry's, less the
  bench stages, plus the per-set program at the pool widths in ``core``;
  the sharded entries follow the default group's ranks as the JAX ones
  follow the devices; each difference is pinned.
* ``example_args`` has the shapes and dtypes that the entries hand their
  programs, at B = 4 and 128.
* ``GraphedProgram`` with a capture step that runs on the CPU: static
  inputs really feed it, results are clones, mismatched arguments raise, a
  failed capture raises, and the launches counted while capturing are kept
  apart from the wrappers' counters.

No pairing program runs here: the entries' programs are replaced by a
recorder, and the graphed programs are small field products.
"""
import pytest
import torch

from lodestar_tpu.aot import registry as jreg
from lodestar_tpu import params as jparams
from lodestar_tpu_torch import params
from lodestar_tpu_torch.aot import graphs, registry, warm
from lodestar_tpu_torch.crypto.bls import api
from lodestar_tpu_torch.ops.bls12_381 import buckets as bk, fp, fp_kernels as fpk
from lodestar_tpu_torch.ops.bls12_381 import tower as tw, verify as dv

CPU = "cpu"

# ---------------------------------------------------------------------------
# the registered set against the JAX registry
# ---------------------------------------------------------------------------


def _jax_keys(scope, monkeypatch, bench=False):
    if not bench:
        monkeypatch.setattr(jreg, "bench_buckets", lambda: [])
    return jreg.registered_keys(scope, device_h2c=True)


@pytest.mark.parametrize("scope", ["core", "full"])
def test_registered_keys_equal_jax_less_bench_and_sharded(scope, monkeypatch):
    jax_keys = [k for k in _jax_keys(scope, monkeypatch) if not k.startswith("sharded/")]
    each_at_pool_widths = [f"each/b{b}" for b in bk.POOL_BUCKETS]
    ours = registry.registered_keys(scope)
    if scope == "core":
        assert ours == jax_keys + each_at_pool_widths
    else:
        assert ours == jax_keys
    assert len(set(ours)) == len(ours)


def test_difference_no_bench_stages(monkeypatch):
    monkeypatch.delenv("BENCH_BATCH_MAX", raising=False)
    extra = set(_jax_keys("core", monkeypatch, bench=True)) - set(registry.registered_keys("core"))
    assert extra == {"hashed/b4096"}  # bench.py's fallback stage


def test_difference_no_sharded_entries(monkeypatch):
    """The sharded entries are gated on the default group's ranks as the
    JAX registry gates them on its devices: none in a world of one rank
    (or none), and at 8 ranks the full keys equal the JAX registry's on
    its 8 virtual devices."""
    from lodestar_tpu_torch.ops.bls12_381 import sharded as sh

    jax_full = _jax_keys("full", monkeypatch)
    assert any(k.startswith("sharded/") for k in jax_full)
    for ranks in (0, 1):
        monkeypatch.setattr(sh, "world_size", lambda: ranks)
        assert not any(k.startswith("sharded/") for k in registry.registered_keys("full"))
    monkeypatch.setattr(sh, "world_size", lambda: 8)
    assert registry.registered_keys("full") == jax_full


def test_difference_each_at_pool_widths_in_core(monkeypatch):
    assert not any(k.startswith("each/") for k in _jax_keys("core", monkeypatch))
    ours = [p for p in registry.registered_programs("core") if p.kernel == "each"]
    assert [p.bucket for p in ours] == list(bk.POOL_BUCKETS)
    assert all(p.note == "pool fallback" for p in ours)


def test_pool_programs_are_the_core_scope_and_follow_the_cap():
    assert [p.key for p in registry.pool_programs(2048)] == registry.registered_keys("core")
    agg = f"fast_agg/b{bk.bucket_size(params.SYNC_COMMITTEE_SIZE)}"
    assert [p.key for p in registry.pool_programs(4)] == ["hashed/b4", agg, "each/b4"]
    assert params.SYNC_COMMITTEE_SIZE == jparams.SYNC_COMMITTEE_SIZE


def test_program_on_the_host_is_the_kernel_function():
    assert registry.program("hashed", 4, CPU) is dv.verify_signature_sets_hashed
    assert registry.program("each", 128, CPU) is dv.verify_each_hashed
    assert registry.program("fast_agg", 32, CPU) is dv.fast_aggregate_verify_hashed
    assert registry.program("batch", 4, CPU) is dv.verify_signature_sets
    assert registry.is_captured("hashed", 4, CPU)
    with pytest.raises(KeyError):
        registry.program("sharded", 4, CPU)
    # with a mesh size, one rank's program over a group of that size
    with pytest.raises(ValueError, match="needs 2 ranks, have 0"):
        registry.program("sharded", 4, CPU, mesh_size=2)


def test_warm_on_the_host_captures_nothing(monkeypatch):
    monkeypatch.setattr(registry, "program", lambda *a, **k: pytest.fail("program resolved"))
    rows = warm.warm_programs(registry.pool_programs(4), CPU)
    assert [(r["key"], r["status"]) for r in rows] == [
        (p.key, "eager") for p in registry.pool_programs(4)
    ]


# ---------------------------------------------------------------------------
# example_args against what the entries hand their programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_sets():
    out = []
    for i in range(2):
        sk = api.SecretKey(0xABCDEF + 17 * i)
        msg = bytes([i + 1]) * 32
        out.append(api.SignatureSet(sk.to_public_key(), msg, sk.sign(msg)))
    return out


def _signature(tree):
    leaves = []
    spec = graphs._flatten(tuple(tree), leaves)
    return spec, [(tuple(t.shape), t.dtype) for t in leaves]


@pytest.fixture
def recorded(monkeypatch):
    """``registry.program`` replaced by a recorder of (kernel, bucket, args)
    whose program answers like the real one's output shape."""
    calls = []

    def program(kernel, bucket, device=None):
        def run(*args):
            calls.append((kernel, bucket, args))
            return torch.ones(bucket, dtype=torch.bool) if kernel == "each" else torch.tensor(True)

        return run

    monkeypatch.setattr(registry, "program", program)
    return calls


@pytest.mark.parametrize("B", [4, 128])
def test_example_args_match_the_entries(two_sets, recorded, B):
    assert dv.execute_batch(dv.encode_job(two_sets, bucket=B, device=CPU)) is True
    assert dv.verify_each_device(two_sets, bucket=B, device=CPU) == [True, True]
    keys = [s.public_key for s in two_sets] * (B // 2)
    assert dv.fast_aggregate_verify_device(keys, b"m" * 32, two_sets[0].signature, device=CPU) is True
    assert [(k, b) for k, b, _ in recorded] == [("hashed", B), ("each", B), ("fast_agg", B)]
    for kernel, bucket, args in recorded:
        assert _signature(args) == _signature(registry.example_args(kernel, bucket, CPU)), kernel


def test_example_args_of_the_batch_kernel(two_sets):
    """A ``batch`` job comes from the JAX package's host encoder through
    ``convert.encoded_job_from_jax``."""
    from lodestar_tpu.crypto.bls import api as japi
    from lodestar_tpu.ops.bls12_381 import verify as jverify
    from lodestar_tpu_torch import convert

    jsets = [japi.SignatureSet(japi.PublicKey(s.public_key.point), s.message,
                               japi.Signature(s.signature.point)) for s in two_sets]
    job = convert.encoded_job_from_jax(jverify.encode_job(jsets, bucket=4), CPU)
    assert job.kind == "batch"
    assert _signature(job.args) == _signature(registry.example_args("batch", 4, CPU))
    with pytest.raises(KeyError):
        registry.example_args("sharded", 4, CPU)
    # with a mesh size: the batch kernel's tensors at one rank's width, in
    # the reference's order (active before bits)
    batch = registry.example_args("batch", 2, CPU)
    sharded = registry.example_args("sharded", 4, CPU, mesh_size=2)
    assert _signature(sharded[:6]) == _signature(batch[:6])
    assert _signature(sharded[6:]) == _signature((batch[7], batch[6]))


# ---------------------------------------------------------------------------
# the graphed program's static buffers, with a capture step on the CPU
# ---------------------------------------------------------------------------


def _cpu_capture(fn, args):
    """A capture step that runs on the CPU: the outputs of one run become
    the static outputs, and a replay writes a fresh run into them."""
    outputs = fn(*args)

    def replay():
        fresh = fn(*args)
        for static, new in zip(tw.leaves(outputs), tw.leaves(fresh)):
            static.copy_(new)

    return replay, outputs, {"nodes": 3, "instantiate_s": 0.25}


def _program(a, b):
    """A small program: an Fp2 product, a product of its parts, a flag.
    It counts one launch of K2 and two of K1 at n = 4, as the wrappers
    count on the card."""
    fpk.LAUNCHES["f2_mul"] += 1
    fpk.LAUNCHES["mont_mul"] += 2
    fpk.LAUNCH_SIZES["mont_mul"][4] = fpk.LAUNCH_SIZES["mont_mul"].get(4, 0) + 2
    c = tw.f2_mul(a, b)
    return c, fp.mont_mul(c[0], c[1]), fp.is_zero(c[0])


def _fp2(seed, n=4):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(0, 1 << 13, (n, 30), generator=g, dtype=torch.int32) for _ in range(2))


def _equal(x, y):
    return all(torch.equal(a, b) for a, b in zip(tw.leaves(x), tw.leaves(y)))


@pytest.fixture
def clean_counts():
    fpk.reset_launches()
    graphs.reset_replays()
    yield
    fpk.reset_launches()
    graphs.reset_replays()
    for key in [k for k in graphs.CAPTURED if k.startswith("test/")]:
        del graphs.CAPTURED[key], graphs.CAPTURED_SIZES[key]


def test_replays_follow_their_inputs_and_return_clones(clean_counts):
    prog = graphs.GraphedProgram("test/b4", _program, (_fp2(0), _fp2(1)), capture=_cpu_capture,
                                 warmup=False)
    assert (prog.nodes, prog.instantiate_s) == (3, 0.25)
    x, y = (_fp2(2), _fp2(3)), (_fp2(4), _fp2(5))
    first = prog(*x)
    want_first = _program(*x)
    second = prog(*y)
    assert _equal(first, want_first) and _equal(second, _program(*y))
    assert not _equal(first, second)
    assert _equal(first, want_first)  # the later call left the earlier result alone
    again = prog(*x)
    assert _equal(again, want_first)
    assert graphs.REPLAYS["test/b4"] == 3


def test_launches_while_capturing_are_kept_apart(clean_counts):
    prog = graphs.GraphedProgram("test/b4", _program, (_fp2(0), _fp2(1)), capture=_cpu_capture,
                                 warmup=True)
    # the eager warm-up ran the program: its launches count; the capture's do not
    assert fpk.LAUNCHES == {"mont_mul": 2, "f2_mul": 1, "f2_sqr": 0, "add_mod": 0, "sub_mod": 0}
    assert prog.launches == {"mont_mul": 2, "f2_mul": 1, "f2_sqr": 0, "add_mod": 0, "sub_mod": 0}
    assert graphs.CAPTURED_SIZES["test/b4"]["mont_mul"] == {4: 2}
    fpk.reset_launches()
    for _ in range(3):
        prog(_fp2(6), _fp2(7))
    fpk.reset_launches()  # the CPU capture step runs the program again on replay
    launches, sizes = graphs.replayed_launches()
    assert launches == {"mont_mul": 6, "f2_mul": 3, "f2_sqr": 0, "add_mod": 0, "sub_mod": 0}
    assert sizes["mont_mul"] == {4: 6}


@pytest.mark.parametrize("bad", ["shape", "broadcast", "dtype", "structure", "device"])
def test_mismatched_arguments_raise(clean_counts, bad):
    prog = graphs.GraphedProgram("test/b4", _program, (_fp2(0), _fp2(1)), capture=_cpu_capture,
                                 warmup=False)
    a, b = _fp2(2), _fp2(3)
    if bad == "shape":
        a = _fp2(2, n=5)
    elif bad == "broadcast":  # copy_ would broadcast a one-lane tensor silently
        a = (a[0][:1], a[1])
    elif bad == "dtype":
        a = (a[0].long(), a[1])
    elif bad == "structure":
        a = a[0]
    else:
        a = (a[0].to("meta"), a[1])
    with pytest.raises(ValueError):
        prog(a, b)
    assert graphs.REPLAYS.get("test/b4", 0) == 0


def test_a_failed_capture_raises_and_runs_nothing_eagerly(clean_counts):
    def failing(fn, args):
        fn(*args)
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.GraphedProgram("test/b4", _program, (_fp2(0), _fp2(1)), capture=failing, warmup=False)
    assert fpk.LAUNCHES == {"mont_mul": 0, "f2_mul": 0, "f2_sqr": 0, "add_mod": 0, "sub_mod": 0}
    assert "test/b4" not in graphs.CAPTURED
