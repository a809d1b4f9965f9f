"""The PyTorch port stands alone and never falls back quietly.

* No module of ``lodestar_tpu_torch``, and none of ``chip_smoke.py``,
  ``chip_ab.py`` and ``chip_warm.py``, imports JAX or anything of the JAX
  package: checked statically per file, and by importing every module in
  a subprocess where those imports fail.  The pool and ``chip_smoke.py``
  also import without ``prometheus_client``, which the card's machine
  lacks.
* An entry point called with ``device=None`` means the CUDA card; where
  none is available it raises instead of running on the CPU.  So does the
  sidecar's ``serve --verifier device``, which has no ``auto``.
* The sidecar (``lodestar_tpu_torch.blspool``) imports and serves with
  aiohttp and prometheus_client blocked, and runs as its own process.
* A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises: with no kernel library it raises and counts nothing.
"""
import ast
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading

import pytest
import torch

import lodestar_tpu_torch
from lodestar_tpu_torch import convert
from lodestar_tpu_torch.aot import registry, warm
from lodestar_tpu_torch.chain.bls.device_pool import DeviceBlsVerifier
from lodestar_tpu_torch.chain.bls.verifier import TorchBlsVerifier
from lodestar_tpu_torch.crypto.bls import api
from lodestar_tpu_torch.ops.bls12_381 import _build, curve as cv, fp_kernels as fpk
from lodestar_tpu_torch.ops.bls12_381 import h2c, sharded as sh, verify as dv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(lodestar_tpu_torch.__file__)))
PKG = os.path.join(REPO, "lodestar_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "lodestar_tpu")


def _port_files():
    out = [os.path.join(REPO, f"{name}.py") for name in ("chip_smoke", "chip_ab", "chip_warm")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_imports_in_source(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in ("jax", "jaxlib", "lodestar_tpu")):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in ("jax", "jaxlib", "lodestar_tpu"):
    sys.modules.pop(name, None)
import lodestar_tpu_torch
names = ["chip_smoke", "chip_ab", "chip_warm"] + [m.name for m in pkgutil.walk_packages(
    lodestar_tpu_torch.__path__, "lodestar_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lodestar_tpu")]
assert not loaded, loaded
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


# The card's machine has no prometheus_client: the pool and the chip
# script must import, and the pool run, without it.
_NO_PROMETHEUS = r"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".")
               for f in ("jax", "jaxlib", "lodestar_tpu", "prometheus_client")):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "lodestar_tpu", "prometheus_client"):
        sys.modules.pop(name)
importlib.import_module("chip_smoke")
dp = importlib.import_module("lodestar_tpu_torch.chain.bls.device_pool")
pool = dp.DeviceBlsVerifier(device="cpu")
assert pool._metrics is None
try:
    importlib.import_module("lodestar_tpu_torch.chain.bls.metrics")
except ImportError:
    print("metrics blocked")
"""


def test_pool_and_chip_script_import_without_prometheus():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PROMETHEUS],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "metrics blocked"


# ---------------------------------------------------------------------------
# device=None means the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_set():
    sk = api.SecretKey(0x1234567)
    msg = b"\x07" * 32
    return [api.SignatureSet(sk.to_public_key(), msg, sk.sign(msg))]


_ENTRY_POINTS = {
    "encode_job": lambda sets: dv.encode_job(sets),
    "verify_signature_sets_device": lambda sets: dv.verify_signature_sets_device(sets),
    "TorchBlsVerifier": lambda sets: TorchBlsVerifier(),
    "DeviceBlsVerifier": lambda sets: DeviceBlsVerifier(),
    "verify_each_device": lambda sets: dv.verify_each_device(sets),
    "fast_aggregate_verify_device": lambda sets: dv.fast_aggregate_verify_device(
        [sets[0].public_key], sets[0].message, sets[0].signature),
    "encode_g1_affine": lambda sets: cv.encode_g1_affine([sets[0].public_key.point]),
    "encode_g2_affine": lambda sets: cv.encode_g2_affine([sets[0].signature.point]),
    "scalars_to_bits": lambda sets: cv.scalars_to_bits([3]),
    "encode_field_draws": lambda sets: h2c.encode_field_draws([sets[0].message], 4),
    "limbs_from_jax": lambda sets: convert.limbs_from_jax([[1] * 30]),
    "registry.program": lambda sets: registry.program("hashed", 4),
    "registry.example_args": lambda sets: registry.example_args("hashed", 4),
    "warm_programs": lambda sets: warm.warm_programs(registry.pool_programs(4)),
    "verify_signature_sets_sharded": lambda sets: sh.verify_signature_sets_sharded(sets),
    "registry.program(sharded)": lambda sets: registry.program("sharded", 512, mesh_size=1),
    "registry.example_args(sharded)": lambda sets: registry.example_args("sharded", 512, mesh_size=4),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_device_none_without_a_card_raises(one_set, name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # no program runs on the CPU in place of the card's
    for kernel in ("hashed", "each", "fast_agg", "batch"):
        monkeypatch.setitem(registry._KERNELS, kernel, lambda *a: pytest.fail("a program ran"))
    monkeypatch.setattr(sh, "sharded_program", lambda group: pytest.fail("a program ran"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name](one_set)


def test_the_aot_package_is_checked():
    """The registry, its graphs and the warm step are among the files
    checked statically and imported with JAX blocked."""
    files = _port_files()
    for name in ("__init__", "graphs", "registry", "warm"):
        assert os.path.join("lodestar_tpu_torch", "aot", f"{name}.py") in files
    modules = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.replace("print(len(names))", "print(names)")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert modules.returncode == 0, modules.stderr
    for name in ("graphs", "registry", "warm"):
        assert f"lodestar_tpu_torch.aot.{name}" in modules.stdout


# ---------------------------------------------------------------------------
# the sidecar: standard library only, the card or an error, its own process
# ---------------------------------------------------------------------------


def _signed_set_hex(msg: bytes):
    """(pubkey, signature) hex of one set signed by the port's own API."""
    sk = api.SecretKey(0x5EED)
    return sk.to_public_key().to_bytes().hex(), sk.sign(msg).to_bytes().hex()


_SIDECAR_BLOCKED = r"""
import asyncio, http.client, importlib, sys, threading

BLOCKED = ("jax", "jaxlib", "lodestar_tpu", "aiohttp", "prometheus_client")

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in BLOCKED):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        sys.modules.pop(name)
importlib.import_module("lodestar_tpu_torch.blspool")
main = importlib.import_module("lodestar_tpu_torch.blspool.__main__")
assert main._optional_metrics("lodestar_tpu_torch.blspool.metrics", "BlsPoolSidecarMetrics") is None
from lodestar_tpu_torch.blspool import codec
from lodestar_tpu_torch.blspool.http import BlsPoolHttpServer
from lodestar_tpu_torch.blspool.server import BlsPoolServer
from lodestar_tpu_torch.chain.bls.device_pool import DeviceBlsVerifier
from lodestar_tpu_torch.crypto.bls import api

class Backend:
    def encode_job(self, sets, rand=None, bucket=None, device=None):
        return sets
    def execute_batch(self, sets):
        return True
    def verify_each_device(self, sets, bucket=None, device=None):
        return [True] * len(sets)

loop = asyncio.new_event_loop()
server = BlsPoolHttpServer(BlsPoolServer(DeviceBlsVerifier(_backend=Backend(), device="cpu")))
loop.run_until_complete(server.start("127.0.0.1", 0))
threading.Thread(target=loop.run_forever, daemon=True).start()
pk, sig = api.PublicKey.from_bytes(bytes.fromhex(PK)), api.Signature.from_bytes(bytes.fromhex(SIG))
body = codec.encode_request("iso", [api.SignatureSet(pk, MSG, sig)])
conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
conn.request("POST", "/verify", body=body, headers={"Content-Type": "application/json"})
resp = conn.getresponse()
answer = codec.decode_response(resp.read())
assert resp.status == 200 and answer["ok"] and answer["valid"], answer
assert answer["degradation_tier"] == "device", answer
asyncio.run_coroutine_threadsafe(server.close(), loop).result(60)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("served", answer["coalesced_width"])
"""


def test_the_sidecar_serves_without_aiohttp_or_prometheus():
    msg = b"\x07" * 32
    pk, sig = _signed_set_hex(msg)
    script = f"PK, SIG, MSG = {pk!r}, {sig!r}, {msg!r}\n" + _SIDECAR_BLOCKED
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "served 1"


def _serve(*args):
    return [sys.executable, "-m", "lodestar_tpu_torch.blspool", "serve", "--port", "0", *args]


def test_serve_on_the_card_without_one_raises():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(_serve("--verifier", "device"), cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""  # never announced
    assert "no CUDA device" in proc.stderr


def test_serve_has_no_auto_verifier():
    from lodestar_tpu_torch.blspool import __main__ as sidecar

    with pytest.raises(SystemExit) as exit_:
        sidecar.main(["serve", "--verifier", "auto"])
    assert exit_.value.code == 2


def test_serve_oracle_in_a_second_process():
    """``serve --verifier oracle`` as its own process behind TCP, reached by
    the JAX package's ``RemoteBlsVerifier`` over its aiohttp transport
    (as ``tests/test_blspool_process.py`` does for the JAX sidecar)."""
    import asyncio

    from lodestar_tpu.blspool import RemoteBlsVerifier
    from lodestar_tpu.blspool.http import HttpPoolTransport
    from lodestar_tpu.crypto.bls.api import SecretKey, SignatureSet

    proc = subprocess.Popen(_serve("--verifier", "oracle"), cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        announce = []
        reader = threading.Thread(target=lambda: announce.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(120)
        assert announce and announce[0], "the sidecar did not announce its port"
        url = json.loads(announce[0])["url"]
        sk = SecretKey.from_bytes(bytes([0] * 30 + [5, 1]))
        msg = b"\x42" * 32
        good = SignatureSet(sk.to_public_key(), msg, sk.sign(msg))
        bad = SignatureSet(good.public_key, b"\x43" * 32, good.signature)

        async def go():
            client = RemoteBlsVerifier(HttpPoolTransport(url, request_timeout=60.0), tenant="iso")
            try:
                out = []
                for s in (good, bad):
                    out.append((await client.verify_signature_sets([s]), client.last_stamp["degradation_tier"]))
                return out, client.local_fallbacks
            finally:
                await client.close()

        assert asyncio.run(go()) == ([(True, "host"), (False, "host")], 0)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    lines = [json.loads(line) for line in err.splitlines() if line.startswith("{")]
    assert lines[0]["verifier"] == "oracle" and lines[0]["warm_s"] >= 0
    served = lines[-1]["served"]
    assert served["batches"] == [[1, 1], [1, 1]] and served["decode"]["sets"] == 2


# ---------------------------------------------------------------------------
# kernel wrappers: the kernel or an exception, never the plain version
# ---------------------------------------------------------------------------


def _limbs(device, dtype=torch.int32, n=4, width=30):
    return torch.zeros(n, width, dtype=dtype, device=device)


_WRAPPERS = {
    "mont_mul": lambda d: fpk.mont_mul(_limbs(d), _limbs(d)),
    "f2_mul": lambda d: fpk.f2_mul((_limbs(d), _limbs(d)), (_limbs(d), _limbs(d))),
    "f2_sqr": lambda d: fpk.f2_sqr((_limbs(d), _limbs(d))),
}


def _no_toolkit():
    raise RuntimeError("nvcc not found")


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_non_cpu_tensor_without_library_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", _no_toolkit)
    before = dict(fpk.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        _WRAPPERS[name](torch.device("meta"))
    assert fpk.LAUNCHES == before
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_cpu_tensor_takes_plain_version_without_library(name, monkeypatch):
    def absent():
        raise AssertionError("a CPU tensor must not reach the kernel library")

    monkeypatch.setattr(_build, "library", absent)
    before = dict(fpk.LAUNCHES)
    out = _WRAPPERS[name](torch.device("cpu"))
    assert all(not t.any() for t in (out if isinstance(out, tuple) else (out,)))
    assert fpk.LAUNCHES == before


@pytest.mark.parametrize(
    "args,exc",
    [
        ((_limbs("cpu", torch.int64), _limbs("cpu")), TypeError),
        ((_limbs("cpu", width=29), _limbs("cpu", width=29)), ValueError),
        ((_limbs("cpu"), _limbs("meta")), ValueError),
    ],
)
def test_wrapper_checks_operands(args, exc):
    with pytest.raises(exc):
        fpk.mont_mul(*args)


# ---------------------------------------------------------------------------
# the chip scripts' bookkeeping: the kernels' bound and chip_ab.py's sides
# ---------------------------------------------------------------------------


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bound_counts_the_least_work():
    from lodestar_tpu_torch.crypto.bls.fields import P

    smoke = _script("chip_smoke")
    words = -(-P.bit_length() // 32)
    assert words == 12 and 390 - 32 * words == 6
    assert smoke.MULS_PER_PRODUCT == 2 * words * words
    assert smoke.MULS_PER_REDUCTION == words + 2 * words * words + 1 + 2 * words
    for name, (products, reductions, *_rest) in smoke.KERNELS.items():
        muls = products * smoke.MULS_PER_PRODUCT + reductions * smoke.MULS_PER_REDUCTION
        if products:
            assert muls < products * smoke.MADDS_13BIT_YARDSTICK
        else:  # the add and subtract kernels: no product, no reduction
            assert name in ("add_mod", "sub_mod") and muls == 0
        for n in (1, 512, 9234):
            us, by = smoke.bound_us(name, n)
            assert us <= smoke.yardstick_13bit_us(name, n)
            assert by == "bytes"


def test_chip_ab_sides_differ_only_in_the_kernel_source(tmp_path):
    ab = _script("chip_ab")
    ab_dir = tmp_path / "ab"
    assert ab.prepare(["a=tree", "b=tpi:4"], ab_dir=str(ab_dir)) == ["a", "b"]
    assert json.loads((ab_dir / "sides.json").read_text())["order"] == ["a", "b"]
    src = {s: (ab_dir / s / ab.KERNEL_SOURCE).read_text().splitlines() for s in "ab"}
    diff = [(x, y) for x, y in zip(src["a"], src["b"]) if x != y]
    assert len(src["a"]) == len(src["b"]) and len(diff) == 1
    assert "TPI = 8;" in diff[0][0] and "TPI = 4;" in diff[0][1]
    for side in "ab":
        assert (ab_dir / side / "chip_smoke.py").exists()
        assert not (ab_dir / side / "lodestar_tpu_torch" / "_build").exists()
    with pytest.raises(ValueError):
        ab.prepare(["c=tpi:x"], ab_dir=str(ab_dir))
    with pytest.raises(ValueError):
        ab.prepare(["tree"], ab_dir=str(ab_dir))


def test_chip_ab_reads_and_summarizes_chip_smoke_output():
    ab = _script("chip_ab")

    def output(us, busy, build):
        shapes = [{"n": n, "launches": 3, "device_us": us + n, "bound_us": 0.1}
                  for n in (1, 512)]
        lines = ["[build] ptxas info    : Compiling entry function "
                 "'_ZN4_GLOBAL__15mont_mul_kernelEPKiS1_Pil' for 'sm_90a'",
                 "[build] ptxas info    : Used 28 registers, used 0 barriers"] if build else []
        main = {"main_path": [{"median_s": 4.0, "profile": {
            "device_busy_s": busy, "hand_written": {"mont_mul": {"ms": 7.0}}}}],
            "launch_floor_us": 2.0, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
        return "\n".join(lines + [json.dumps(main),
                                  json.dumps({"kernels": [{"name": "mont_mul", "shapes": shapes}]}),
                                  '{"ok": true}'])

    runs = [("x", ab.read_run(output(3.0, 0.7, True))), ("y", ab.read_run(output(5.0, 0.8, True))),
            ("y", ab.read_run(output(5.5, 0.8, False))), ("x", ab.read_run(output(3.5, 0.7, False)))]
    summary = ab.summarize(["x", "y"], runs)
    assert summary["kernels"]["mont_mul"]["512"]["x"] == [515.0, 515.5]
    assert summary["kernels"]["mont_mul"]["1"]["y"] == [6.0, 6.5]
    assert summary["sides"]["x"]["registers"] == {"mont_mul": 28}
    assert summary["sides"]["y"]["card_busy_s"] == [0.8, 0.8]
    assert summary["card"] == ["NVIDIA H100 80GB HBM3, 700.00 W"]
    with pytest.raises(ValueError):
        ab.read_run("no result")
