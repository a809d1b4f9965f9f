#!/usr/bin/env python3
"""Drive the PyTorch/CUDA BLS verifier on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed N] [--widths 512,128] [--repeats 3]

Phases, one line each (any failure raises and exits non-zero):

1. Device: torch and CUDA versions, the card's name and power limit.
2. Build: compile the hand-written kernels from ``csrc/fp_kernels.cu``
   (``-Xptxas -v``: registers and spills per kernel).  K1-K3 share one
   design: eight lanes of a warp per element on 26-bit digits, CIOS with
   lazy 64-bit accumulators; K3 runs its two products, (a0+a1)(a0+(p-a1))
   and a0 (2 a1), side by side, one reduction each.  The canonical add
   and subtract (``add_mod``, ``sub_mod``) are kernels on the same lanes,
   digits and carry chains, with no product.
3. Kernels: K1-K3, add and subtract on seeded inputs at ``CHECK_SIZES``
   elements (the edge values 0, 1, 2, p-1, p-2, (p-1)/2 in every pairing
   where n >= 36), on broadcast operands with leading axes and (K1, add,
   subtract) against one (30,) constant, held bit for bit against their
   plain PyTorch versions on the same CUDA tensors.
4. The main path at each width (``--repeats`` timed runs at the first,
   one at the others): sets made from ``--seed`` with the port's
   own signing (distinct keys; 64 messages at 512 sets, 8 signers each)
   go through ``TorchBlsVerifier.verify_signature_sets``, each run one
   replay of the ``hashed`` program's CUDA graph, captured in phase 8a,
   which runs first.
   The valid batch must pass, a batch with another set's signature at one
   lane and a batch with one set signed by the wrong key must fail, and
   every kernel must have launched during the valid verify: the launch
   counts of a run are the wrappers' own (eager launches) plus, for each
   program replayed, its replays times the launches its graph holds; they
   also give each kernel's launches by element count n.  Before the
   replays, one eager run of the same program at the first width, split at
   its phase boundaries and timed with CUDA events, is the comparison for
   them (phase 8b).
5. Kernel times at every n of the first width's valid verify (a 512-set
   verify launches K1, K2 and K3 at 9, 46 and 13 distinct n): at each n
   the kernel is held against its plain version again, then timed two
   ways.  Device us per launch: 200 raw launches through the C launcher,
   back to back between two CUDA events, over the count.  Host us per
   call: the host clock around 200 calls of the Python wrapper, over the
   count.  Beside them the bound (the least time the card could take, from
   the least multiplies known for the work; the looser 13-bit yardstick
   is printed beside it), at the kernel's primary n the plain version's time,
   and the launch floor: a one-element torch add timed the same way.
6. Profile: one replay of the first width's job under torch.profiler (the
   host encode outside it), for the card's busy share, the kernels that
   take the most time and the time of each hand-written kernel.
7. Paths: the other entry points, each with the launch and replay counts
   reset just before it and read just after (every kernel must have
   launched).
   7a ``verify_each_device`` on the first width's sets: all True; a swapped
   signature (first set) and two wrong-key signatures (middle, last) give
   exactly those three False, as the host oracle says; a job 12 sets short
   of the bucket gives one verdict a set; median of ``--repeats`` runs.
   7b ``fast_aggregate_verify_device`` of one message under ``AGG_KEYS``
   keys made from the seed: the aggregate signature accepts, a wrong
   message and one key short reject, as the host oracle says.
   7c ``DeviceBlsVerifier`` on one pool, the degradation record reset
   before each scenario: four batchable requests with one wrong-key set
   coalesce into one job of the governed width, split by ``verify_each``
   at tier ``device``, served by replays whose graphs hold launches of
   K1, K2 and K3; two faults armed on ``bls.device.execute`` end at
   ``per_set``; every device point armed raises ``DeviceFaultError`` to
   both waiters with no launch (the card has no host tier);
   ``verify_on_main_thread`` is answered on the host with no launch.
   7d every kernel against its plain version (max |diff| 0) and timed at
   the largest n of 7a and 7b and at each n they launch ten times or more that
   phase 5 did not time.
8. Graphs.
   8a Warm: every program the pool warms (``registry.pool_programs``),
   and the aggregate programs 7b and 8c need besides, captured first, as
   a fresh node would (it runs before phase 4's eager run); one row per
   program: eager warm-up, capture and instantiate seconds, the graph's
   nodes, the launches of each kernel it holds, the growth of host RSS
   and of the card's reserved memory, and the constants the warm-up made.
   8b Phases bit for bit: each phase of the first width's eager run
   (h2c points, scalar muls, affine, Miller product, final
   exponentiation) captured as its own graph and replayed on the same
   inputs; every output tensor must equal the eager run's (``torch.equal``).
   8c Verdicts from replays at each of ``--graph-widths``: the valid batch
   passes, the swapped and wrong-key batches fail, ``verify_each`` gives
   the expected verdicts and the host oracle's on its corrupted lanes, and
   the aggregate accepts while its two corruptions reject.  Widths above
   the signed sets tile them (signing more in pure Python costs minutes).
   8d Replay medians: ``--replays`` jobs at each width, the host encode
   timed apart from the replay; the pool's latency model is fitted to the
   replay medians (``governor_fit``).
9. The sidecar on the card, run after phase 3 and before 8a, while this
   process has captured nothing: ``python -m lodestar_tpu_torch.blspool
   serve --port 0 --verifier device`` starts as a second process (while
   this one signs the sets), warms the pool's programs and announces its
   port; then, over the port's standard-library HTTP transport, the
   signed sets: (a) ``GET /healthz``; (b) one tenant, 128 valid sets:
   valid, stamped ``device``, coalesced width 128; (c) four tenants at
   once, 32 sets each: one batch of 128 from 4 tenants, all valid; (d)
   the same with one wrong-key set in one tenant's request: that tenant
   invalid, the other three valid, all stamped ``device``; (e) one
   tenant, 512 sets, which the pool runs as jobs of its governed width:
   valid; (f) a garbage body: a served ``bad_request`` (HTTP 200).
   SIGTERM then stops the server, which must exit 0 and report what it
   served: its batches, graph replays (every one at the governed width)
   and decode time, and its peak host RSS.
10. The sharded program (``ops/bls12_381/sharded.py``), after phase 9
   and before 8a, in an NCCL world of one rank (this process, rank 0, met
   through a ``FileStore``; the card's machine has one card, and NCCL
   takes one rank per card), destroyed at the phase's end.  The 512
   signed sets and the same with the set at 170 signed by the wrong key,
   one seeded coefficient a set:
   10a the host entry's steps eagerly (``encode_shard``: 64 messages, each
   hashed once on the host; the memoized program over the group): valid
   True, wrong key False, each as the ``hashed`` program's verdict (run
   eagerly) on the same sets; the counts read the valid run;
   10b ``registry.program("sharded", 512, dev, mesh_size=1)`` captured
   (a ``[graphs 10b]`` row as 8a's), verdicts through
   ``verify_signature_sets_sharded`` from two replays, and ``--replays``
   replays with the host encode timed apart;
   10c the 4-way split on the one card: ``local_partials`` on each
   128-set share, the four stacked, then the combine: the verdict is
   10a's, and the signature sum's affine limbs and the Fp12 value before
   the final exponentiation equal the unsharded program's bit for bit;
   10d every kernel against its plain version, and timed, at the largest
   n of 10a and 10c and at each n they launch ten times or more that phase 5
   did not time (as 7d).

The JSON lines come last: the sharded program, the sidecar, the graphs,
the paths, the main path, the kernels' numbers (the line before the
last), then
``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM rates: HBM bandwidth (NVIDIA data sheet) and 32-bit integer
# multiply-adds, 64 per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic throughput table) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_MADD_PER_S = 64 * 132 * 1.98e9
# The least 32-bit multiplies known for the work, one issue slot each, low
# and high halves counted apart, on 12 words of 32 bits: a full product a*b
# takes 144 + 144; a reduction to x*2^-390 takes 12 digits m and 144 + 144
# for m*p (x*2^-384), then one 6-bit step (its digit, and 12 + 12 for the
# product by p).
MULS_PER_PRODUCT = 2 * 144
MULS_PER_REDUCTION = 12 + 2 * 144 + 1 + 2 * 12
# The first port's yardstick, printed beside the bound so that tables
# made with it read against the same number: 30 x (30 + 1 + 30)
# multiply-adds of a CIOS product on 13-bit digits.
MADDS_13BIT_YARDSTICK = 30 * 61
LIMB_BYTES = 30 * 4

KERNELS = {
    # name: (full products, reductions, inputs, outputs, pallas_call line).
    # K2 at its least: Karatsuba's three products, summed into the two
    # coefficients before one reduction each; K3: (a0+a1)(a0-a1) and a0 a1.
    "mont_mul": (1, 1, 2, 1, "lodestar_tpu/ops/bls12_381/pallas_fp.py:197"),
    "f2_mul": (3, 2, 4, 2, "lodestar_tpu/ops/bls12_381/pallas_fp.py:274"),
    "f2_sqr": (2, 2, 2, 2, "lodestar_tpu/ops/bls12_381/pallas_fp.py:299"),
    # no Pallas kernel: the reference's add and sub, one XLA fusion each
    "add_mod": (0, 0, 2, 1, "lodestar_tpu/ops/bls12_381/fp.py:227"),
    "sub_mod": (0, 0, 2, 1, "lodestar_tpu/ops/bls12_381/fp.py:236"),
}
SOURCE = "lodestar_tpu_torch/ops/bls12_381/csrc/fp_kernels.cu"

# raw launches per device timing, and wrapper calls per host timing
TIMED_LAUNCHES = 200
# n checked against the plain versions before the main path runs: 1, the
# final exponentiation's 12 and 18, the Miller loop's 512 + 1 pairs, a ~1k
# and a ragged n, and 18 x 513 (one Fp12 product per pair)
CHECK_SIZES = (1, 12, 18, 513, 1024, 1061, 9234)
# 7b's keys: BASELINE config 2, one message under 2048 aggregated pubkeys
# (the sync committee's shape)
AGG_KEYS = 2048
# 8c and 8d: the pool's widths (buckets.POOL_BUCKETS), and the replays
# timed at each
GRAPH_WIDTHS = "128,512,1024,2048"
REPLAYS_PER_WIDTH = 10
# phase 9: the longest wait for the sidecar's announce (it warms first),
# and for it to exit after SIGTERM
SIDECAR_ANNOUNCE_S = 300
SIDECAR_EXIT_S = 120
# phase 10: the sharded program's width (64 messages, each hashed once on
# the host), the split held against it on the one card (4 shards of 128),
# and the NCCL group's timeout
SHARDED_WIDTH = 512
SHARDED_SPLIT = 4
SHARDED_GROUP_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, repeats: int) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` runs, CUDA events
    around each run: for the plain versions, whose many small launches are
    paced by the host."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(torch, launch, count: int = TIMED_LAUNCHES) -> float:
    """Microseconds on the card per launch: ``count`` raw launches back to
    back between two CUDA events, over the count.  A sleep kernel ahead of
    the first event holds the card while the host queues every launch, so
    the interval is the card's work and not the host's pace; if the first
    event has already run when the host is done queuing, the sleep was too
    short and the measurement is taken again with a longer one."""
    for _ in range(10):
        launch()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(count):
            launch()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) * 1e3 / count
        cycles *= 4
    raise AssertionError("the host could not queue the launches ahead of the card")


def host_us_per_call(torch, call, count: int = TIMED_LAUNCHES) -> float:
    """Microseconds of host time per wrapper call: host clock around
    ``count`` calls (operand checks, copies, allocation, the ctypes launch),
    then a synchronise outside the interval."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        call()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e6 / count


def bound_us(name: str, n: int):
    """The least time the card could take for ``n`` elements of a kernel:
    bytes over HBM bandwidth against 32-bit multiplies over the integer
    rate.  Returns (us, "bytes" or "operations")."""
    products, reductions, n_in, n_out, _ = KERNELS[name]
    t_bytes = (n_in + n_out) * n * LIMB_BYTES / HBM_BYTES_PER_S
    muls = products * MULS_PER_PRODUCT + reductions * MULS_PER_REDUCTION
    t_ops = muls * n / INT32_MADD_PER_S
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def yardstick_13bit_us(name: str, n: int) -> float:
    """The first port's bound: bytes against 1,830 multiply-adds a product."""
    products, _, n_in, n_out, _ = KERNELS[name]
    t_bytes = (n_in + n_out) * n * LIMB_BYTES / HBM_BYTES_PER_S
    t_ops = products * MADDS_13BIT_YARDSTICK * n / INT32_MADD_PER_S
    return max(t_bytes, t_ops) * 1e6


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(torch, rng, n: int, n_args: int, dev):
    """``n_args`` (n, 30) int32 tensors of canonical values made from
    ``rng``; when n >= 36 the last 36 rows hold every pairing of the edge
    values 0, 1, 2, p-1, p-2, (p-1)/2 in the first two arguments."""
    from lodestar_tpu_torch.crypto.bls.fields import P
    from lodestar_tpu_torch.ops.bls12_381 import curve as cv

    edges = [0, 1, 2, P - 1, P - 2, (P - 1) // 2]
    n_edge = 36 if n >= 36 else 0
    cols = []
    for k in range(n_args):
        vals = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n - n_edge)]
        if n_edge:
            for i, x in enumerate(edges):
                for j, y in enumerate(edges):
                    vals.append((x, y, edges[(i + j) % 6], edges[(i + 2 * j) % 6])[k])
        cols.append(torch.from_numpy(cv.ints_to_limbs_np(vals).astype(np.int32)).to(dev))
    return cols


def kernel_pair(torch, fpk, name: str, xs):
    """(wrapper call, plain call) of kernel ``name`` on the tensors ``xs``.
    The plain K1 takes operands of one shape, as the wrapper hands them on."""
    if name == "mont_mul":
        return (lambda: fpk.mont_mul(xs[0], xs[1]),
                lambda: fpk.mont_mul_plain(*torch.broadcast_tensors(xs[0], xs[1])))
    if name == "f2_mul":
        return (lambda: fpk.f2_mul((xs[0], xs[1]), (xs[2], xs[3])),
                lambda: fpk.f2_mul_plain((xs[0], xs[1]), (xs[2], xs[3])))
    if name in ("add_mod", "sub_mod"):
        return (lambda: getattr(fpk, name)(xs[0], xs[1]),
                lambda: getattr(fpk, f"{name}_plain")(xs[0], xs[1]))
    return (lambda: fpk.f2_sqr((xs[0], xs[1])),
            lambda: fpk.f2_sqr_plain((xs[0], xs[1])))


def check_equal(torch, name: str, kernel, plain, what: str) -> int:
    """Run both on the card; raise unless they agree limb for limb."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if err != 0 or not all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} at {what}: kernel differs from its plain version "
                             f"(max |diff| {err})")
    return err


def check_kernels(torch, rng, dev):
    """Every kernel against its plain version at CHECK_SIZES and on
    broadcast operands with leading axes."""
    from lodestar_tpu_torch.ops.bls12_381 import fp_kernels as fpk

    for name, (_, _, n_in, _, _) in KERNELS.items():
        for n in CHECK_SIZES:
            xs = kernel_inputs(torch, rng, n, n_in, dev)
            check_equal(torch, name, *kernel_pair(torch, fpk, name, xs), f"n={n}")
        # broadcast: (3, 1, 30) against (1, 5, 30) and (5, 30) operands
        big = kernel_inputs(torch, rng, 15, n_in, dev)
        xs = [x[:3].reshape(3, 1, 30) if k % 2 == 0 else x[3:8].reshape(1, 5, 30)
              for k, x in enumerate(big)]
        if n_in == 4:
            xs[3] = xs[3].reshape(5, 30)
        check_equal(torch, name, *kernel_pair(torch, fpk, name, xs), "broadcast (3, 5)")
        if name in ("mont_mul", "add_mod", "sub_mod"):
            # one (30,) constant on either side, as p, r2 or a zero is passed
            for xs in ([big[0][:6], big[1][8]], [big[1][8], big[0][:6]]):
                check_equal(torch, name, *kernel_pair(torch, fpk, name, xs), "constant (30,)")
        log(f"[kernels] {name}: equal to plain at n = "
            f"{', '.join(map(str, CHECK_SIZES))} and broadcast (3, 5)")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def make_sets(rng, n_sets: int, signers_per_msg: int):
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.crypto.bls.curve import g2
    from lodestar_tpu_torch.crypto.bls.fields import R
    from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2_affine

    sks = []
    while len(sks) < n_sets:
        v = int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1
        if v not in sks:
            sks.append(v)
    msgs = [rng.bytes(32) for _ in range(n_sets // signers_per_msg)]
    points = [g2.from_affine(hash_to_g2_affine(m)) for m in msgs]
    sets = []
    for i, v in enumerate(sks):
        sk = api.SecretKey(v)
        h = points[i // signers_per_msg]
        sig = api.Signature(g2.to_affine(g2.mul_scalar(h, v)))
        sets.append(api.SignatureSet(sk.to_public_key(), msgs[i // signers_per_msg], sig))
    wrong_key = api.SecretKey(int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1)
    return sets, wrong_key


def reset_counts():
    """Zero the wrappers' launch counts and the programs' replay counts."""
    from lodestar_tpu_torch.aot import graphs
    from lodestar_tpu_torch.ops.bls12_381 import fp_kernels as fpk

    fpk.reset_launches()
    graphs.reset_replays()


def run_counts():
    """The kernel launches since ``reset_counts``: the wrappers' own counts
    (eager launches) plus, for each program replayed, its replays
    times the launches its graph holds.  Returns (launches, launches by
    element count n, replays by program)."""
    from lodestar_tpu_torch.aot import graphs
    from lodestar_tpu_torch.ops.bls12_381 import fp_kernels as fpk

    launches, sizes = graphs.replayed_launches()
    for name, count in fpk.LAUNCHES.items():
        launches[name] += count
        for n, c in fpk.LAUNCH_SIZES[name].items():
            sizes[name][n] = sizes[name].get(n, 0) + c
    return launches, {k: dict(sorted(v.items())) for k, v in sizes.items()}, dict(graphs.REPLAYS)


def eager_phases(torch, sets, dev):
    """One eager run of the hashed program (its functions called directly,
    not through the registry), split at its phases and timed with CUDA
    events: the comparison for the replays.  Returns (verdict, {phase: ms},
    host seconds of the run, [(phase, function, arguments, outputs)])."""
    from lodestar_tpu_torch.ops.bls12_381 import buckets as bk, pairing as pr, tower as tw
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    job = dv.encode_job(sets, bucket=bk.pool_bucket(len(sets)), device=dev)
    pk_aff, pk_inf, u0, u1, sig_aff, sig_inf, bits, active = job.args
    steps = []

    def step(name, fn, *args):
        out = fn(*args)
        steps.append((name, fn, args, out))
        return out

    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    msg_aff, msg_inf = step("h2c", dv.points_from_draws, u0, u1)
    events[1].record()
    rpk, sig_sum = step("scalar_muls", dv.scalar_mul_phase, pk_aff, pk_inf, sig_aff, sig_inf, bits, active)
    events[2].record()
    rpk_aff, rpk_inf, ss_aff, ss_inf = step("affine", dv.affine_phase, rpk, sig_sum)
    events[3].record()
    f = step("miller", dv.miller_phase, msg_aff, msg_inf, active, rpk_aff, rpk_inf, ss_aff, ss_inf)
    events[4].record()
    ok = tw.f12_is_one(step("final_exp", pr.final_exponentiation, f))
    events[5].record()
    events[5].synchronize()
    total_s = time.perf_counter() - t0
    names = [name for name, *_ in steps]
    times = {n: events[i].elapsed_time(events[i + 1]) for i, n in enumerate(names)}
    return bool(ok), times, total_s, steps


def run_width(torch, all_sets, wrong_key, width: int, repeats: int, dev):
    """The main path at ``width`` sets through ``TorchBlsVerifier``: each
    verify is one replay of the ``hashed`` program at the pool's bucket."""
    from lodestar_tpu_torch.chain.bls.verifier import TorchBlsVerifier
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.ops.bls12_381 import buckets as bk

    sets = all_sets[:width]
    verifier = TorchBlsVerifier(device=dev)

    async def verify(batch):
        return await verifier.verify_signature_sets(batch)

    # the valid batch: the counts read this one run
    reset_counts()
    t0 = time.perf_counter()
    ok = asyncio.run(verify(sets))
    first_s = time.perf_counter() - t0
    launches, launch_sizes, replays = run_counts()
    if ok is not True:
        raise AssertionError(f"valid {width}-set batch rejected")
    if replays != {f"hashed/b{bk.pool_bucket(width)}": 1}:
        raise AssertionError(f"the {width}-set verify was not one replay of its program: {replays}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    times = [first_s]
    for _ in range(repeats - 1):
        t0 = time.perf_counter()
        if asyncio.run(verify(sets)) is not True:
            raise AssertionError(f"valid {width}-set batch rejected on a repeat")
        times.append(time.perf_counter() - t0)

    lane = 300 if width > 300 else width - 28
    swapped = list(sets)
    other = sets[lane + 1]
    swapped[lane] = api.SignatureSet(sets[lane].public_key, sets[lane].message, other.signature)
    if asyncio.run(verify(swapped)) is not False:
        raise AssertionError(f"batch with another set's signature at lane {lane} accepted")
    wrong = list(sets)
    j = width // 3
    wrong[j] = api.SignatureSet(sets[j].public_key, sets[j].message, wrong_key.sign(sets[j].message))
    if asyncio.run(verify(wrong)) is not False:
        raise AssertionError(f"batch with lane {j} signed by the wrong key accepted")

    med = statistics.median(times)
    log(f"[main {width}] valid batch accepted; lane {lane} swapped signature "
        f"and lane {j} wrong key rejected, each verify one replay")
    log(f"[main {width}] verify median {med:.3f} s over {len(times)} runs "
        f"(first {first_s:.3f} s), {width / med:.1f} sets/s")
    log(f"[main {width}] launches in one verify: {json.dumps(launches)}")
    for name, hist in launch_sizes.items():
        log(f"[main {width}] {name} launches by elements n: {json.dumps(hist)}")
    return {"width": width, "median_s": med, "runs_s": times, "replays": replays,
            "launches": launches, "launch_sizes": launch_sizes}


# ---------------------------------------------------------------------------
# phase 5: kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def raw_launch(lib, name: str, xs, outs, n: int, stream: int):
    """One launch of kernel ``name`` through the C launcher, no wrapper."""
    fn = getattr(lib, f"lodestar_fp_{name}")
    ptrs = [t.data_ptr() for t in (*xs, *outs)]

    def launch():
        rc = fn(*ptrs, n, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed with cudaError {rc}")

    return launch


def time_kernels(torch, rng, dev, sizes, launches):
    """Each kernel at each timed shape: equal to its plain version, device
    us per raw launch, host us per wrapper call and the bound; the plain
    version's time at the kernel's primary shape, the one where the main
    path spends the most of this kernel's device time.  ``sizes`` is the
    launch-size histogram of the main path's run.  Returns the rows and the
    launch floor: the
    device time per launch of a one-element torch add, the least any
    launch takes."""
    from lodestar_tpu_torch.ops.bls12_381 import _build, fp_kernels as fpk

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    one, out = torch.ones(1, dtype=torch.int32, device=dev), torch.empty(1, dtype=torch.int32, device=dev)
    floor_us = device_us(torch, lambda: torch.add(one, 1, out=out))
    log(f"[timing] launch floor: {floor_us:.2f} us on the card per launch of a one-element torch add")
    rows = {}
    for name, (_, _, n_in, n_out, replaces) in KERNELS.items():
        hist = sizes[name]
        ns = sorted(hist)
        full = kernel_inputs(torch, rng, max(ns), n_in, dev)
        shapes, err = [], 0
        for n in ns:
            xs = [x[-n:].contiguous() for x in full]
            kernel, plain = kernel_pair(torch, fpk, name, xs)
            err = max(err, check_equal(torch, name, kernel, plain, f"timed n={n}"))
            outs = [torch.empty_like(xs[0]) for _ in range(n_out)]
            b_us, _ = bound_us(name, n)
            shapes.append({
                "n": n,
                "launches": hist.get(n, 0),
                "device_us": device_us(torch, raw_launch(lib, name, xs, outs, n, stream)),
                "host_us_per_call": host_us_per_call(torch, kernel),
                "bound_us": b_us,
                "bound_us_13bit_yardstick": yardstick_13bit_us(name, n),
            })
        primary = max(shapes, key=lambda s: (s["launches"] * s["device_us"], s["n"]))
        xs = [x[-primary["n"]:].contiguous() for x in full]
        plain_ms = cuda_ms(torch, kernel_pair(torch, fpk, name, xs)[1], 5)
        b_us, bound_by = bound_us(name, primary["n"])
        per_verify = sum(s["launches"] * s["device_us"] for s in shapes) / 1e3
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": err,
            "ms": primary["device_us"] / 1e3,
            "plain_ms": plain_ms,
            "bound_ms": b_us / 1e3,
            "bound_by": bound_by,
            "bound_ms_13bit_yardstick": yardstick_13bit_us(name, primary["n"]) / 1e3,
            "library_ms": None,
            "n": primary["n"],
            "device_us": primary["device_us"],
            "host_us_per_call": primary["host_us_per_call"],
            "device_ms_per_verify": per_verify,
            "shapes": shapes,
        }
        for s in shapes:
            log(f"[timing] {name} n={s['n']:>6}: {s['device_us']:9.2f} us on the card per launch, "
                f"{s['host_us_per_call']:8.2f} us host per call, bound {s['bound_us']:.3f} us "
                f"(13-bit yardstick {s['bound_us_13bit_yardstick']:.3f} us), "
                f"{s['launches']} launches per verify")
        log(f"[timing] {name}: primary n={primary['n']} ({primary['device_us']:.2f} us, "
            f"{primary['device_us'] / b_us:.1f}x its bound by {bound_by}), plain {plain_ms:.3f} ms, "
            f"{per_verify:.2f} ms on the card per verify (launches x device us)")
    return rows, floor_us


# ---------------------------------------------------------------------------
# phase 6: profile
# ---------------------------------------------------------------------------


def device_profile(torch, sets, dev, median_s: float):
    """One replay of the ``hashed`` program under torch.profiler (the host
    encode before it, outside): kernel time on the card against the wall
    time of that replay and the unprofiled median, and the kernels that
    take the most."""
    from torch.profiler import ProfilerActivity, profile

    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    job = dv.encode_job(sets, bucket=len(sets), device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = dv.execute_batch(job)
        wall_s = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError("valid batch rejected under the profiler")
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not kernels:
        log(f"[profile {len(sets)}] the profiler recorded no kernel on the card: "
            "busy share not measured")
        return {"wall_s": wall_s, "device_busy_s": None, "kernel_launches": None}
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile {len(sets)}] one replay: kernels on the card {busy_s:.3f} s over {n_launch} "
        f"launches, {100 * busy_s / wall_s:.1f} % of the profiled replay ({wall_s:.3f} s), "
        f"{100 * busy_s / median_s:.1f} % of the unprofiled verify median ({median_s:.3f} s)")
    for e in top:
        log(f"[profile {len(sets)}]   {e.self_device_time_total / 1e3:9.1f} ms "
            f"{e.count:7d} x {e.key[:90]}")
    ours = {}
    for name in KERNELS:
        evs = [e for e in kernels if f"{name}_kernel" in e.key]
        ours[name] = {"ms": sum(e.self_device_time_total for e in evs) / 1e3,
                      "launches": sum(e.count for e in evs)}
        log(f"[profile {len(sets)}]   {name}: {ours[name]['ms']:.1f} ms on the card over "
            f"{ours[name]['launches']} launches")
    return {"wall_s": wall_s, "device_busy_s": busy_s, "kernel_launches": n_launch,
            "hand_written": ours}


def reference_check(torch, sets, dev):
    """Device hash-to-G2 of two messages against the host oracle."""
    from lodestar_tpu_torch.crypto.bls.curve import g2
    from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
    from lodestar_tpu_torch.ops.bls12_381 import h2c, tower as tw
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    msgs = [sets[0].message, sets[-1].message]
    u0, u1 = h2c.encode_field_draws(msgs, 2, dev)
    (x, y), inf = dv.points_from_draws(u0, u1)
    for i, m in enumerate(msgs):
        got = (tw.decode_fp2((x[0][i], x[1][i])), tw.decode_fp2((y[0][i], y[1][i])))
        if bool(inf[i]) or got != g2.to_affine(hash_to_g2(m)):
            raise AssertionError("device hash_to_g2 differs from the host oracle")


# ---------------------------------------------------------------------------
# phase 7: the other paths (per-set, aggregate, the pool with its ladder)
# ---------------------------------------------------------------------------


def path_launches(what: str):
    """The counts of one path's run (reset just before it); fails unless
    every kernel launched."""
    launches, sizes, replays = run_counts()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")
    return {"launches": launches, "launch_sizes": sizes, "replays": replays,
            "largest_n": {k: max(v) for k, v in sizes.items()}}


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_each(sets, wrong_key, repeats: int, dev):
    """7a: ``verify_each_device`` at the full width: every valid set True;
    three corrupted sets (first, middle, last) exactly False, as the host
    oracle says; a 500-set job in the same bucket gives 500 verdicts."""
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    width = len(sets)
    reset_counts()
    out, first_s = timed(lambda: dv.verify_each_device(sets, device=dev))
    counts = path_launches("verify_each")
    if out != [True] * width:
        raise AssertionError(f"verify_each rejected valid sets at {[i for i, v in enumerate(out) if not v]}")
    times = [first_s]
    for _ in range(repeats - 1):
        out, t = timed(lambda: dv.verify_each_device(sets, device=dev))
        if out != [True] * width:
            raise AssertionError("verify_each rejected a valid set on a repeat")
        times.append(t)

    bad = [0, width // 2, width - 1]
    corrupt = list(sets)
    corrupt[bad[0]] = api.SignatureSet(sets[0].public_key, sets[0].message, sets[1].signature)
    for j in bad[1:]:
        corrupt[j] = api.SignatureSet(sets[j].public_key, sets[j].message,
                                      wrong_key.sign(sets[j].message))
    got = dv.verify_each_device(corrupt, device=dev)
    want = [i not in bad for i in range(width)]
    if got != want:
        raise AssertionError(f"verify_each verdicts wrong at {[i for i in range(width) if got[i] != want[i]]}")
    probes = bad + [1, width // 2 + 1, width - 2]
    oracle = [api.verify_signature_set(corrupt[i]) for i in probes]
    if oracle != [got[i] for i in probes]:
        raise AssertionError(f"verify_each differs from the host oracle at {probes}: {oracle}")
    n_part = width - max(1, width // 40)  # 500 of 512: padding lanes in the bucket
    part = dv.verify_each_device(sets[:n_part], bucket=width, device=dev)
    if part != [True] * n_part:
        raise AssertionError(f"verify_each on {n_part} sets in bucket {width}: {part}")
    med = statistics.median(times)
    log(f"[paths 7a] verify_each_device at {width}: all valid sets True; sets {bad} "
        f"(swapped, wrong key, wrong key) exactly False, as the host oracle says on "
        f"sets {probes}; {n_part} sets in bucket {width} give {n_part} verdicts")
    log(f"[paths 7a] median {med:.3f} s over {len(times)} runs ({', '.join(f'{t:.3f}' for t in times)})")
    log(f"[paths 7a] launches {json.dumps(counts['launches'])}, largest n {json.dumps(counts['largest_n'])}")
    return {"width": width, "median_s": med, "runs_s": times, "corrupted": bad,
            "oracle_checked": probes, "partial": [n_part, width], **counts}


def make_aggregate(rng, n_keys: int):
    """``n_keys`` consecutive public keys from a seeded base (pk_{i+1} =
    pk_i + G1, one addition a key instead of a scalar multiplication), one
    message and another; ``signature(n)`` is the aggregate signature of the
    first n keys on the message, (sum of their secret keys) H(message)."""
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.crypto.bls.curve import G1_GEN_JAC, g1, g2
    from lodestar_tpu_torch.crypto.bls.fields import R
    from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2_affine

    base = int.from_bytes(rng.bytes(32), "big") % (R - n_keys - 1) + 1
    pk, pks = g1.mul_scalar(G1_GEN_JAC, base), []
    for _ in range(n_keys):
        pks.append(api.PublicKey(g1.to_affine(pk)))
        pk = g1.add_pts(pk, G1_GEN_JAC)
    msg, other = rng.bytes(32), rng.bytes(32)
    h = g2.from_affine(hash_to_g2_affine(msg))

    def signature(n: int):
        sk_sum = (n * base + n * (n - 1) // 2) % R
        return api.Signature(g2.to_affine(g2.mul_scalar(h, sk_sum)))

    return {"pks": pks, "msg": msg, "other": other, "signature": signature}


def run_fast_aggregate(agg, repeats: int, dev):
    """7b: ``fast_aggregate_verify_device`` of one message under all of
    ``agg``'s keys: the aggregate signature accepts, a wrong message and
    one key short reject, as the host oracle says."""
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    pks, msg, other = agg["pks"], agg["msg"], agg["other"]
    n_keys = len(pks)
    t0 = time.perf_counter()
    sig = agg["signature"](n_keys)
    log(f"[paths 7b] {n_keys} keys and the aggregate signature made in "
        f"{time.perf_counter() - t0:.1f} s (not timed as verification)")
    cases = {"aggregate": (pks, msg, True), "wrong_message": (pks, other, False),
             "one_key_short": (pks[:-1], msg, False)}
    for name, (keys, m, expect) in cases.items():
        if api.fast_aggregate_verify(keys, m, sig) is not expect:
            raise AssertionError(f"host oracle: {name} is not {expect}")
    reset_counts()
    ok, first_s = timed(lambda: dv.fast_aggregate_verify_device(pks, msg, sig, device=dev))
    counts = path_launches("fast_aggregate_verify")
    if ok is not True:
        raise AssertionError(f"aggregate signature of {n_keys} keys rejected")
    times = [first_s]
    for _ in range(repeats - 1):
        ok, t = timed(lambda: dv.fast_aggregate_verify_device(pks, msg, sig, device=dev))
        if ok is not True:
            raise AssertionError("aggregate signature rejected on a repeat")
        times.append(t)
    for name in ("wrong_message", "one_key_short"):
        keys, m, _ = cases[name]
        if dv.fast_aggregate_verify_device(keys, m, sig, device=dev) is not False:
            raise AssertionError(f"fast_aggregate_verify accepted the {name} case")
    med = statistics.median(times)
    log(f"[paths 7b] fast_aggregate_verify_device, {n_keys} keys: aggregate accepted, "
        f"wrong message and {n_keys - 1} keys rejected, as the host oracle says")
    log(f"[paths 7b] median {med:.3f} s over {len(times)} runs ({', '.join(f'{t:.3f}' for t in times)})")
    log(f"[paths 7b] launches {json.dumps(counts['launches'])}, largest n {json.dumps(counts['largest_n'])}")
    return {"keys": n_keys, "median_s": med, "runs_s": times, **counts}


class RecordingBackend:
    """The port's ``verify`` module as the pool's backend, recording the
    width of each job it encodes and of each per-set split, and the rows
    of its warm step."""

    def __init__(self):
        from lodestar_tpu_torch.ops.bls12_381 import verify as dv

        self.dv, self.jobs, self.splits, self.warmed = dv, [], [], None

    def encode_job(self, sets, bucket=None, device=None):
        self.jobs.append((len(sets), bucket))
        return self.dv.encode_job(sets, bucket=bucket, device=device)

    def execute_batch(self, job):
        return self.dv.execute_batch(job)

    def verify_each_device(self, sets, bucket=None, device=None):
        self.splits.append((len(sets), bucket))
        return self.dv.verify_each_device(sets, bucket=bucket, device=device)

    def warm_programs(self, programs, device):
        self.warmed = self.dv.warm_programs(programs, device)
        return self.warmed


def run_pool(sets, wrong_key, dev):
    """7c: ``DeviceBlsVerifier`` on the card, four scenarios on one pool,
    the process degradation record reset before each: a fault-free pack
    split by ``verify_each`` stays at tier ``device``; two execute faults
    end at ``per_set``; every device point armed raises the injected fault
    to the waiters as ``DeviceFaultError``; a ``verify_on_main_thread``
    request is answered on the host.  A waiter's outcome is its verdict,
    or its exception's type and cause's type.  Where the card ran, the
    programs replayed and each replayed graph holds launches of K1, K2 and
    K3; the pool warms its programs first (captured in 8a already)."""
    from lodestar_tpu_torch.chain.bls import breaker as brk
    from lodestar_tpu_torch.chain.bls import device_pool as dp
    from lodestar_tpu_torch.chain.bls.interface import VerifyOptions
    from lodestar_tpu_torch.aot import graphs
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.testing import faults

    width = dp.governed_steady_width()
    backend = RecordingBackend()
    pool = dp.DeviceBlsVerifier(_backend=backend, device=dev)
    batchable = VerifyOptions(batchable=True)
    if width % 4 or width > len(sets):
        raise AssertionError(f"governed width {width} does not split into four requests")

    def wrong(s):
        return api.SignatureSet(s.public_key, s.message, wrong_key.sign(s.message))

    scenarios = []

    async def scenario(name, reqs, opts, expect, tier, arm=(), launched=True):
        brk.reset_process_record()
        reset_counts()
        del backend.jobs[:], backend.splits[:]
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            plans = [stack.enter_context(faults.inject(p, times=n)) for p, n in arm]
            got = [r if not isinstance(r, BaseException)
                   else [type(r).__name__, type(r.__cause__).__name__]
                   for r in await asyncio.gather(*(pool.verify_signature_sets(r, opts) for r in reqs),
                                                 return_exceptions=True)]
        secs = time.perf_counter() - t0
        record = brk.process_degradation()
        row = {"name": name, "sets": [len(r) for r in reqs], "verdicts": got,
               "tier": record["worst_tier"], "breaker": record["breaker_state"],
               "jobs": list(backend.jobs), "splits": list(backend.splits),
               "faults_fired": {p.point: p.fired for p in plans}, "s": secs}
        log(f"[paths 7c] {name}: verdicts {got}, tier {row['tier']}, breaker {row['breaker']}, "
            f"jobs {row['jobs']}, per-set splits {row['splits']}, {secs:.3f} s")
        if got != expect:
            raise AssertionError(f"pool scenario {name}: verdicts {got}, expected {expect}")
        if row["tier"] != tier:
            raise AssertionError(f"pool scenario {name}: tier {row['tier']}, expected {tier}")
        if [p.fired for p in plans] != [n for _, n in arm]:
            raise AssertionError(f"pool scenario {name}: faults fired {row['faults_fired']}")
        if launched:
            row.update(path_launches(f"the pool's {name} scenario"))
            short = {key: graphs.CAPTURED[key] for key in row["replays"]
                     if min(graphs.CAPTURED[key].values()) <= 0}
            if not row["replays"] or short:
                raise AssertionError(f"pool scenario {name}: replays {row['replays']}, graphs "
                                     f"without a launch of every kernel: {short}")
        else:
            launches, _, replays = run_counts()
            if any(launches.values()) or replays:
                raise AssertionError(f"pool scenario {name} launched kernels: {launches}, {replays}")
        scenarios.append(row)
        return row

    async def drive():
        try:
            quarter = width // 4
            reqs = [sets[i * quarter:(i + 1) * quarter] for i in range(4)]
            reqs[2] = reqs[2][:-1] + [wrong(reqs[2][-1])]
            row = await scenario("fault_free", reqs, batchable, [True, True, False, True],
                                 brk.TIER_DEVICE)
            if row["jobs"] != [(width, width)] or row["splits"] != [(width, width)]:
                raise AssertionError(f"four requests did not coalesce into one {width}-set "
                                     f"job: {row['jobs']}")
            half = width // 2
            reqs = [sets[:half], sets[half:width - 1] + [wrong(sets[width - 1])]]
            await scenario("execute_faults_twice", reqs, batchable, [True, False],
                           brk.TIER_PER_SET, arm=[("bls.device.execute", 2)])
            reqs = [[sets[0]], [wrong(sets[1])]]
            raised = ["DeviceFaultError", "FaultError"]
            await scenario("every_device_point", reqs, batchable, [raised, raised],
                           brk.TIER_DEVICE_RETRY,
                           arm=[("bls.device.execute", 2), ("bls.device.each", 1)],
                           launched=False)
            await scenario("verify_on_main_thread", [[sets[2]]],
                           VerifyOptions(verify_on_main_thread=True), [True], brk.TIER_DEVICE,
                           launched=False)
        finally:
            await pool.close()

    asyncio.run(drive())
    if not backend.warmed or {r["status"] for r in backend.warmed} != {"warm"}:
        raise AssertionError(f"the pool did not find its programs warm: {backend.warmed}")
    return {"governed_width": width, "scenarios": scenarios, "warmed": backend.warmed}


def check_new_sizes(torch, rng, dev, paths, main_sizes, names=("each", "fast_aggregate"),
                    tag="paths 7d"):
    """7d (10d): each kernel against its plain version, and its device us
    per launch, at the largest n that the paths ``names`` (7a and 7b; the
    sharded program and its split) launched and at every n they launched
    ten times or more that the main path (phase 5) did not."""
    from lodestar_tpu_torch.ops.bls12_381 import _build, fp_kernels as fpk

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = {}
    for name, (_, _, n_in, n_out, _) in KERNELS.items():
        hists = [paths[p]["launch_sizes"][name] for p in names]
        largest = max(max(h) for h in hists)
        ns = sorted({n for h in hists for n, c in h.items() if c >= 10 and n not in main_sizes[name]}
                    | {largest})
        full = kernel_inputs(torch, rng, largest, n_in, dev)
        shapes = []
        for n in ns:
            xs = [x[-n:].contiguous() for x in full]
            err = check_equal(torch, name, *kernel_pair(torch, fpk, name, xs), f"path n={n}")
            outs = [torch.empty_like(xs[0]) for _ in range(n_out)]
            us = device_us(torch, raw_launch(lib, name, xs, outs, n, stream))
            b_us, _ = bound_us(name, n)
            shapes.append({"n": n, "max_abs_err": err, "device_us": us, "bound_us": b_us,
                           "launches": {p: h.get(n, 0) for p, h in zip(names, hists)}})
            log(f"[{tag}] {name} at n={n}: equal to plain (max |diff| {err}), "
                f"{us:.2f} us on the card per launch, bound {b_us:.3f} us, "
                f"launches {shapes[-1]['launches']}")
        rows[name] = {"largest_n": largest, "max_abs_err": max(r["max_abs_err"] for r in shapes),
                      "shapes": shapes}
    return rows


def governor_fit(medians):
    """The pool's latency model t(B) = floor + per_set * B, fitted by least
    squares to the replay medians of 8d (one job's device stage: the host
    encode overlaps the previous job in the pool), and the steady width the
    pool's governor would give under it."""
    from lodestar_tpu_torch.chain.bls import device_pool as dp
    from lodestar_tpu_torch.ops.bls12_381 import buckets as bk

    xs = [r["width"] for r in medians]
    ys = [r["replay_median_s"] for r in medians]
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    per_set = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sum((x - mx) ** 2 for x in xs)
    floor = my - per_set * mx
    if per_set > 0:
        raw = int((dp.LATENCY_BUDGET_S / 2 - floor) / per_set)
    else:  # no slope: the width does not move the time, and any width fits as well as the least
        raw = dp.MIN_JOB_WIDTH
    raw = min(dp.MAX_SIGNATURE_SETS_PER_JOB, max(dp.MIN_JOB_WIDTH, raw))
    return {"widths": xs, "replay_medians_s": ys, "per_set_s": per_set, "floor_s": floor,
            "governed_width": bk.pool_bucket(raw, cap=dp.MAX_SIGNATURE_SETS_PER_JOB),
            "pool_constants": [dp.MODEL_FLOOR_S, dp.MODEL_PER_SET_S],
            "pool_governed_width": dp.governed_steady_width()}


# ---------------------------------------------------------------------------
# phase 8: the programs as CUDA graphs
# ---------------------------------------------------------------------------


def warm_all(dev, extra_agg_widths):
    """8a: capture every program the pool warms, then the aggregate
    programs at ``extra_agg_widths`` (7b and 8c); one row per program.
    Every row is a fresh capture whose graph holds launches of every kernel."""
    from lodestar_tpu_torch.aot import registry, warm
    from lodestar_tpu_torch.chain.bls import device_pool as dp

    progs = registry.pool_programs(dp.MAX_SIGNATURE_SETS_PER_JOB)
    have = {p.key for p in progs}
    progs += [registry.Program("fast_agg", b, note="chip_smoke 7b/8c") for b in extra_agg_widths
              if f"fast_agg/b{b}" not in have]
    rows = warm.warm_programs(progs, dev)
    for row in rows:
        if row["status"] != "captured" or min(row["launches"].values()) <= 0:
            raise AssertionError(f"warm: {row['key']} was not captured with every kernel: {row}")
        warmup = "none" if row["warmup_s"] is None else f"{row['warmup_s']:.2f} s"
        log(f"[graphs 8a] {row['key']:>14} ({row['note']}): eager warm-up {warmup}, capture "
            f"{row['capture_s']:.2f} s, instantiate {row['instantiate_s']:.2f} s, {row['nodes']} nodes, "
            f"launches {json.dumps(row['launches'])}, host RSS +{row['host_rss_mb']:.0f} MiB "
            f"(process {row['host_rss_total_mb']:.0f} MiB), reserved +{row['reserved_mb']:.0f} MiB, "
            f"constants +{row['constants_added']}")
    log(f"[graphs 8a] {len(rows)} programs captured in {sum(r['wall_s'] for r in rows):.1f} s")
    return rows


def phase_graphs(torch, steps, width: int):
    """8b: each phase of the eager run captured as its own graph and
    replayed on the same inputs; every output tensor must equal the eager
    run's."""
    from lodestar_tpu_torch.aot import graphs
    from lodestar_tpu_torch.ops.bls12_381 import tower as tw

    rows = []
    for name, fn, args, want in steps:
        prog = graphs.GraphedProgram(f"phase/{name}/b{width}", fn, args, warmup=False)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = prog(*args)
        end.record()
        end.synchronize()
        got, want_leaves = tw.leaves(got), tw.leaves(want)
        equal = len(got) == len(want_leaves) and all(
            g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want_leaves))
        if not equal:
            raise AssertionError(f"8b: the graph of phase {name} differs from the eager run")
        rows.append({"phase": name, "tensors": len(got), "nodes": prog.nodes,
                     "capture_s": prog.capture_s, "instantiate_s": prog.instantiate_s,
                     "replay_ms": start.elapsed_time(end), "launches": prog.launches})
        log(f"[graphs 8b] {name}: {len(got)} output tensors equal to the eager run's; "
            f"{prog.nodes} nodes, capture {prog.capture_s:.2f} s, instantiate "
            f"{prog.instantiate_s:.2f} s, replay {rows[-1]['replay_ms']:.1f} ms")
        del prog
    return rows


def tile(sets, width: int):
    """``width`` sets from ``sets``, repeated where there are fewer."""
    return [sets[i % len(sets)] for i in range(width)]


def verdicts_from_replays(sets, wrong_key, agg, widths, dev):
    """8c: at each width, verdicts that only the right inputs give, each
    from one replay: the batch, the per-set split and the aggregate."""
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    def wrong(s):
        return api.SignatureSet(s.public_key, s.message, wrong_key.sign(s.message))

    rows = []
    for width in widths:
        batch = tile(sets, width)
        reset_counts()
        lane, j = width - 5, width // 3
        swapped = list(batch)
        swapped[lane] = api.SignatureSet(batch[lane].public_key, batch[lane].message,
                                         batch[lane + 1].signature)
        wrong_one = list(batch)
        wrong_one[j] = wrong(batch[j])
        hashed = [dv.verify_signature_sets_device(b, device=dev) for b in (batch, swapped, wrong_one)]
        if hashed != [True, False, False]:
            raise AssertionError(f"8c at {width}: hashed verdicts {hashed}, expected [True, False, False]")
        bad = [0, width // 2, width - 1]
        corrupt = list(batch)
        corrupt[0] = api.SignatureSet(batch[0].public_key, batch[0].message, batch[1].signature)
        for k in bad[1:]:
            corrupt[k] = wrong(batch[k])
        each = dv.verify_each_device(corrupt, device=dev)
        if each != [i not in bad for i in range(width)]:
            raise AssertionError(f"8c at {width}: verify_each wrong at "
                                 f"{[i for i in range(width) if each[i] != (i not in bad)]}")
        probes = bad + [1]
        oracle = [api.verify_signature_set(corrupt[i]) for i in probes]
        if oracle != [each[i] for i in probes]:
            raise AssertionError(f"8c at {width}: verify_each differs from the host oracle at {probes}")
        keys, sig = agg["pks"][:width], agg["signature"](width)
        fast = [dv.fast_aggregate_verify_device(k, m, sig, device=dev)
                for k, m in ((keys, agg["msg"]), (keys, agg["other"]), (keys[:-1], agg["msg"]))]
        if fast != [True, False, False]:
            raise AssertionError(f"8c at {width}: aggregate verdicts {fast}, expected [True, False, False]")
        _, _, replays = run_counts()
        want = {f"hashed/b{width}": 3, f"each/b{width}": 1, f"fast_agg/b{width}": 3}
        if replays != want:
            raise AssertionError(f"8c at {width}: replays {replays}, expected {want}")
        tiled = f", the {len(sets)} signed sets tiled" if width > len(sets) else ""
        log(f"[graphs 8c] {width} sets{tiled}: hashed valid/swapped lane {lane}/wrong key lane {j} "
            f"-> {hashed}; verify_each False exactly at {bad}, the host oracle's on {probes}; "
            f"{width} keys aggregate/wrong message/{width - 1} keys -> {fast}; replays {replays}")
        rows.append({"width": width, "hashed": hashed, "each_false": bad, "oracle_checked": probes,
                     "fast_agg": fast, "replays": replays})
    return rows


def replay_medians(torch, sets, widths, replays: int, dev):
    """8d: ``replays`` jobs at each width, the host encode (ending in a
    synchronise) timed apart from the replay (``execute_batch``: the copy
    into the graph's inputs, the replay, the verdict's host sync)."""
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    rows = []
    for width in widths:
        batch = tile(sets, width)
        encode, replay = [], []
        for _ in range(replays):
            t0 = time.perf_counter()
            job = dv.encode_job(batch, bucket=width, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ok = dv.execute_batch(job)
            t2 = time.perf_counter()
            if ok is not True:
                raise AssertionError(f"8d: valid {width}-set batch rejected")
            encode.append(t1 - t0)
            replay.append(t2 - t1)
        row = {"width": width, "replay_median_s": statistics.median(replay), "replay_runs_s": replay,
               "encode_median_s": statistics.median(encode), "encode_runs_s": encode}
        row["sets_per_s"] = width / row["replay_median_s"]
        row["sets_per_s_with_encode"] = width / (row["replay_median_s"] + row["encode_median_s"])
        log(f"[graphs 8d] {width} sets: replay median {row['replay_median_s']:.4f} s "
            f"(min {min(replay):.4f}, max {max(replay):.4f}), host encode median "
            f"{row['encode_median_s']:.4f} s, {row['sets_per_s']:.1f} sets/s by replay, "
            f"{row['sets_per_s_with_encode']:.1f} with the encode")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 9: the sidecar on the card, as its own process
# ---------------------------------------------------------------------------


class Sidecar:
    """``python -m lodestar_tpu_torch.blspool serve --port 0 --verifier
    device`` as a child process, its stdout's announce and its stderr's
    lines read by threads."""

    def __init__(self):
        root = os.path.dirname(os.path.abspath(__file__))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lodestar_tpu_torch.blspool", "serve", "--port", "0",
             "--verifier", "device"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        self.err: list = []
        self.announce: list = []
        self._threads = [
            threading.Thread(target=lambda: self.err.extend(self.proc.stderr), daemon=True),
            threading.Thread(target=lambda: self.announce.append(self.proc.stdout.readline()),
                             daemon=True),
        ]
        for t in self._threads:
            t.start()

    def err_line(self, prefix: str, wait_s: float = 30) -> dict:
        """The first JSON line of its stderr that starts with ``prefix``."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < wait_s:
            for line in list(self.err):
                if line.startswith(prefix):
                    return json.loads(line)
            time.sleep(0.1)
        raise AssertionError(f"9: no {prefix} line from the sidecar: {''.join(self.err)[-2000:]}")

    def wait_announce(self) -> dict:
        self._threads[1].join(SIDECAR_ANNOUNCE_S)
        if not (self.announce and self.announce[0]):
            raise AssertionError(f"9: the sidecar did not announce within {SIDECAR_ANNOUNCE_S} s "
                                 f"(exit {self.proc.poll()}): {''.join(self.err)[-2000:]}")
        return {"announce_s": time.perf_counter() - self.t0, **json.loads(self.announce[0])}

    def stop(self) -> tuple:
        """SIGTERM, then the exit code and the JSON lines of its stderr."""
        self.proc.send_signal(signal.SIGTERM)
        code = self.proc.wait(SIDECAR_EXIT_S)
        self._threads[0].join(10)
        return code, [json.loads(line) for line in self.err if line.startswith("{")]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def drive_sidecar(url: str, sets, wrong_key) -> dict:
    """Cases (a)-(f) against the sidecar at ``url``; one row per case with
    its wall seconds and the answers.  Raises on any unexpected answer."""
    from lodestar_tpu_torch.blspool import codec
    from lodestar_tpu_torch.blspool.http import HttpPoolTransport
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.utils import gather_settled

    async def tenants_at_once(case, groups, valid):
        """One transport per tenant, each connection opened first (a
        health probe), then every request sent at once; each answer must
        be served from the device in one batch of all of them."""
        transports = [HttpPoolTransport(url, request_timeout=120.0) for _ in groups]
        try:
            await gather_settled(*(t.healthz() for t in transports))
            bodies = [codec.encode_request(f"{case}{i}", g) for i, g in enumerate(groups)]
            t0 = time.perf_counter()
            raw = await gather_settled(*(t.request(b) for t, b in zip(transports, bodies)))
            elapsed = time.perf_counter() - t0
        finally:
            for t in transports:
                await t.close()
        answers = [codec.decode_response(r) for r in raw]
        width = sum(len(g) for g in groups)
        for i, (resp, ok) in enumerate(zip(answers, valid)):
            got = (resp["ok"], resp["valid"], resp["degradation_tier"], resp["coalesced_width"],
                   resp["coalesced_tenants"])
            want = (True, ok, "device", width, len(groups))
            if got != want:
                raise AssertionError(f"9{case}, tenant {i}: (ok, valid, tier, width, tenants) "
                                     f"{got}, expected {want}")
        return {"s": elapsed, "sets": width, "valid": [a["valid"] for a in answers],
                "answers": answers}

    def wrong(s):
        return api.SignatureSet(s.public_key, s.message, wrong_key.sign(s.message))

    async def drive():
        rows = {}
        probe = HttpPoolTransport(url, request_timeout=120.0)
        try:
            t0 = time.perf_counter()
            health = await probe.healthz()
            rows["a"] = {"s": time.perf_counter() - t0, "answers": [health]}
            if health != {"ok": True}:
                raise AssertionError(f"9a: /healthz answered {health}")
        finally:
            await probe.close()
        rows["b"] = await tenants_at_once("b", [sets[:128]], [True])
        rows["c"] = await tenants_at_once("c", [sets[128 + 32 * i: 160 + 32 * i] for i in range(4)],
                                          [True] * 4)
        groups = [list(sets[256 + 32 * i: 288 + 32 * i]) for i in range(4)]
        groups[1][4] = wrong(groups[1][4])
        rows["d"] = await tenants_at_once("d", groups, [True, False, True, True])
        rows["d"]["wrong_key"] = "tenant d1, its set 4"
        rows["e"] = await tenants_at_once("e", [sets[:512]], [True])
        garbage = HttpPoolTransport(url, request_timeout=120.0)
        try:
            t0 = time.perf_counter()
            status, raw = await garbage.exchange("POST", "/verify", b"garbage")
        finally:
            await garbage.close()
        resp = codec.decode_response(raw)
        rows["f"] = {"s": time.perf_counter() - t0, "status": status, "answers": [resp]}
        if status != 200 or resp["ok"] is not False or not resp["error"].startswith("bad_request"):
            raise AssertionError(f"9f: garbage answered HTTP {status} {resp}")
        return rows

    return asyncio.run(drive())


def run_sidecar(sidecar: Sidecar, sets, wrong_key) -> dict:
    """Phase 9 after the child was started: its announce, cases (a)-(f),
    SIGTERM, and what it reports having served."""
    import resource

    from lodestar_tpu_torch.chain.bls.device_pool import governed_steady_width
    from lodestar_tpu_torch.ops.bls12_381 import buckets as bk

    announce = sidecar.wait_announce()
    warm = sidecar.err_line('{"warm_s"')
    log(f"[sidecar 9] announced {announce['url']} after {announce['announce_s']:.1f} s "
        f"(warm {warm['warm_s']:.1f} s, host RSS {warm['rss_mb']:.0f} MiB after it)")
    for r in warm["rows"]:
        log(f"[sidecar 9] warm {r['key']}: {r['status']}, wall {r.get('wall_s', 0):.2f} s, capture "
            f"{r.get('capture_s', 0):.2f} s, instantiate {r.get('instantiate_s', 0):.2f} s, "
            f"{r.get('nodes')} nodes, host RSS +{r.get('host_rss_mb', 0):.0f} MiB")
    cases = drive_sidecar(announce["url"], sets, wrong_key)
    code, lines = sidecar.stop()
    if code != 0:
        raise AssertionError(f"9: the sidecar exited {code} after SIGTERM: {''.join(sidecar.err)[-2000:]}")
    served = lines[-1]["served"]
    # every job at the governed width: (b), (c), (d) one job each, and (d)
    # again after its batch failed (the pool splits the failed job per set,
    # then the server verifies each request again, which the pool packs
    # into one job and splits again); (e) in chunks of that width
    width = governed_steady_width()
    bucket = bk.pool_bucket(width)
    want_batches = [[128, 1], [128, 4], [128, 4], [512, 1]]
    want_replays = {f"hashed/b{bucket}": 4 + 512 // width, f"each/b{bucket}": 2}
    if served["batches"] != want_batches or served["replays"] != want_replays:
        raise AssertionError(f"9: the sidecar served batches {served['batches']} with replays "
                             f"{served['replays']}, expected {want_batches} and {want_replays}")
    decode = served["decode"]
    row = {
        "warm_s": warm["warm_s"], "announce_s": announce["announce_s"],
        "rss_after_warm_mb": warm["rss_mb"], "peak_rss_mb": served["peak_rss_mb"],
        # ru_maxrss: KiB, the peak of this process and of its largest child
        "peak_rss_mb_of_children": resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024,
        "parent_peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "warm_rows": warm["rows"],
        "cases": cases, "batches": served["batches"], "replays": served["replays"],
        "connections": served["connections"], "decode": decode,
        "decode_s_per_set": decode["seconds"] / decode["sets"],
        "verdicts": {c: cases[c]["valid"] for c in "bcde"},
        "exit_code": code,
    }
    for case in "abcdef":
        log(f"[sidecar 9{case}] {cases[case]['s']:.3f} s: {json.dumps(cases[case]['answers'])}")
    log(f"[sidecar 9] decode {row['decode_s_per_set'] * 1e3:.2f} ms a set on the host "
        f"({decode['sets']} sets, {decode['seconds']:.2f} s); peak RSS {row['peak_rss_mb']:.0f} MiB "
        f"(this process {row['parent_peak_rss_mb']:.0f} MiB); batches {served['batches']}, "
        f"replays {served['replays']}; exit {code} after SIGTERM")
    return row


# ---------------------------------------------------------------------------
# phase 10: the sharded program over an NCCL world of one rank
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def nccl_world(torch, dev):
    """A process group of one rank (this process) on NCCL, met through a
    ``FileStore`` in a fresh temporary directory; destroyed on the way out,
    so that NCCL's threads cannot hold the exit."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=SHARDED_GROUP_TIMEOUT_S))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_batches(sets, wrong_key, width: int):
    """The valid ``width`` sets, and the same with the set at width // 3
    signed by the wrong key (8c's wrong-key batch)."""
    from lodestar_tpu_torch.crypto.bls import api

    batch = sets[:width]
    j = width // 3
    wrong = list(batch)
    wrong[j] = api.SignatureSet(batch[j].public_key, batch[j].message, wrong_key.sign(batch[j].message))
    return {"valid": batch, "wrong_key": wrong}, j


def run_sharded_eager(torch, batches, rand, group, dev):
    """10a: the host entry's steps on the card, eagerly: this rank's share
    (``encode_shard``, the whole batch at one rank) through the memoized
    sharded program over the NCCL group; each verdict as the ``hashed``
    program's, run eagerly on the same sets and coefficients.  The counts
    read the valid batch's run."""
    from lodestar_tpu_torch.ops.bls12_381 import sharded as sh, verify as dv

    run = sh.sharded_program(group)
    out = {}
    for name, batch in batches.items():
        if name == "valid":
            reset_counts()
        (bucket, args), encode_s = timed(lambda: sh.encode_shard(batch, 0, 1, rand, dev))
        ok, run_s = timed(lambda: bool(run(*args)))
        if name == "valid":
            counts = path_launches("the sharded program")
        job = dv.encode_job(batch, rand=rand, bucket=bucket, device=dev)
        hashed = bool(dv.verify_signature_sets_hashed(*job.args))
        if ok is not (name == "valid") or ok is not hashed:
            raise AssertionError(f"10a: sharded verdict {ok} on the {name} batch; hashed {hashed}")
        out[name] = {"verdict": ok, "hashed": hashed, "encode_s": encode_s, "eager_s": run_s}
    log(f"[sharded 10a] NCCL world of 1, {len(batches['valid'])} sets, eager: valid "
        f"{out['valid']['verdict']}, wrong key {out['wrong_key']['verdict']}, as the hashed "
        f"program's; eager {out['valid']['eager_s']:.3f} s, host encode {out['valid']['encode_s']:.3f} s")
    log(f"[sharded 10a] launches {json.dumps(counts['launches'])}, largest n {json.dumps(counts['largest_n'])}")
    return {**out, **counts}


def run_sharded_graph(torch, batches, rand, width: int, replays: int, dev):
    """10b: ``registry.program("sharded", width, dev, mesh_size=1)``
    captured (its row as 8a's), verdicts through the host entry
    ``verify_signature_sets_sharded`` from replays, then ``replays`` jobs
    with the host encode timed apart from the replay."""
    from lodestar_tpu_torch.aot import registry, warm
    from lodestar_tpu_torch.ops.bls12_381 import sharded as sh

    (row,) = warm.warm_programs([registry.Program("sharded", width, note="chip_smoke 10b", mesh_size=1)], dev)
    if row["status"] != "captured" or min(row["launches"].values()) <= 0:
        raise AssertionError(f"10b: the sharded program was not captured with every kernel: {row}")
    log(f"[graphs 10b] {row['key']:>14} ({row['note']}): eager warm-up {row['warmup_s']:.2f} s, capture "
        f"{row['capture_s']:.2f} s, instantiate {row['instantiate_s']:.2f} s, {row['nodes']} nodes, "
        f"launches {json.dumps(row['launches'])}, host RSS +{row['host_rss_mb']:.0f} MiB "
        f"(process {row['host_rss_total_mb']:.0f} MiB), reserved +{row['reserved_mb']:.0f} MiB")
    reset_counts()
    verdicts = {name: sh.verify_signature_sets_sharded(batch, rand=rand) for name, batch in batches.items()}
    _, _, replayed = run_counts()
    if verdicts != {"valid": True, "wrong_key": False} or replayed != {row["key"]: 2}:
        raise AssertionError(f"10b: verdicts {verdicts} from replays {replayed}")
    run = registry.program("sharded", width, dev, mesh_size=1)
    encode, replay = [], []
    for _ in range(replays):
        t0 = time.perf_counter()
        _, args = sh.encode_shard(batches["valid"], 0, 1, rand, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ok = bool(run(*args))
        t2 = time.perf_counter()
        if ok is not True:
            raise AssertionError("10b: a replay rejected the valid batch")
        encode.append(t1 - t0)
        replay.append(t2 - t1)
    med = {"replay_median_s": statistics.median(replay), "replay_runs_s": replay,
           "encode_median_s": statistics.median(encode), "encode_runs_s": encode}
    log(f"[sharded 10b] verify_signature_sets_sharded from replays: {verdicts}; replay median "
        f"{med['replay_median_s']:.4f} s (min {min(replay):.4f}, max {max(replay):.4f}) over {replays}, "
        f"host encode median {med['encode_median_s']:.4f} s, {width / med['replay_median_s']:.1f} sets/s")
    return {"warm": row, "verdicts": verdicts, "replays": replayed, **med}


def run_sharded_split(torch, batch, rand, split: int, verdict: bool, dev):
    """10c: the ``split``-way sharded program on the one card: each rank's
    share through ``local_partials``, the partials stacked, then the
    combine; its verdict must be 10a's, and its signature sum (affine) and
    Fp12 value before the final exponentiation the unsharded program's,
    bit for bit."""
    from lodestar_tpu_torch.ops.bls12_381 import sharded as sh, tower as tw, verify as dv

    reset_counts()
    t0 = time.perf_counter()
    partials = [sh.local_partials(*sh.encode_shard(batch, r, split, rand, dev)[1]) for r in range(split)]
    sums, fs = tw.stack([p[0] for p in partials]), tw.stack([p[1] for p in partials])
    ss_aff, ss_inf, f = sh.pre_final(sums, fs)
    ok = bool(dv.final_phase(f))
    split_s = time.perf_counter() - t0
    counts = path_launches(f"the {split}-way split")
    _, (pk_aff, pk_inf, msg_aff, msg_inf, sig_aff, sig_inf, active, bits) = sh.encode_shard(
        batch, 0, 1, rand, dev)
    rpk, sig_sum = dv.scalar_mul_phase(pk_aff, pk_inf, sig_aff, sig_inf, bits, active)
    rpk_aff, rpk_inf, want_aff, want_inf = dv.affine_phase(rpk, sig_sum)
    want_f = dv.miller_phase(msg_aff, msg_inf, active, rpk_aff, rpk_inf, want_aff, want_inf)
    same_sum = bool(ss_inf) == bool(want_inf) and all(
        torch.equal(a, b) for a, b in zip(tw.leaves(ss_aff), tw.leaves(want_aff)))
    same_f = all(torch.equal(a, b) for a, b in zip(tw.leaves(f), tw.leaves(want_f)))
    if ok is not verdict or not same_sum or not same_f:
        raise AssertionError(f"10c: verdict {ok} (10a {verdict}), signature sum equal {same_sum}, "
                             f"pre-final Fp12 equal {same_f}")
    log(f"[sharded 10c] {split} shards of {len(batch) // split} on one card: verdict {ok} as 10a's; "
        f"signature sum (affine) and pre-final Fp12 equal to the unsharded run's bit for bit; {split_s:.3f} s")
    return {"split": split, "verdict": ok, "sum_equal": same_sum, "fp12_equal": same_f,
            "eager_s": split_s, **counts}


def run_sharded(torch, rng, sets, wrong_key, replays: int, dev):
    """Phase 10 in an NCCL world of one rank (10a-10c), the world destroyed
    at its end."""
    batches, j = sharded_batches(sets, wrong_key, SHARDED_WIDTH)
    rand = [int.from_bytes(rng.bytes(8), "big") | 1 for _ in range(SHARDED_WIDTH)]
    with nccl_world(torch, dev) as group:
        eager = run_sharded_eager(torch, batches, rand, group, dev)
        graph = run_sharded_graph(torch, batches, rand, SHARDED_WIDTH, replays, dev)
        split = run_sharded_split(torch, batches["valid"], rand, SHARDED_SPLIT, eager["valid"]["verdict"], dev)
    return {"width": SHARDED_WIDTH, "wrong_key_lane": j, "eager": eager, "graph": graph, "split": split}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--widths", default="512,128")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--graph-widths", default=GRAPH_WIDTHS)
    ap.add_argument("--replays", type=int, default=REPLAYS_PER_WIDTH)
    args = ap.parse_args(argv)
    widths = [int(w) for w in args.widths.split(",")]
    graph_widths = [int(w) for w in args.graph_widths.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lodestar_tpu_torch.ops.bls12_381 import _build
    from lodestar_tpu_torch.ops.bls12_381 import buckets as bk

    # 1. device
    smi = nvidia_smi_line()
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    path, messages = _build.build()
    _build.library()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    for line in messages.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    rng = np.random.default_rng(args.seed)

    # 3. kernels against their plain versions
    dev = torch.device("cuda")
    check_kernels(torch, rng, dev)

    # 9. the sidecar, started now so that it warms while the sets are
    # signed here, and driven before this process captures anything
    sidecar = Sidecar()
    try:
        # 4. the main path: one eager run, then (after 8a) replays
        t0 = time.perf_counter()
        # phase 9 sends 512 of them
        sets, wrong_key = make_sets(rng, max(*widths, 512), 8)
        log(f"[setup] signed {len(sets)} sets over {len(sets) // 8} messages "
            f"in {time.perf_counter() - t0:.1f} s (not timed as verification)")
        sidecar_row = run_sidecar(sidecar, sets, wrong_key)
    finally:
        sidecar.kill()
    # 10. the sharded program, before 8a, while this process holds no graph
    sharded = run_sharded(torch, rng, sets, wrong_key, args.replays, dev)
    # 8a. capture every program the pool warms, and the aggregates 7b and 8c
    # need, first: as in a fresh node, the first capture's eager warm-up
    # makes the ops' constants
    warm_rows = warm_all(dev, sorted({bk.bucket_size(AGG_KEYS), *graph_widths}))

    reference_check(torch, sets, dev)
    log("[check] device hash_to_g2 equals the host oracle on two messages")
    ok, phases, eager_s, steps = eager_phases(torch, sets[: widths[0]], dev)
    if not ok:
        raise AssertionError("the eager run rejected the valid batch")
    log(f"[main {widths[0]}] one eager run (the comparison for the replays): {eager_s:.3f} s; "
        f"phases (CUDA events, ms): " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()))

    results = [run_width(torch, sets, wrong_key, w, args.repeats if i == 0 else 1, dev)
               for i, w in enumerate(widths)]
    results[0].update(eager_s=eager_s, phases_ms=phases)
    # launches and their sizes: the valid verify at the first (full) width
    sizes, launches = results[0]["launch_sizes"], results[0]["launches"]

    # 5. kernel times at the shapes of that verify
    rows, floor_us = time_kernels(torch, rng, dev, sizes, launches)

    # 6. profile of one replay
    results[0]["profile"] = device_profile(torch, sets[: widths[0]], dev, results[0]["median_s"])

    # 7. the other paths, each with the counts reset just before it
    agg = make_aggregate(rng, max(AGG_KEYS, *graph_widths))
    paths = {"each": run_each(sets[: widths[0]], wrong_key, args.repeats, dev),
             "fast_aggregate": run_fast_aggregate(
                 {**agg, "pks": agg["pks"][:AGG_KEYS]}, args.repeats, dev),
             "pool": run_pool(sets, wrong_key, dev)}
    paths["kernels_at_new_sizes"] = check_new_sizes(torch, rng, dev, paths, sizes)
    # 10d. the kernels at the sizes the sharded paths launch and the main path does not
    sharded["kernels_at_new_sizes"] = check_new_sizes(torch, rng, dev, sharded, sizes,
                                                      ("eager", "split"), "sharded 10d")

    # 8b-8d. the phases as graphs, verdicts and medians from replays
    graphs = {"warm": warm_rows, "phases": phase_graphs(torch, steps, widths[0])}
    del steps
    graphs["verdicts"] = verdicts_from_replays(sets, wrong_key, agg, graph_widths, dev)
    graphs["medians"] = replay_medians(torch, sets, graph_widths, args.replays, dev)
    paths["governor_fit"] = governor_fit(graphs["medians"])
    log(f"[paths] governor fit: {json.dumps(paths['governor_fit'])}")

    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"sidecar": sidecar_row}), flush=True)
    print(json.dumps({"graphs": graphs}), flush=True)
    print(json.dumps({"paths": paths}), flush=True)
    print(json.dumps({"main_path": results, "launch_floor_us": floor_us, "card": smi}),
          flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
