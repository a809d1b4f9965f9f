#!/usr/bin/env python3
"""Drive the PyTorch/CUDA BLS verifier on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed N] [--widths 512,128] [--repeats 3]

Phases, one line each (any failure raises and exits non-zero):

1. Device: torch and CUDA versions, the card's name and power limit.
2. Build: compile the hand-written kernels from ``csrc/fp_kernels.cu``
   (``-Xptxas -v``: registers and spills per kernel).  K1-K3 share one
   design: eight lanes of a warp per element on 26-bit digits, CIOS with
   lazy 64-bit accumulators; K3 runs its two products, (a0+a1)(a0+(p-a1))
   and a0 (2 a1), side by side, one reduction each.
3. Kernels: K1-K3 on seeded inputs at ``CHECK_SIZES`` elements (the edge
   values 0, 1, 2, p-1, p-2, (p-1)/2 in every pairing where n >= 36) and
   on broadcast operands with leading axes, held bit for bit against
   their plain PyTorch versions on the same CUDA tensors.
4. The main path at each width: sets made from ``--seed`` with the port's
   own signing (distinct keys; 64 messages at 512 sets, 8 signers each)
   go through ``TorchBlsVerifier.verify_signature_sets``.  The valid batch
   must pass, a batch with another set's signature at one lane and a batch
   with one set signed by the wrong key must fail, and every kernel must
   have launched during the valid verify; the launch counters also give
   each kernel's launches by element count n.  Per-phase CUDA-event times
   come from a second run of the same program split at its phase
   boundaries.
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
6. Profile: one more verify at the first width under torch.profiler, for
   the card's busy share, the kernels that take the most time and the
   time of each hand-written kernel.

The line before the last is a JSON object of the kernels' numbers; the last
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
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
}
SOURCE = "lodestar_tpu_torch/ops/bls12_381/csrc/fp_kernels.cu"

# raw launches per device timing, and wrapper calls per host timing
TIMED_LAUNCHES = 200
# n checked against the plain versions before the main path runs: 1, the
# final exponentiation's 12 and 18, the Miller loop's 512 + 1 pairs, a ~1k
# and a ragged n, and 18 x 513 (one Fp12 product per pair)
CHECK_SIZES = (1, 12, 18, 513, 1024, 1061, 9234)


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


def phase_times(torch, sets, dev):
    """One run of the hashed program split at its phases, timed with CUDA
    events; returns (result, {phase: ms})."""
    from lodestar_tpu_torch.ops.bls12_381 import buckets as bk, curve as cv, h2c
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    job = dv.encode_job(sets, bucket=bk.pool_bucket(len(sets)), device=dev)
    pk_aff, pk_inf, u0, u1, sig_aff, sig_inf, bits, active = job.args
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    events[0].record()
    msg_aff, msg_inf = dv.batch_to_affine(cv.F2, h2c.hash_to_g2_from_fields(u0, u1))
    events[1].record()
    rpk, sig_sum = dv.scalar_mul_phase(pk_aff, pk_inf, sig_aff, sig_inf, bits, active)
    events[2].record()
    rpk_aff, rpk_inf, ss_aff, ss_inf = dv.affine_phase(rpk, sig_sum)
    events[3].record()
    f = dv.miller_phase(msg_aff, msg_inf, active, rpk_aff, rpk_inf, ss_aff, ss_inf)
    events[4].record()
    ok = dv.final_phase(f)
    events[5].record()
    events[5].synchronize()
    names = ["h2c", "scalar_muls", "affine", "miller", "final_exp"]
    return bool(ok), {n: events[i].elapsed_time(events[i + 1]) for i, n in enumerate(names)}


def run_width(torch, all_sets, wrong_key, width: int, repeats: int, dev):
    from lodestar_tpu_torch.chain.bls.verifier import TorchBlsVerifier
    from lodestar_tpu_torch.crypto.bls import api
    from lodestar_tpu_torch.ops.bls12_381 import fp_kernels as fpk

    sets = all_sets[:width]
    verifier = TorchBlsVerifier(device=dev)

    async def verify(batch):
        return await verifier.verify_signature_sets(batch)

    # the valid batch: the launch counters read this one run
    fpk.reset_launches()
    t0 = time.perf_counter()
    ok = asyncio.run(verify(sets))
    first_s = time.perf_counter() - t0
    launches = dict(fpk.LAUNCHES)
    launch_sizes = {k: dict(sorted(v.items())) for k, v in fpk.LAUNCH_SIZES.items()}
    if ok is not True:
        raise AssertionError(f"valid {width}-set batch rejected")
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

    ok, phases = phase_times(torch, sets, dev)
    if not ok:
        raise AssertionError("phase-split run rejected the valid batch")
    med = statistics.median(times)
    log(f"[main {width}] valid batch accepted; lane {lane} swapped signature "
        f"and lane {j} wrong key rejected")
    log(f"[main {width}] verify median {med:.3f} s over {len(times)} runs "
        f"(first {first_s:.3f} s), {width / med:.1f} sets/s")
    log(f"[main {width}] phases (CUDA events, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()))
    log(f"[main {width}] launches in one verify: {json.dumps(launches)}")
    for name, hist in launch_sizes.items():
        log(f"[main {width}] {name} launches by elements n: {json.dumps(hist)}")
    return {"width": width, "median_s": med, "runs_s": times, "phases_ms": phases,
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
    """One verify under torch.profiler: kernel time on the card against
    the wall time of that call and the unprofiled median, and the kernels
    that take the most."""
    from torch.profiler import ProfilerActivity, profile

    from lodestar_tpu_torch.chain.bls.verifier import TorchBlsVerifier

    verifier = TorchBlsVerifier(device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = asyncio.run(verifier.verify_signature_sets(sets))
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
    log(f"[profile {len(sets)}] kernels on the card {busy_s:.3f} s over {n_launch} launches: "
        f"{100 * busy_s / wall_s:.1f} % of this profiled call ({wall_s:.3f} s), "
        f"{100 * busy_s / median_s:.1f} % of the unprofiled median ({median_s:.3f} s)")
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
    from lodestar_tpu_torch.ops.bls12_381 import curve as cv, h2c, tower as tw
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    msgs = [sets[0].message, sets[-1].message]
    u0, u1 = h2c.encode_field_draws(msgs, 2, dev)
    (x, y), inf = dv.batch_to_affine(cv.F2, h2c.hash_to_g2_from_fields(u0, u1))
    for i, m in enumerate(msgs):
        got = (tw.decode_fp2((x[0][i], x[1][i])), tw.decode_fp2((y[0][i], y[1][i])))
        if bool(inf[i]) or got != g2.to_affine(hash_to_g2(m)):
            raise AssertionError("device hash_to_g2 differs from the host oracle")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--widths", default="512,128")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    widths = [int(w) for w in args.widths.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lodestar_tpu_torch.ops.bls12_381 import _build

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

    # 4. the main path
    t0 = time.perf_counter()
    sets, wrong_key = make_sets(rng, max(widths), 8)
    log(f"[setup] signed {len(sets)} sets over {len(sets) // 8} messages "
        f"in {time.perf_counter() - t0:.1f} s (not timed as verification)")
    reference_check(torch, sets, dev)
    log("[check] device hash_to_g2 equals the host oracle on two messages")
    results = [run_width(torch, sets, wrong_key, w, args.repeats, dev) for w in widths]
    # launches and their sizes: the valid verify at the first (full) width
    sizes, launches = results[0]["launch_sizes"], results[0]["launches"]

    # 5. kernel times at the shapes of that verify
    rows, floor_us = time_kernels(torch, rng, dev, sizes, launches)

    # 6. profile
    results[0]["profile"] = device_profile(torch, sets[: widths[0]], dev, results[0]["median_s"])

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
