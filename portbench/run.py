"""Run one cell once: ``python3 -m portbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The program measured is ``lodestar_tpu_torch``'s BLS pool,
``chain.bls.device_pool.DeviceBlsVerifier``, through its entry
``verify_signature_sets``.  One run:

1. starts the generator's worker processes (spawn, before CUDA is
   touched), checks for the card, and builds the kernels into their fixed
   directory in the checkout (``lodestar_tpu_torch/_build/``);
2. constructs the pool with the configuration's settings and awaits
   ``pool.warm()``, the node's and the sidecar's start-up path, while the
   workers make the traffic from ``--seed``; ``setup_s`` runs from the
   process's start until both are done;
3. drives the window: an open loop of requests due on a schedule (each
   timed from when it was due), or a closed loop of segments; then waits
   for every request issued in it (the drain, at most the traffic's
   ``drain_s``);
4. reads ``host_rss_gib`` and the card's peak, hands a seeded sample of
   the window's requests to the plain reference (``check.py``) in the
   workers, and issues the judged tail: the traffic's ``tail`` requests,
   planted invalid ones among them, together through the same pool;
5. with ``--trace 1`` profiles one replay of the width the window
   replayed most, on the cell's own sets;
6. judges the sample and the tail's planted requests, and prints the
   numbers compared beside their limits on standard error, then the
   result as the last line of standard output.

Without a card, with fewer cards than the cell asks for, without the
program, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import math
import multiprocessing
import os
import resource
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from portbench import check, gen, manifest
from portbench.metrics._layers import TraceContext, device_intervals

FORBIDDEN = ("jax", "jaxlib", "flax", "lodestar_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        after_name = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(after_name[19])  # field 22 of stat(5)
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def worker_count() -> int:
    return max(1, min(6, (os.cpu_count() or 2) - 2))


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``lodestar_tpu_torch`` is not ``lodestar_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------


@dataclass
class Traffic:
    plan: gen.Plan
    raw: List[list]  # per request: [(pk, message, sig), ...]
    port_sets: List[list]  # per request: the port's SignatureSets
    gen_s: float


def to_port_sets(raw: List[list]) -> List[list]:
    """The entry's input format: the port's own set types, built from the
    generator's points."""
    from lodestar_tpu_torch.crypto.bls.api import PublicKey, Signature, SignatureSet

    return [[SignatureSet(PublicKey(pk), m, Signature(sig)) for pk, m, sig in sets] for sets in raw]


def make_traffic(cell: manifest.Cell, seed: int, seconds: float, wpool, workers: int,
                 scales=()) -> Traffic:
    t0 = time.perf_counter()
    plan = gen.make_plan(cell.config, cell.traffic, seed, seconds, scales)
    raw = gen.build(plan, wpool.map, workers)
    return Traffic(plan, raw, to_port_sets(raw), time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


@dataclass
class Outcome:
    """Per request issued in the window: when it was due (open loop) or
    issued (closed loop), when it started, when its verdict came, the
    verdict, and the error it raised."""

    seconds: float
    index: List[int] = field(default_factory=list)
    due: List[float] = field(default_factory=list)
    started: List[float] = field(default_factory=list)
    done: List[Optional[float]] = field(default_factory=list)
    verdict: List[Optional[bool]] = field(default_factory=list)
    error: List[Optional[str]] = field(default_factory=list)
    origin: float = 0.0  # the window's opening on the loop's clock
    drain_s: float = 0.0


class _Driver:
    def __init__(self, pool, opts, out: Outcome, loop):
        self.pool, self.opts, self.out, self.loop = pool, opts, out, loop
        self.tasks: list = []

    def fire(self, i: int, sets, due: float) -> None:
        out = self.out
        k = len(out.index)
        out.index.append(i)
        out.due.append(due)
        out.started.append(self.loop.time() - out.origin)
        out.done.append(None)
        out.verdict.append(None)
        out.error.append(None)
        task = self.loop.create_task(self.pool.verify_signature_sets(sets, self.opts))
        task.add_done_callback(lambda t, k=k: self._finish(k, t))
        self.tasks.append(task)

    def _finish(self, k: int, task) -> None:
        out = self.out
        out.done[k] = self.loop.time() - out.origin
        if task.cancelled():
            out.error[k] = "cancelled"
        elif task.exception() is not None:
            e = task.exception()
            out.error[k] = f"{type(e).__name__}: {e}"
        else:
            out.verdict[k] = bool(task.result())

    async def drain(self, limit_s: float) -> None:
        pending = [t for t in self.tasks if not t.done()]
        t0 = self.loop.time()
        if pending:
            await asyncio.wait(pending, timeout=limit_s)
        self.out.drain_s = self.loop.time() - t0


async def open_loop(pool, opts, traffic: Traffic, seconds: float, drain_s: float,
                    offset: float = 0.0) -> Outcome:
    """The requests due in [offset, offset + seconds) of the traffic's
    schedule, each started at its due time."""
    loop = asyncio.get_running_loop()
    out = Outcome(seconds)
    driver = _Driver(pool, opts, out, loop)
    out.origin = loop.time() + 0.05
    for i, req in enumerate(traffic.plan.requests):
        if req.tail:
            continue
        due = req.due - offset
        if 0 <= due < seconds:
            loop.call_at(out.origin + due, driver.fire, i, traffic.port_sets[i], due)
    await asyncio.sleep(max(0.0, out.origin + seconds - loop.time()))
    await driver.drain(drain_s)
    return out


async def closed_loop(pool, opts, traffic: Traffic, seconds: float, drain_s: float) -> Outcome:
    """One segment in flight: its requests issued together, the next
    segment when all have returned; the bank wraps if the window outlasts
    it."""
    loop = asyncio.get_running_loop()
    out = Outcome(seconds)
    driver = _Driver(pool, opts, out, loop)
    segments: dict = {}
    for i, req in enumerate(traffic.plan.requests):
        if not req.tail:
            segments.setdefault(req.segment, []).append(i)
    order = [segments[k] for k in sorted(segments)]
    out.origin = loop.time()
    k = 0
    while loop.time() - out.origin < seconds:
        ids = order[k % len(order)]
        if k == len(order):
            log(f"[window] the bank's {len(order)} segments are used up: segments repeat from here")
        k += 1
        now = loop.time() - out.origin
        first = len(driver.tasks)
        for i in ids:
            driver.fire(i, traffic.port_sets[i], now)
        left = out.origin + seconds + drain_s - loop.time()
        await asyncio.wait(driver.tasks[first:], timeout=max(0.0, left))
    await driver.drain(max(0.0, out.origin + seconds + drain_s - loop.time()))
    return out


async def drive_tail(pool, traffic: Traffic, drain_s: float) -> Outcome:
    """The judged tail, after the window has drained: every tail request
    issued at once, so that the pool packs the burst the same way in every
    run, and waited for at most ``drain_s``."""
    loop = asyncio.get_running_loop()
    out = Outcome(0.0)
    driver = _Driver(pool, verify_options(), out, loop)
    out.origin = loop.time()
    for i, req in enumerate(traffic.plan.requests):
        if req.tail:
            driver.fire(i, traffic.port_sets[i], 0.0)
    await driver.drain(drain_s)
    return out


# ---------------------------------------------------------------------------
# end-to-end metrics
# ---------------------------------------------------------------------------


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank percentile (q in 0-100) of ``values``."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


def sets_per_s(out: Outcome, n_sets: List[int], ok: List[bool]) -> float:
    """Sets verdicted per second of the window.  Requests issued together
    (a closed loop's segment; in an open loop each request alone) are one
    unit: a unit whose last verdict came inside the window counts whole,
    and a unit in flight at the close counts by the share of its time, from
    its issue to its last verdict, that fell inside it.  Counting a unit's
    requests as they return would move the rate in steps of a job: the
    first job of a segment answers half of its sets at once, so where the
    close fell against it moved the rate by a quarter."""
    t = out.seconds
    units: dict = {}
    for k, n in enumerate(n_sets):
        if ok[k]:
            sets, end = units.get(out.due[k], (0, 0.0))
            units[out.due[k]] = (sets + n, max(end, out.done[k]))
    inside = 0.0
    for start, (sets, end) in units.items():
        if end <= t:
            inside += sets
        elif start < t:
            inside += sets * (t - start) / (end - start)
    return inside / t


def end_to_end(out: Outcome, traffic: Traffic) -> dict:
    """``sets_per_s`` over the window; latencies from each request's due
    time to its verdict, a request without one (raised, or not answered
    by the drain's end) counting as missing: at the drain's end."""
    n_sets = [len(traffic.raw[i]) for i in out.index]
    ok = [out.error[k] is None and out.verdict[k] is not None for k in range(len(out.index))]
    end = out.seconds + out.drain_s
    lat = [
        (out.done[k] if ok[k] else max(end, out.done[k] or end)) - out.due[k]
        for k in range(len(out.index))
    ]
    late = [out.started[k] - out.due[k] for k in range(len(out.index))]
    return {
        "sets_per_s": sets_per_s(out, n_sets, ok),
        "p50_latency_ms": 1e3 * percentile(lat, 50) if lat else None,
        "p95_latency_ms": 1e3 * percentile(lat, 95) if lat else None,
        "missing": sum(1 for x in ok if not x),
        "generator_late_max_ms": 1e3 * max(late) if late else None,
        "generator_late_p99_ms": 1e3 * percentile(late, 99) if late else None,
    }


def host_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


# ---------------------------------------------------------------------------
# the traced run's profile and breakdown
# ---------------------------------------------------------------------------


def short_name(kernel: str) -> str:
    """A kernel's name without its return type and namespace, cut to 120
    characters (template arguments make torch's run to thousands)."""
    name = kernel.removeprefix("void ").replace("at::native::", "")
    return name[:120]


def profile_replay(torch, ctx: TraceContext, traffic: Traffic, device) -> Optional[dict]:
    """One replay of the ``hashed`` program, at the width the window
    replayed most, on the cell's own sets, under ``torch.profiler`` (the
    card's activity only).  The profiler's raw events are summed by kernel
    name; its own parse into a tree of events takes about a minute for
    the ~470k kernels of a replay, and is not run."""
    from torch.profiler import ProfilerActivity, profile

    from lodestar_tpu_torch.aot import graphs
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    widths = [s["bucket"] for s in ctx.in_window("execute")]
    if not widths:
        return None
    width = statistics.mode(widths)
    sets = []
    for i, req in enumerate(traffic.plan.requests):
        if not req.fault:
            sets.extend(traffic.port_sets[i])
        if len(sets) >= width:
            break
    sets = sets[:width]
    job = dv.encode_job(sets, bucket=width, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        ok = dv.execute_batch(job)
        wall_s = time.perf_counter() - t1
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            count, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (count + 1, ns + e.duration_ns())
    key = f"hashed/b{width}"
    log(f"[profile] {key}: verdict {ok} on {len(sets)} valid sets, replay {wall_s:.4f} s under the "
        f"profiler, {sum(c for c, _ in by_name.values())} events on the card in {len(by_name)} names, "
        f"read in {time.perf_counter() - t0:.1f} s")
    if not by_name:
        log("[profile] the profiler recorded nothing on the card")
        return None
    rows = [(name, count, ns / 1e9) for name, (count, ns) in by_name.items()]
    return {
        "key": key,
        "wall_s": wall_s,
        "busy_s": sum(t for _, _, t in rows),
        "kernels": rows,
        "captured_sizes": graphs.CAPTURED_SIZES.get(key, {}),
    }


def _covered(a: float, b: float, intervals: List[tuple]) -> float:
    """Seconds of [a, b] inside the union of ``intervals``."""
    total, reach = 0.0, a
    for s, e in sorted((max(s, a), min(e, b)) for s, e in intervals if s < b and e > a):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def idle_gaps(ctx: TraceContext, out: Outcome) -> List[list]:
    """The window's longest gaps between the card's device calls, each
    named by what the host was doing in it."""
    intervals = [(a, b) for a, b in device_intervals(ctx) if b > 0 and a < ctx.window_s]
    encodes = [(s["t0"], s["t1"]) for s in ctx.spans if s["kind"] == "encode"]
    gaps = []
    prev_end = 0.0
    for a, b in intervals + [(ctx.window_s, ctx.window_s)]:
        if a > prev_end:
            gaps.append((prev_end, min(a, ctx.window_s)))
        prev_end = max(prev_end, b)
    named = []
    for a, b in gaps:
        overlap = sum(max(0.0, min(b, e1) - max(a, e0)) for e0, e1 in encodes)
        waited = _covered(a, b, [(out.started[k], out.done[k] if out.done[k] is not None else b)
                                 for k in range(len(out.index))])
        if overlap >= 0.5 * (b - a):
            label = "host encode"
        elif waited >= 0.5 * (b - a):
            label = "requests waiting: batching window or dispatch"
        else:
            label = "no request outstanding"
        named.append([label, b - a])
    return sorted(named, key=lambda g: -g[1])[:10]


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def verify_options():
    from lodestar_tpu_torch.chain.bls.interface import VerifyOptions

    return VerifyOptions(batchable=True)


async def drive_window(pool, cell: manifest.Cell, traffic: Traffic, seconds: float) -> Outcome:
    drain_s = cell.traffic["drain_s"]
    if cell.traffic["loop"] == "open":
        return await open_loop(pool, verify_options(), traffic, seconds, drain_s)
    return await closed_loop(pool, verify_options(), traffic, seconds, drain_s)


def count_failed(out: Outcome) -> int:
    return sum(1 for k in range(len(out.index)) if out.error[k] is not None or out.verdict[k] is None)


async def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, wpool, workers: int,
                   device=None, max_sets_per_job: Optional[int] = None, backend=None) -> dict:
    """One run of ``cell``; returns the result's fields (and ``compared``).
    ``device="cpu"``, a small ``max_sets_per_job`` and a stand-in
    ``backend`` for the program's verify module serve the tests'
    rehearsals at toy scale, whose numbers are not metrics."""
    import torch

    from lodestar_tpu_torch.chain.bls import breaker
    from lodestar_tpu_torch.chain.bls.device_pool import DeviceBlsVerifier
    from lodestar_tpu_torch.ops.bls12_381 import verify as dv

    on_card = device is None
    inner = dv if backend is None else backend
    loop = asyncio.get_running_loop()
    traffic_f = loop.run_in_executor(None, make_traffic, cell, seed, seconds, wpool, workers)
    spans = None
    if trace:
        from portbench.spans import SpanBackend

        spans = SpanBackend(inner, torch, timed_device=on_card)
    breaker.reset_process_record()
    pool = DeviceBlsVerifier(
        _backend=spans or backend,
        max_sets_per_job=max_sets_per_job or cell.config["pool"]["max_sets_per_job"],
        device=device,
    )
    t_warm = time.perf_counter()
    await pool.warm()
    warm_s = time.perf_counter() - t_warm
    traffic = await traffic_f
    setup_s = process_age_s()
    log(json.dumps({"setup": {"cpu_count": os.cpu_count(), "workers": workers, "gen_s": traffic.gen_s,
                              "warm_s": warm_s, "setup_s": setup_s, "requests": len(traffic.raw),
                              "sets": sum(map(len, traffic.raw)), "programs": len(pool.warm_rows)}}))
    out = await drive_window(pool, cell, traffic, seconds)
    rss = host_rss_gib()
    e2e = end_to_end(out, traffic)
    degraded = breaker.process_degradation()
    peak = torch.cuda.max_memory_reserved() if on_card else 0
    log(json.dumps({"window": e2e, "attempted": len(out.index), "drain_s": out.drain_s,
                    "degradation": degraded, "age_s": process_age_s()}))

    # the reference judges the window's sample in the workers while the
    # pool serves the judged tail, and while a traced run profiles
    check_cfg = cell.traffic["check"]
    judged = check.Judged(seed, check_cfg["chunk"])
    judged.submit(wpool, traffic, check.pick_window(traffic, out, seed, check_cfg))
    tail = await drive_tail(pool, traffic, cell.traffic["drain_s"])
    judged.submit(wpool, traffic, check.pick_tail(traffic, tail, seed, check_cfg))
    log(json.dumps({"tail": {"requests": len(tail.index), "drain_s": tail.drain_s,
                             "rejected": sum(1 for v in tail.verdict if v is False),
                             "unanswered": count_failed(tail)}, "age_s": process_age_s()}))
    ctx = None
    breakdown = None
    if trace:
        ctx = TraceContext(seconds, spans.finish(out.origin), None, pool.warm_rows)
        if on_card:
            ctx.profile = profile_replay(torch, ctx, traffic, torch.device("cuda"))
        breakdown = {
            "device_ops": [[short_name(name), t] for name, _, t in sorted(ctx.profile["kernels"], key=lambda r: -r[2])[:10]]
            if ctx.profile else [],
            "idle_gaps": idle_gaps(ctx, out),
        }
    await pool.close()
    compared = check.collect(judged)
    log(json.dumps({"judged": check.describe(judged), "age_s": process_age_s()}))

    failed = count_failed(out)
    if degraded.get("worst_tier") != breaker.TIER_DEVICE:
        failed = len(out.index)
    metrics = {}
    if not on_card:
        pass  # a rehearsal on the host measures nothing
    elif trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s, host_rss_gib=rss)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace and ctx.profile:
        dev["busy_s"] = ctx.profile["busy_s"]
        dev["window_s"] = ctx.profile["wall_s"]
    result = {
        "correct": check.correct(compared),
        "attempted": len(out.index),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_or_exit(chips: int):
    """torch, once the card is found; exits 2 where it is not."""
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the program on the card only")
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} cards, this machine has {torch.cuda.device_count()}")
        sys.exit(2)
    return torch


def build_kernels() -> float:
    """Build (or find built) the kernels in ``lodestar_tpu_torch/_build/``."""
    from lodestar_tpu_torch.ops.bls12_381 import _build

    t0 = time.perf_counter()
    _build.library()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.load_cell(args.workload)
    workers = worker_count()
    wpool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        torch = card_or_exit(cell.chips)
        log(json.dumps({"device": {"name": torch.cuda.get_device_name(0), "torch": torch.__version__,
                                   "cuda": torch.version.cuda, "build_s": build_kernels()}}))
        result = asyncio.run(run_cell(cell, args.seed, args.seconds, bool(args.trace), wpool, workers))
    finally:
        wpool.terminate()
        wpool.join()
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: the benchmark must not import JAX or the JAX package")
        return 3
    for name, c in result["compared"].items():
        log(f"compared {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
