"""Find an open-loop cell's knee once, on the card: ``python3 -m
portbench.sweep --workload <name> --seed <n> [--scales 0.25,0.5,...]
[--slots 2]``.

One process warms the pool once, then offers ``--slots`` slots of the
cell's mix at each scale in turn, the pool drained in between, and prints
one JSON line a scale: the backlog (sets due and not yet answered) at the
end of each slot, the latencies and the sets per second.  The knee is the
highest scale at which the backlog at a slot's end does not grow from the
first slot to the last by more than one job of the pool's smallest width;
a scale whose drain outlasts the traffic's ``drain_s`` ends the sweep.
The scale a cell runs at is chosen from this once and written into its
traffic file; the benchmark's runs never search for it.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import multiprocessing
import sys

from portbench import manifest, run

SMALLEST_JOB = 128


def backlog(out: run.Outcome, traffic: run.Traffic, t: float) -> int:
    """Sets of the requests due before ``t`` that had no verdict at ``t``."""
    return sum(
        len(traffic.raw[out.index[k]])
        for k in range(len(out.index))
        if out.due[k] < t and (out.done[k] is None or out.done[k] > t)
    )


async def sweep(cell: manifest.Cell, seed: int, scales, slots: int, wpool, workers: int) -> list:
    from lodestar_tpu_torch.chain.bls.device_pool import DeviceBlsVerifier

    slot_s = cell.traffic["slot_s"]
    loop = asyncio.get_running_loop()
    traffic_f = loop.run_in_executor(
        None, run.make_traffic, cell, seed, slots * slot_s, wpool, workers, scales
    )
    pool = DeviceBlsVerifier(max_sets_per_job=cell.config["pool"]["max_sets_per_job"])
    await pool.warm()
    traffic = await traffic_f
    run.log(json.dumps({"setup": {"gen_s": traffic.gen_s, "setup_s": run.process_age_s()}}))
    rows = []
    for i, scale in enumerate(scales):
        out = await run.open_loop(pool, run.verify_options(), traffic, slots * slot_s, cell.traffic["drain_s"],
                                  offset=i * slots * slot_s)
        e2e = run.end_to_end(out, traffic)
        ends = [backlog(out, traffic, (j + 1) * slot_s) for j in range(slots)]
        row = {"scale": scale, "backlog_at_slot_end": ends, "drain_s": out.drain_s,
               "attempted": len(out.index), "failed": run.count_failed(out), **e2e}
        rows.append(row)
        print(json.dumps({"sweep": row}), flush=True)
        if e2e["missing"]:
            run.log(f"[sweep] scale {scale}: {e2e['missing']} requests unanswered after the drain; stopping")
            break
    await pool.close()
    return rows


def knee(rows: list):
    ok = [r["scale"] for r in rows
          if not r["missing"] and r["backlog_at_slot_end"][-1] <= r["backlog_at_slot_end"][0] + SMALLEST_JOB]
    return max(ok) if ok else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--scales", default="0.25,0.5,0.75,1,1.25,1.5,2")
    p.add_argument("--slots", type=int, default=2)
    args = p.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    scales = [float(s) for s in args.scales.split(",")]
    workers = run.worker_count()
    wpool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        run.card_or_exit(cell.chips)
        run.build_kernels()
        rows = asyncio.run(sweep(cell, args.seed, scales, args.slots, wpool, workers))
    finally:
        wpool.terminate()
        wpool.join()
    k = knee(rows)
    print(json.dumps({"knee": k, "cell_scale": None if k is None else min(1.0, 0.8 * k)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
