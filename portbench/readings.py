"""The readings that a cell's limits are set from, many seeds in one
process: ``python3 -m portbench.readings --workload <name> --seeds a,b,...
[--control] [--seconds s]``.

The pool is warmed once, while the workers make every seed's traffic;
then for each seed the window is run and drained and the judged tail
served as in a benchmark run, and the sample judged: the
program's compared numbers against the reference and, with
``--control``, the control's (the reference with every coefficient 1, in
the program's place) on the same sample.  One JSON line a seed.  The
benchmark's own runs do not run the control.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import multiprocessing
import sys

from portbench import check, manifest, run


async def readings(cell: manifest.Cell, seeds, seconds: float, control: bool, wpool, workers: int) -> None:
    from lodestar_tpu_torch.chain.bls.device_pool import DeviceBlsVerifier

    loop = asyncio.get_running_loop()
    made = [loop.run_in_executor(None, run.make_traffic, cell, seed, seconds, wpool, workers) for seed in seeds]
    pool = DeviceBlsVerifier(max_sets_per_job=cell.config["pool"]["max_sets_per_job"])
    await pool.warm()
    # every seed's traffic is made before the first window, so that no
    # generator shares the host with a window
    traffics = [await f for f in made]
    for seed, traffic in zip(seeds, traffics):
        out = await run.drive_window(pool, cell, traffic, seconds)
        e2e = run.end_to_end(out, traffic)
        cfg = cell.traffic["check"]
        judged = check.Judged(seed, cfg["chunk"], control=control)
        judged.submit(wpool, traffic, check.pick_window(traffic, out, seed, cfg))
        tail = await run.drive_tail(pool, traffic, cell.traffic["drain_s"])
        judged.submit(wpool, traffic, check.pick_tail(traffic, tail, seed, cfg))
        row = {"seed": seed, "program": check.readings(judged), "judged": check.describe(judged),
               "attempted": len(out.index), "failed": run.count_failed(out), "gen_s": traffic.gen_s, **e2e}
        if control:
            row["control"] = check.readings(judged, "control")
        print(json.dumps({"readings": row}), flush=True)
    await pool.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    seconds = args.seconds or manifest.load_manifest()["run_seconds"]
    workers = run.worker_count()
    wpool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        run.card_or_exit(cell.chips)
        run.build_kernels()
        asyncio.run(readings(cell, [int(s) for s in args.seeds.split(",")], seconds, args.control, wpool, workers))
    finally:
        wpool.terminate()
        wpool.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
