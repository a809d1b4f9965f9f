#!/usr/bin/env python3
"""Compare builds of the CUDA kernels on one card, in turns, in one call.

    python3 chip_ab.py prepare NAME=SPEC [NAME=SPEC ...]       # needs git, no card
    python3 chip_ab.py run [--out DIR] [chip_smoke arguments]   # on the card

``prepare`` writes one checkout per side under ``_archive/ab/NAME/``
(``_archive/`` is ignored by git): ``chip_smoke.py`` and
``lodestar_tpu_torch/`` as they stand in the working tree, with the kernel
source ``csrc/fp_kernels.cu`` taken from SPEC:

* ``tree``: the working tree's source unchanged;
* ``rev:REV``: the source as it is at git revision REV (one with the same
  launchers as the working tree's: since the add and subtract kernels,
  five);
* ``tpi:N``: the working tree's source with the lanes per element of
  every kernel (``constexpr int TPI``, the one constant they share) set
  to N.

So only the kernel source differs between the sides: the wrappers, the
launchers' interface and the measuring script are the same.

``run`` runs ``python3 chip_smoke.py`` (by default with ``--widths 512
--repeats 1 --graph-widths 512 --replays 3``) in each side's checkout, the sides in the order given to
``prepare`` and then in reverse (A B B A for two sides), so that a drift of
the card or its host over the call falls on every side alike.  Each run's
output goes to ``DIR/<turn>_<NAME>.log`` (``--out``, by default
``_archive/ab/out``); a run that fails stops the comparison.  It prints,
per kernel and launch size, each side's device us per launch, and per side
the verify's latency, the profiled verify's time on the card and each
hand-written kernel's share of it, each as the runs' values in turn order;
``DIR/summary.json`` holds them.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
AB_DIR = os.path.join(REPO, "_archive", "ab")
OUT_DIR = os.path.join(AB_DIR, "out")
KERNEL_SOURCE = "lodestar_tpu_torch/ops/bls12_381/csrc/fp_kernels.cu"
DEFAULT_SMOKE_ARGS = ["--widths", "512", "--repeats", "1", "--graph-widths", "512", "--replays", "3"]
RUN_TIMEOUT_S = 900
_TPI = re.compile(r"constexpr int TPI = \d+;")


def kernel_source(spec: str, repo: str = REPO) -> str:
    """The kernel source a side builds, from its SPEC."""
    with open(os.path.join(repo, KERNEL_SOURCE)) as f:
        tree = f.read()
    if spec == "tree":
        return tree
    kind, _, arg = spec.partition(":")
    if kind == "rev" and arg:
        return subprocess.run(["git", "show", f"{arg}:{KERNEL_SOURCE}"], cwd=repo,
                              capture_output=True, text=True, check=True).stdout
    if kind == "tpi" and arg.isdigit():
        if len(_TPI.findall(tree)) != 1:
            raise ValueError("the kernel source has no single `constexpr int TPI` line "
                             "(the lanes per element of every kernel)")
        return _TPI.sub(f"constexpr int TPI = {int(arg)};", tree)
    raise ValueError(f"unknown side spec {spec!r}: tree, rev:REV or tpi:N "
                     "(N lanes per element in every kernel)")


def prepare(pairs, ab_dir: str = AB_DIR, repo: str = REPO) -> list:
    """Write one checkout per NAME=SPEC pair under ``ab_dir``; returns the
    side names in order (also kept in ``ab_dir/sides.json``)."""
    sides = [p.partition("=")[::2] for p in pairs]
    if not sides or any(not name or not spec for name, spec in sides):
        raise ValueError("give the sides as NAME=SPEC")
    shutil.rmtree(ab_dir, ignore_errors=True)
    for name, spec in sides:
        src = kernel_source(spec, repo)
        dest = os.path.join(ab_dir, name)
        shutil.copytree(os.path.join(repo, "lodestar_tpu_torch"),
                        os.path.join(dest, "lodestar_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy2(os.path.join(repo, "chip_smoke.py"), dest)
        with open(os.path.join(dest, KERNEL_SOURCE), "w") as f:
            f.write(src)
    names = [name for name, _ in sides]
    with open(os.path.join(ab_dir, "sides.json"), "w") as f:
        json.dump({"sides": dict(sides), "order": names}, f, indent=1)
    return names


def read_run(text: str) -> dict:
    """The numbers of one chip_smoke.py output: its kernels and main-path
    JSON lines, and the registers ptxas reported per kernel."""
    run = {"registers": {}}
    kernel = None
    for line in text.splitlines():
        if line.startswith('{"kernels"'):
            run["kernels"] = json.loads(line)["kernels"]
        elif line.startswith('{"main_path"'):
            run["main"] = json.loads(line)
        m = re.search(r"(mont_mul|f2_mul|f2_sqr)_kernel", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            run["registers"][kernel] = int(m.group(1))
    if "kernels" not in run or "main" not in run:
        raise ValueError("chip_smoke.py printed no kernels or main-path line")
    return run


def summarize(order, runs) -> dict:
    """Per side: its runs' numbers in turn order.  ``runs`` is a list of
    (side, read_run result)."""
    out = {"order": order, "card": sorted({r["main"]["card"] for _, r in runs}),
           "kernels": {}, "sides": {}}
    for side in order:
        mine = [r for s, r in runs if s == side]
        main = [r["main"]["main_path"][0] for r in mine]
        out["sides"][side] = {
            "registers": next((r["registers"] for r in mine if r["registers"]), {}),
            "verify_s": [m["median_s"] for m in main],
            "card_busy_s": [m["profile"]["device_busy_s"] for m in main],
            "hand_written_ms": [{k: v["ms"] for k, v in m["profile"]["hand_written"].items()}
                                for m in main],
            "launch_floor_us": [r["main"]["launch_floor_us"] for r in mine],
        }
        for r in mine:
            for row in r["kernels"]:
                per_n = out["kernels"].setdefault(row["name"], {})
                for s in row["shapes"]:
                    cell = per_n.setdefault(str(s["n"]), {"launches": s["launches"],
                                                          "bound_us": s["bound_us"]})
                    cell.setdefault(side, []).append(s["device_us"])
    return out


def print_summary(summary) -> None:
    order = summary["order"]
    print(f"card: {' | '.join(summary['card'])}")
    for name, per_n in summary["kernels"].items():
        print(f"{name}: device us per launch, runs in turn order")
        print(f"  {'n':>6} {'launches':>8} {'bound':>7}  " + "  ".join(f"{s:>17}" for s in order))
        for n, cell in sorted(per_n.items(), key=lambda kv: int(kv[0])):
            vals = "  ".join(f"{' / '.join(f'{v:.2f}' for v in cell.get(s, [])):>17}" for s in order)
            print(f"  {n:>6} {cell['launches']:>8} {cell['bound_us']:7.3f}  {vals}")
    for side in order:
        s = summary["sides"][side]
        print(f"{side}: registers {s['registers']}, verify s {s['verify_s']}, "
              f"card busy s {s['card_busy_s']}, hand-written ms {s['hand_written_ms']}, "
              f"launch floor us {s['launch_floor_us']}")


def run(smoke_args, ab_dir: str = AB_DIR, out_dir: str = OUT_DIR) -> dict:
    with open(os.path.join(ab_dir, "sides.json")) as f:
        order = json.load(f)["order"]
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for turn, side in enumerate(order + order[::-1], 1):
        log_path = os.path.join(out_dir, f"{turn}_{side}.log")
        proc = subprocess.run([sys.executable, "chip_smoke.py", *smoke_args],
                              cwd=os.path.join(ab_dir, side), capture_output=True,
                              text=True, timeout=RUN_TIMEOUT_S)
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"turn {turn} ({side}) exited {proc.returncode}; see {log_path}")
        print(f"turn {turn}: {side} done", flush=True)
        runs.append((side, read_run(proc.stdout)))
    summary = summarize(order, runs)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print_summary(summary)
    return summary


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["prepare"]:
        print("prepared sides:", ", ".join(prepare(argv[1:])))
        return 0
    if argv[:1] == ["run"]:
        out_dir, rest = OUT_DIR, argv[1:]
        if rest[:1] == ["--out"]:
            out_dir, rest = os.path.abspath(rest[1]), rest[2:]
        run(rest or DEFAULT_SMOKE_ARGS, out_dir=out_dir)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
