"""What decides ``correct``: the pool's verdicts on a seeded sample of the
run's requests against the plain reference.

The sample holds, of the window, the ``longest`` requests (the most sets)
and ``sample`` more drawn from the seed; of the judged tail (issued
through the same pool once the window has drained), every request the
traffic made invalid and ``tail`` valid ones drawn from the seed.  The
reference is the frozen oracle copy (``ref/api.py``): a request's verdict
is the AND of batch checks with random 64-bit coefficients from the seed
over runs of at most ``chunk`` of its sets, run in the worker processes.
It reads the inputs the benchmark made and, of the program, only the
verdicts it judges.

Numbers compared, each with its limit (an exact comparison, so 0):

- ``mismatched``: sampled requests whose verdict differs from the
  reference's;
- ``unanswered``: sampled requests that raised or had no verdict by the
  drain's end.

The control is the same reference with every coefficient 1 (an unweighted
sum, the step a batch check is tempted by): it accepts two sets of one
signer that trade signatures, which the tail plants, so it comes out not
correct.
"""
from __future__ import annotations

import time
from typing import List, Tuple

from portbench import gen
from portbench.ref import api

LIMITS = {"mismatched": 0, "unanswered": 0}

Pick = Tuple[object, int]  # (the run's Outcome, a position in it)


def judge_chunk(task) -> tuple:
    key, sets, rand = task
    return key, api.verify_multiple_signature_sets(sets, rand)


def pick_window(traffic, out, seed: int, cfg: dict) -> List[Pick]:
    """The window's requests to judge: the longest, and a seeded sample."""
    issued = list(range(len(out.index)))
    by_size = sorted(issued, key=lambda k: (-len(traffic.raw[out.index[k]]), k))
    chosen = by_size[: cfg.get("longest", 0)]
    taken = set(chosen)
    rest = [k for k in issued if k not in taken]
    chosen += gen.rng(seed, "check").sample(rest, min(cfg["sample"], len(rest)))
    return [(out, k) for k in sorted(chosen)]


def pick_tail(traffic, tail, seed: int, cfg: dict) -> List[Pick]:
    """The tail's requests to judge: every planted one, and a seeded sample
    of the valid ones."""
    planted = [k for k in range(len(tail.index)) if traffic.plan.requests[tail.index[k]].fault]
    taken = set(planted)
    valid = [k for k in range(len(tail.index)) if k not in taken]
    chosen = planted + gen.rng(seed, "check", "tail").sample(valid, min(cfg.get("tail", 0), len(valid)))
    return [(tail, k) for k in sorted(chosen)]


class Judged:
    """Reference (and control) verdicts under way in the workers, for the
    picks submitted so far."""

    def __init__(self, seed: int, chunk: int, control: bool = False):
        self.seed, self.chunk, self.control = seed, chunk, control
        self.picked: List[Pick] = []
        self.pending: List[tuple] = []  # (side, AsyncResult)
        self.sets = 0
        self.t0 = time.perf_counter()

    def submit(self, wpool, traffic, picks: List[Pick]) -> "Judged":
        base = len(self.picked)
        self.picked.extend(picks)
        for side in ("reference", "control") if self.control else ("reference",):
            tasks = []
            for j, (out, k) in enumerate(picks, start=base):
                sets = traffic.raw[out.index[k]]
                r = gen.rng(self.seed, "reference", out.index[k])
                for c in range(0, len(sets), self.chunk):
                    part = sets[c : c + self.chunk]
                    rand = [1] * len(part) if side == "control" else [r.getrandbits(64) | 1 for _ in part]
                    tasks.append(((j, c), part, rand))
            self.pending.append((side, wpool.map_async(judge_chunk, tasks)))
        self.sets += sum(len(traffic.raw[out.index[k]]) for out, k in picks)
        return self

    def verdicts(self, side: str = "reference") -> List[bool]:
        verdicts = [True] * len(self.picked)
        for s, result in self.pending:
            if s == side:
                for (j, _), ok in result.get():
                    verdicts[j] = verdicts[j] and ok
        return verdicts


def readings(judged: Judged, side: str = "reference") -> dict:
    """The compared numbers of the program's verdicts against the
    reference's, or (``side="control"``) of the control's."""
    ref = judged.verdicts("reference")
    if side == "control":
        got = judged.verdicts("control")
        return {"mismatched": sum(1 for a, b in zip(got, ref) if a != b), "unanswered": 0}
    answered = [out.error[k] is None and out.verdict[k] is not None for out, k in judged.picked]
    return {
        "mismatched": sum(1 for (out, k), ok, v in zip(judged.picked, answered, ref) if ok and out.verdict[k] != v),
        "unanswered": sum(1 for ok in answered if not ok),
    }


def collect(judged: Judged, side: str = "reference") -> dict:
    values = readings(judged, side)
    return {name: {"value": values[name], "limit": LIMITS[name]} for name in LIMITS}


def correct(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


def describe(judged: Judged) -> dict:
    """What was judged: requests, sets, the invalid ones by the reference."""
    ref = judged.verdicts("reference")
    return {
        "requests": len(judged.picked),
        "sets": judged.sets,
        "rejected_by_reference": sum(1 for v in ref if not v),
        "seconds": time.perf_counter() - judged.t0,
    }
