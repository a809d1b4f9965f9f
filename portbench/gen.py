"""The benchmark's one traffic generator: BLS signature sets and the requests
that carry them, made from ``--seed`` by the parameters of a configuration
file (the deployment) and a traffic file (the mix).

Nothing here imports the program under test: keys, messages, signatures
and the hashing come from the frozen oracle copy in ``portbench/ref``.

What it makes, cheaply:

- every distinct message is hashed to G2 once, and every set signed under
  it as sk * H(m); sets of one message get consecutive secret keys, so
  that the next key and signature are one point addition away;
- an aggregate's set comes straight from the summed secret key (the pool
  only ever sees the aggregated pubkey, which the node computes before it
  calls the pool);
- where a mix needs more distinct sets than it has messages (range sync's
  later segments), a set is re-keyed as (t*pk, m, t*sig) with a fresh
  32-bit t from the seed: valid, distinct, and no hash.

Request kinds follow the consensus specs' mainnet duties and Lodestar's
gossip validation (one set per attestation and sync-committee message,
three per aggregate and per sync contribution, a block's sets in one
request).  The timed traffic is all valid, as the sources describe it.
A traffic file's ``tail`` adds the judged tail: ``count`` requests of one
kind, issued together once the window has drained, with faults planted
at fixed positions (``at``): ``wrong_key`` (the set's pubkey is the next
validator's) and ``swap`` (two sets of one signer trade signatures: each
is invalid, their unweighted sum is not).

The work is split into tasks of whole message groups that worker
processes run (``points_for_groups``, ``rekey``); ``build`` turns their
results into requests of ``(pubkey, message, signature)`` tuples.
"""
from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.ref.curve import G1_GEN_JAC, g1, g2
from portbench.ref.fields import R
from portbench.ref.hash_to_curve import hash_to_g2

RefSet = Tuple[object, bytes, object]  # (affine pubkey, message, affine signature)

# the cost of one task, in units of one set's point arithmetic: hashing a
# message costs about as much as signing twenty sets by addition
_HASH_COST = 20


def rng(seed: int, *tags) -> random.Random:
    """A generator of its own for each (seed, tags): the same seed gives the
    same draws whatever else the traffic asks for."""
    return random.Random("/".join(str(t) for t in (seed,) + tags))


def _scalar(r: random.Random) -> int:
    return r.randrange(1, R)


@dataclass
class Request:
    kind: str
    set_ids: List[int]
    due: Optional[float] = None  # seconds after the window opens (open loop)
    segment: Optional[int] = None  # closed loop: the segment it belongs to
    swap: Optional[Tuple[int, int]] = None  # positions in set_ids that trade signatures
    fault: str = ""
    tail: bool = False  # issued after the window, in the judged tail


@dataclass
class Plan:
    """What to make: messages, sets as (message index, secret key, fault),
    requests over set ids, and the re-keyed copies of whole segments."""

    seed: int
    messages: List[bytes] = field(default_factory=list)
    sets: List[Tuple[int, int, str]] = field(default_factory=list)
    requests: List[Request] = field(default_factory=list)
    # (set id of the copy, set id of the source, t): filled after the sources
    rekeys: List[Tuple[int, int, int]] = field(default_factory=list)

    def message(self, *tags) -> int:
        self.messages.append(hashlib.sha256("/".join(map(str, (self.seed,) + tags)).encode()).digest())
        return len(self.messages) - 1

    def add_set(self, msg: int, sk: int, fault: str = "") -> int:
        self.sets.append((msg, sk % R or 1, fault))
        return len(self.sets) - 1

    def add_copy(self, source: int, t: int) -> int:
        """A re-keyed copy of set ``source``: (t*pk, m, t*sig)."""
        msg = self.sets[source][0]
        self.sets.append((msg, 0, "copy"))
        self.rekeys.append((len(self.sets) - 1, source, t))
        return len(self.sets) - 1


# ---------------------------------------------------------------------------
# request kinds: counts and shapes from the configuration
# ---------------------------------------------------------------------------


def kind_counts(config: dict, scale: float) -> Dict[str, int]:
    """Requests of each gossip kind in one slot at ``scale`` times the
    deployment's duties (blocks stay one a slot)."""
    committees = config["max_committees_per_slot"]
    return {
        "block": 1,
        "attestation": round(config["validators"] / config["slots_per_epoch"] * scale),
        "sync_message": round(config["sync_committee_size"] * scale),
        "aggregate": round(committees * config["target_aggregators_per_committee"] * scale),
        "sync_contribution": round(
            config["sync_committee_subnet_count"]
            * config["target_aggregators_per_sync_subcommittee"]
            * scale
        ),
    }


def _block(plan: Plan, config: dict, tag: tuple) -> Request:
    """A block's sets in one request: proposer signature and randao reveal
    (one signer), the sync aggregate, and the attestations it includes,
    spread over its committee messages (about two aggregates each)."""
    r = rng(plan.seed, *tag)
    n_sets, n_msgs = config["block"]["sets"], config["block"]["messages"]
    sk_p = _scalar(r)
    ids = [
        plan.add_set(plan.message(*tag, "proposer"), sk_p),
        plan.add_set(plan.message(*tag, "randao"), sk_p),
        plan.add_set(plan.message(*tag, "sync_aggregate"), _scalar(r)),
    ]
    roots = [plan.message(*tag, "committee", c) for c in range(n_msgs - 3)]
    bases = [_scalar(r) for _ in roots]
    for i in range(n_sets - 3):
        c = i % len(roots)
        ids.append(plan.add_set(roots[c], bases[c] + i // len(roots)))
    return Request("block", ids)


def _gossip_kinds(plan: Plan, config: dict, tag: tuple, r: random.Random,
                  counts: Dict[str, int]) -> Dict[str, List[Request]]:
    """``counts[kind]`` requests of each gossip kind, over one slot's shared
    messages (``tag`` names the slot)."""
    committees = config["max_committees_per_slot"]
    per_committee = config["target_aggregators_per_committee"]
    per_subnet = config["target_aggregators_per_sync_subcommittee"]
    att_roots = [plan.message(*tag, "attestation_data", c) for c in range(committees)]
    att_bases = [_scalar(r) for _ in att_roots]
    agg_bases = [_scalar(r) for _ in att_roots]
    block_root = plan.message(*tag, "block_root")
    selection = plan.message(*tag, "selection_proof")
    sync_selection = [
        plan.message(*tag, "sync_selection", q) for q in range(config["sync_committee_subnet_count"])
    ]
    sync_base, sel_base, csel_base, contrib_base = (_scalar(r) for _ in range(4))

    made: Dict[str, List[Request]] = {}
    made["attestation"] = [
        Request("attestation", [plan.add_set(att_roots[i % committees], att_bases[i % committees] + i // committees)])
        for i in range(counts.get("attestation", 0))
    ]
    made["sync_message"] = [
        Request("sync_message", [plan.add_set(block_root, sync_base + i)])
        for i in range(counts.get("sync_message", 0))
    ]
    aggs = []
    for a in range(counts.get("aggregate", 0)):
        c = a % committees
        sk_a = sel_base + a
        aggs.append(Request("aggregate", [
            plan.add_set(selection, sk_a),
            plan.add_set(plan.message(*tag, "aggregate_and_proof", a), sk_a),
            plan.add_set(att_roots[c], agg_bases[c] + a // committees % per_committee),
        ]))
    made["aggregate"] = aggs
    contribs = []
    for s in range(counts.get("sync_contribution", 0)):
        sk_s = csel_base + s
        contribs.append(Request("sync_contribution", [
            plan.add_set(sync_selection[s // per_subnet % len(sync_selection)], sk_s),
            plan.add_set(plan.message(*tag, "contribution_and_proof", s), sk_s),
            plan.add_set(block_root, contrib_base + s),
        ]))
    made["sync_contribution"] = contribs
    return made


def _requests_of(plan: Plan, config: dict, tag: tuple, counts: Dict[str, int]) -> Dict[str, List[Request]]:
    """``counts[kind]`` requests of each kind, blocks included."""
    made = {"block": [_block(plan, config, tag + ("block", b)) for b in range(counts.get("block", 0))]}
    gossip = {k: n for k, n in counts.items() if k != "block" and n}
    if gossip:
        made.update(_gossip_kinds(plan, config, tag, rng(plan.seed, *tag), gossip))
    return made


def _gossip_slot(plan: Plan, config: dict, traffic: dict, slot: int, scale: float) -> List[Request]:
    """One slot's gossip: each kind's requests, due stratified over its
    arrival window (one per equal share of it, at a seeded point inside
    the share, in a seeded order), so that every seed offers the same
    arrivals."""
    made = _requests_of(plan, config, ("slot", slot, scale), kind_counts(config, scale))
    r = rng(plan.seed, "slot", slot, scale, "due")
    out = []
    t0 = slot * traffic["slot_s"]
    for spec in traffic["kinds"]:
        reqs = made[spec["kind"]]
        lo, hi = spec["window_s"]
        order = list(range(len(reqs)))
        r.shuffle(order)
        for share, i in enumerate(order):
            reqs[i].due = t0 + lo + (hi - lo) * (share + r.random()) / len(reqs)
        out.extend(reqs)
    return out


def plan_tail(plan: Plan, config: dict, traffic: dict) -> None:
    """The judged tail (the traffic's ``tail``): ``count`` requests of
    ``kind``, each planted fault at its position ``at`` in issue order, the
    same positions in every seed.  The positions are chosen against the
    pool's packing of the burst, so that one job holds a fault only in the
    first half of its sets and another only in the second."""
    spec = traffic.get("tail")
    if not spec:
        return
    reqs = _requests_of(plan, config, ("tail",), {spec["kind"]: spec["count"]})[spec["kind"]]
    for fault in spec["invalid"]:
        _plant(plan, reqs[fault["at"]], fault["fault"])
    for req in reqs:
        req.tail = True
    plan.requests.extend(reqs)


def _plant(plan: Plan, req: Request, fault: str) -> None:
    """Make ``req`` invalid."""
    req.fault = fault
    if fault == "wrong_key":
        msg, sk, _ = plan.sets[req.set_ids[0]]
        plan.sets[req.set_ids[0]] = (msg, sk, "wrong_key")
    elif fault == "swap":
        # the first two sets share one signer in every kind that has a swap
        req.swap = (0, 1)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def plan_open_loop(config: dict, traffic: dict, seed: int, slots: int, scales: Sequence[float] = ()) -> Plan:
    """``slots`` slots of gossip at the traffic's ``scale`` (or, for a
    sweep, that many slots at each of ``scales`` back to back)."""
    plan = Plan(seed)
    slot = 0
    for scale in scales or [traffic["scale"]]:
        for _ in range(slots):
            plan.requests.extend(_gossip_slot(plan, config, traffic, slot, scale))
            slot += 1
    plan_tail(plan, config, traffic)
    return plan


def plan_closed_loop(config: dict, traffic: dict, seed: int) -> Plan:
    """Range-sync segments: ``fresh_segments`` of new blocks, then re-keyed
    copies of them up to ``bank_segments``; then the judged tail."""
    plan = Plan(seed)
    per_segment = config["epochs_per_batch"] * config["slots_per_epoch"]
    fresh: List[List[Request]] = []
    for k in range(traffic["fresh_segments"]):
        seg = [_block(plan, config, ("segment", k, "block", b)) for b in range(per_segment)]
        fresh.append(seg)
    for k in range(traffic["bank_segments"]):
        r = rng(seed, "segment", k)
        if k < len(fresh):
            seg = fresh[k]
        else:
            seg = [
                Request("block", [plan.add_copy(i, r.randrange(1 << 31, 1 << 32) | 1) for i in src.set_ids])
                for src in fresh[k % len(fresh)]
            ]
        for req in seg:
            req.segment = k
        plan.requests.extend(seg)
    plan_tail(plan, config, traffic)
    return plan


def make_plan(config: dict, traffic: dict, seed: int, seconds: float, scales: Sequence[float] = ()) -> Plan:
    """The plan for a window of ``seconds``: an open loop covers it with
    whole slots; a closed loop makes its bank whatever the window."""
    if traffic["loop"] == "open":
        slots = max(1, math.ceil(seconds / traffic["slot_s"] - 1e-9))
        return plan_open_loop(config, traffic, seed, slots, scales)
    if traffic["loop"] == "closed":
        return plan_closed_loop(config, traffic, seed)
    raise ValueError(f"unknown loop {traffic['loop']!r}")


# ---------------------------------------------------------------------------
# the points, in worker processes
# ---------------------------------------------------------------------------


def group_tasks(plan: Plan, n_tasks: int) -> List[list]:
    """The fresh sets grouped by message, dealt into about ``n_tasks``
    tasks of equal cost: [(message, [(set id, sk, fault), ...]), ...]."""
    groups: Dict[int, list] = {}
    for sid, (msg, sk, fault) in enumerate(plan.sets):
        if fault != "copy":
            groups.setdefault(msg, []).append((sid, sk, fault))
    tasks: List[list] = [[] for _ in range(max(1, n_tasks))]
    load = [0] * len(tasks)
    for msg, members in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        i = load.index(min(load))
        tasks[i].append((plan.messages[msg], members))
        load[i] += _HASH_COST + len(members)
    return [t for t in tasks if t]


def points_for_groups(task: list) -> List[Tuple[int, object, object]]:
    """(set id, affine pk, affine sig) for each set of each message group:
    H(m) once; sk*G1 and sk*H(m) by one addition where the keys run on."""
    out = []
    for message, members in task:
        h = hash_to_g2(message)
        prev = None
        for sid, sk, fault in sorted(members, key=lambda m: m[1]):
            if prev is not None and sk == prev[0]:
                pk, sig = prev[1], prev[2]
            elif prev is not None and sk == prev[0] + 1:
                pk, sig = g1.add_pts(prev[1], G1_GEN_JAC), g2.add_pts(prev[2], h)
            else:
                pk, sig = g1.mul_scalar(G1_GEN_JAC, sk), g2.mul_scalar(h, sk)
            prev = (sk, pk, sig)
            shown = g1.add_pts(pk, G1_GEN_JAC) if fault == "wrong_key" else pk
            out.append((sid, g1.to_affine(shown), g2.to_affine(sig)))
    return out


def rekey(items: list) -> List[Tuple[int, object, object]]:
    """(copy id, t*pk, t*sig) for each (copy id, pk, sig, t)."""
    return [
        (sid, g1.to_affine(g1.mul_scalar(g1.from_affine(pk), t)), g2.to_affine(g2.mul_scalar(g2.from_affine(sig), t)))
        for sid, pk, sig, t in items
    ]


def _chunks(items: list, n: int) -> List[list]:
    n = max(1, min(n, len(items)))
    return [items[i::n] for i in range(n)]


def build(plan: Plan, map_fn, workers: int) -> List[List[RefSet]]:
    """Every request's sets as (pk, message, sig) tuples, in plan order.
    ``map_fn(fn, tasks)`` runs the tasks (a process pool's ``map``)."""
    points: Dict[int, Tuple[object, object]] = {}
    for part in map_fn(points_for_groups, group_tasks(plan, 4 * workers)):
        for sid, pk, sig in part:
            points[sid] = (pk, sig)
    if plan.rekeys:
        items = [(cid, *points[src], t) for cid, src, t in plan.rekeys]
        for part in map_fn(rekey, _chunks(items, 4 * workers)):
            for sid, pk, sig in part:
                points[sid] = (pk, sig)
    out = []
    for req in plan.requests:
        sets = [(points[sid][0], plan.messages[plan.sets[sid][0]], points[sid][1]) for sid in req.set_ids]
        if req.swap:
            i, j = req.swap
            (pi, mi, si), (pj, mj, sj) = sets[i], sets[j]
            sets[i], sets[j] = (pi, mi, sj), (pj, mj, si)
        out.append(sets)
    return out
