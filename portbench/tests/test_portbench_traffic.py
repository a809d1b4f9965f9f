"""The generator's arithmetic and determinism."""
import pytest

from portbench import gen, manifest
from portbench.tests.toy import GOSSIP, SEED, SYNC, toy_cell


def _cell(name):
    return manifest.load_cell(name)


def test_a_gossip_slot_is_10976_requests_and_13276_sets():
    cell = _cell(GOSSIP)
    plan = gen.make_plan(cell.config, cell.traffic, SEED, 12)
    timed = [r for r in plan.requests if not r.tail]
    assert len(timed) == 10_976
    assert sum(len(r.set_ids) for r in timed) == 13_276
    assert not any(r.fault for r in timed)
    for spec in cell.traffic["kinds"]:
        lo, hi = spec["window_s"]
        dues = [r.due for r in timed if r.kind == spec["kind"]]
        assert all(lo <= d < hi for d in dues)


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
def test_the_tail_holds_the_planted_faults_at_fixed_places(name):
    cell = _cell(name)
    spec = cell.traffic["tail"]
    for seed in (SEED, 3):
        plan = gen.make_plan(cell.config, cell.traffic, seed, 24)
        tail = [r for r in plan.requests if r.tail]
        assert len(tail) == spec["count"] and all(r.kind == spec["kind"] for r in tail)
        assert [k for k, r in enumerate(tail) if r.fault] == [f["at"] for f in spec["invalid"]]
        assert [tail[f["at"]].fault for f in spec["invalid"]] == [f["fault"] for f in spec["invalid"]]
        assert all(r.due is None and r.segment is None for r in tail)


def test_two_slots_fill_a_24_second_window():
    cell = _cell(GOSSIP)
    plan = gen.make_plan(cell.config, cell.traffic, SEED, 24)
    timed = [r for r in plan.requests if not r.tail]
    assert len(timed) == 2 * 10_976 and max(r.due for r in timed) < 24


def test_a_segment_is_32_blocks_of_125_sets():
    cell = _cell(SYNC)
    plan = gen.make_plan(cell.config, cell.traffic, SEED, 24)
    seg0 = [r for r in plan.requests if r.segment == 0]
    assert len(seg0) == 32 and all(len(r.set_ids) == 125 for r in seg0)
    assert len({plan.sets[i][0] for i in seg0[0].set_ids}) == 67
    timed = [r for r in plan.requests if not r.tail]
    assert len({r.segment for r in timed}) == cell.traffic["bank_segments"]
    # later segments re-key the fresh ones: no hash of their own
    assert len(plan.rekeys) == 32 * 125 * (cell.traffic["bank_segments"] - cell.traffic["fresh_segments"])
    assert not any(r.fault for r in timed)
    assert all(len(r.set_ids) == 125 for r in plan.requests if r.tail)


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
def test_the_same_seed_gives_the_same_traffic(name):
    cell = _cell(name)
    a = gen.make_plan(cell.config, cell.traffic, SEED, 24)
    b = gen.make_plan(cell.config, cell.traffic, SEED, 24)
    c = gen.make_plan(cell.config, cell.traffic, SEED + 1, 24)
    assert a.messages == b.messages and a.sets == b.sets and a.rekeys == b.rekeys
    assert [(r.due, r.set_ids, r.fault, r.swap, r.tail) for r in a.requests] == [
        (r.due, r.set_ids, r.fault, r.swap, r.tail) for r in b.requests]
    assert a.messages != c.messages and a.sets != c.sets
    # every seed offers the same sizes
    assert sorted(len(r.set_ids) for r in a.requests) == sorted(len(r.set_ids) for r in c.requests)


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
def test_the_points_repeat_for_a_seed(name):
    cell = toy_cell(name)
    plan = gen.make_plan(cell.config, cell.traffic, SEED, 1)
    assert gen.build(plan, map, 1) == gen.build(gen.make_plan(cell.config, cell.traffic, SEED, 1), map, 2)


def test_a_segment_in_flight_at_the_close_counts_by_its_share_of_time():
    from portbench import run

    out = run.Outcome(24.0)
    # two segments of two requests done inside the window, the third issued
    # at 22 s and done at 26 s, its first half of the sets answered at once
    for due, done, n in [(0, 1, 3), (0, 11, 1), (11, 12, 3), (11, 22, 1), (22, 23, 3), (22, 26, 1)]:
        out.due.append(float(due))
        out.done.append(float(done))
    n = [3, 1, 3, 1, 3, 1]
    assert run.sets_per_s(out, n, [True] * 6) == (8 + 4 * (24 - 22) / (26 - 22)) / 24
    # a request without a verdict adds nothing
    assert run.sets_per_s(out, n, [True] * 5 + [False]) == (8 + 3) / 24
