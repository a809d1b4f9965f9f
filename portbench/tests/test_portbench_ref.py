"""The frozen copies: the oracle takes what the generator makes, and the
roofline arithmetic is chip_smoke.py's."""
import importlib.util
import os

import pytest

from portbench import check, gen, manifest
from portbench.ref import api, roofline
from portbench.tests.toy import GOSSIP, SEED, SYNC, toy_cell


def _sets(name, seconds=1):
    cell = toy_cell(name)
    plan = gen.make_plan(cell.config, cell.traffic, SEED, seconds)
    return plan, gen.build(plan, map, 1)


def _rand(n):
    return [(0x9E3779B97F4A7C15 * (i + 1)) % 2**64 | 1 for i in range(n)]


def test_aggregate_key_sets_verify_and_planted_faults_do_not():
    plan, raw = _sets(GOSSIP)
    for req, sets in zip(plan.requests, raw):
        assert api.verify_multiple_signature_sets(sets, _rand(len(sets))) == (not req.fault), req.kind
    wrong = next(sets for req, sets in zip(plan.requests, raw) if req.fault == "wrong_key")
    assert not api.verify(*wrong[0])


def test_rekeyed_sets_verify_and_the_control_takes_a_swap():
    plan, raw = _sets(SYNC)
    copies = [sets for req, sets in zip(plan.requests, raw) if req.segment == 1 and not req.fault]
    assert copies and all(api.verify_multiple_signature_sets(s, _rand(len(s))) for s in copies)
    swapped = next(sets for req, sets in zip(plan.requests, raw) if req.fault == "swap")
    assert not api.verify(*swapped[0]) and not api.verify(*swapped[1])
    assert not api.verify_multiple_signature_sets(swapped, _rand(len(swapped)))
    # the control: every coefficient 1 accepts the swapped pair
    assert api.verify_multiple_signature_sets(swapped, [1] * len(swapped))
    assert check.LIMITS == {"mismatched": 0, "unanswered": 0}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(manifest.ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# K1-K3's launch sizes on the main path (PERF.md's kernel table)
MAIN_PATH_N = {
    "mont_mul": (1, 128, 512, 1024, 2048, 4096),
    "f2_mul": (12, 128, 512, 513, 1024, 2048, 6156, 9234),
    "f2_sqr": (1, 128, 256, 512, 513, 1024, 2048),
}


@pytest.mark.parametrize("kernel", sorted(MAIN_PATH_N))
def test_the_frozen_bound_is_chip_smokes(kernel):
    smoke = _chip_smoke()
    for n in MAIN_PATH_N[kernel]:
        assert roofline.bound_us(kernel, n) == smoke.bound_us(kernel, n)
