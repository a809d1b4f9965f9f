"""Each cell rehearsed end to end on the CPU at toy scale, through the
port's own pool on its host kernels (``DeviceBlsVerifier(device="cpu")``):
one job of the mix's sets, its planted faults split by the per-set
program, every request judged against the reference.  It measures
nothing: the result carries no metric."""
import asyncio
import multiprocessing

import pytest

from portbench import run
from portbench.tests.toy import GOSSIP, SEED, SYNC, toy_cell


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
def test_a_toy_run_of_the_cell_is_correct(name):
    cell = toy_cell(name)
    with multiprocessing.get_context("spawn").Pool(2) as wpool:
        result = asyncio.run(run.run_cell(cell, SEED, 1.0, True, wpool, 2, device="cpu", max_sets_per_job=8))
    assert result["correct"] is True, result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert result["metrics"] == {} and result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "compared"
