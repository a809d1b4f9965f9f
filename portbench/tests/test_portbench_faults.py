"""The comparison that decides ``correct`` fails what it must.

A run is driven as the benchmark drives it, past the look for a card,
with the timed path underneath replaced by a stand-in of the program's
verify module: the port's host oracle, sound or with a planted fault.
Each fault the cells can have comes out not correct: a step that leaves
its state unchanged (every batch accepted as it started), half of a job's
sets left out (the first half kept, or the second), and an answer altered
where it is produced.  A cell on one card has no exchange between cards
to leave out.  The control, the reference with every coefficient 1 in the
program's place, comes out not correct on the same sample.

The half-batch fault is shown twice: at toy scale through a whole run,
and at each cell's own packing (its pool of 2,048 sets and its tail as
the traffic file has it), with a stand-in that knows which sets the
traffic planted."""
import asyncio
import multiprocessing

import pytest

from portbench import check, gen, manifest, run
from portbench.tests.toy import GOSSIP, SEED, SYNC, toy_cell


class Job:
    def __init__(self, sets, bucket):
        self.sets, self.n, self.bucket, self.kind = list(sets), len(sets), bucket, "hashed"


class Oracle:
    """The program's verify module, stood in for by the port's oracle;
    ``fault`` plants one fault in the batch step."""

    def __init__(self, fault=""):
        from lodestar_tpu_torch.crypto.bls import api

        self.api, self.fault = api, fault

    def encode_job(self, sets, rand=None, bucket=None, device=None):
        return Job(sets, bucket)

    def execute_batch(self, job):
        sets = job.sets
        if self.fault == "unchanged":
            return True
        if self.fault == "half":
            sets = sets[: max(1, len(sets) // 2)]
        elif self.fault == "second_half":
            sets = sets[len(sets) // 2 :]
        ok = self.api.verify_multiple_signature_sets(sets)
        return (not ok) if self.fault == "altered" else ok

    def verify_each_device(self, sets, bucket=None, device=None):
        verdicts = [self.api.verify_signature_set(s) for s in sets]
        return [not v for v in verdicts] if self.fault == "altered" else verdicts


def _run(name, fault):
    cell = toy_cell(name)
    with multiprocessing.get_context("spawn").Pool(2) as wpool:
        return asyncio.run(run.run_cell(cell, SEED, 1.0, False, wpool, 2, device="cpu",
                                        max_sets_per_job=8, backend=Oracle(fault)))


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
def test_the_sound_stand_in_is_correct(name):
    assert _run(name, "")["correct"] is True


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
@pytest.mark.parametrize("fault", ["unchanged", "half", "second_half", "altered"])
def test_each_fault_comes_out_not_correct(name, fault):
    result = _run(name, fault)
    assert result["correct"] is False
    assert result["compared"]["mismatched"]["value"] > 0


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
def test_the_control_comes_out_not_correct(name):
    cell = toy_cell(name)

    async def go(wpool):
        from lodestar_tpu_torch.chain.bls.device_pool import DeviceBlsVerifier

        pool = DeviceBlsVerifier(_backend=Oracle(), device="cpu", max_sets_per_job=8)
        traffic = run.make_traffic(cell, SEED, 1.0, wpool, 2)
        out = await run.drive_window(pool, cell, traffic, 1.0)
        tail = await run.drive_tail(pool, traffic, cell.traffic["drain_s"])
        await pool.close()
        cfg = cell.traffic["check"]
        judged = check.Judged(SEED, cfg["chunk"], control=True)
        judged.submit(wpool, traffic, check.pick_window(traffic, out, SEED, cfg))
        judged.submit(wpool, traffic, check.pick_tail(traffic, tail, SEED, cfg))
        return check.collect(judged), check.collect(judged, "control")

    with multiprocessing.get_context("spawn").Pool(2) as wpool:
        program, control = asyncio.run(go(wpool))
    assert check.correct(program) and not check.correct(control)


class Flag:
    """A set that knows whether the traffic planted it invalid."""

    def __init__(self, valid):
        self.valid = valid


class Planted:
    """The verify module stood in for by what the traffic planted: a batch
    is valid when every set it reads is; ``keep`` leaves out half of it."""

    def __init__(self, keep=""):
        self.keep, self.widths = keep, []

    def encode_job(self, sets, rand=None, bucket=None, device=None):
        self.widths.append(bucket)
        return Job(sets, bucket)

    def execute_batch(self, job):
        half = len(job.sets) // 2
        sets = {"first": job.sets[:half], "second": job.sets[half:]}.get(self.keep, job.sets)
        return all(s.valid for s in sets)

    def verify_each_device(self, sets, bucket=None, device=None):
        return [s.valid for s in sets]


def _tail_at_the_cells_packing(name, keep):
    """The cell's judged tail through a pool of the cell's own size, with
    the planted sets marked; the tail's verdicts and the truth."""
    from lodestar_tpu_torch.chain.bls.device_pool import DeviceBlsVerifier

    cell = manifest.load_cell(name)
    plan = gen.make_plan(cell.config, cell.traffic, SEED, 24)
    port_sets, truth = [None] * len(plan.requests), {}
    for i, req in enumerate(plan.requests):
        if req.tail:
            bad = {k for k, sid in enumerate(req.set_ids)
                   if k in (req.swap or ()) or plan.sets[sid][2] == "wrong_key"}
            port_sets[i] = [Flag(k not in bad) for k in range(len(req.set_ids))]
            truth[i] = not bad
    backend = Planted(keep)
    traffic = run.Traffic(plan, None, port_sets, 0.0)

    async def go():
        pool = DeviceBlsVerifier(_backend=backend, device="cpu",
                                 max_sets_per_job=cell.config["pool"]["max_sets_per_job"])
        tail = await run.drive_tail(pool, traffic, cell.traffic["drain_s"])
        await pool.close()
        return tail

    tail = asyncio.run(go())
    return [tail.verdict[k] for k in range(len(tail.index))], [truth[i] for i in tail.index], backend.widths


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
def test_the_tail_packs_into_both_of_the_pools_widths(name):
    got, truth, widths = _tail_at_the_cells_packing(name, "")
    assert got == truth and truth.count(False) == 2
    assert widths[0] == 2048 and set(widths[1:]) == {128}


@pytest.mark.parametrize("name", [GOSSIP, SYNC])
@pytest.mark.parametrize("keep", ["first", "second"])
def test_a_half_batch_fault_shows_at_the_cells_own_packing(name, keep):
    got, truth, _ = _tail_at_the_cells_packing(name, keep)
    assert any(g is True and t is False for g, t in zip(got, truth))
