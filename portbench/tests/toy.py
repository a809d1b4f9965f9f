"""Toy copies of the benchmark's cells for the CPU tests: the same mix and
code paths at a few sets, all due inside one batching window so that a
run is one or two jobs, and a judged tail of two."""
from __future__ import annotations

import copy

from portbench import manifest

GOSSIP = "gossip-300k.slots"
SYNC = "range-sync.segments"
SEED = 2**40 + 11  # larger than 32 signed bits hold


def toy_cell(name: str) -> manifest.Cell:
    cell = manifest.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["block"] = {"sets": 3, "messages": 3}
    tr = cell.traffic
    if tr["loop"] == "open":
        # scale 0.5 of this deployment: one block, one attestation and one
        # aggregate a slot (7 sets)
        cell.config.update(validators=64, max_committees_per_slot=2, target_aggregators_per_committee=1,
                           sync_committee_size=1, sync_committee_subnet_count=1,
                           target_aggregators_per_sync_subcommittee=1)
        tr.update(slot_s=1, scale=0.5)
        for kind in tr["kinds"]:
            kind["window_s"] = [0.0, 0.02]
    else:
        cell.config["slots_per_epoch"] = 2
        tr.update(fresh_segments=1, bank_segments=2)
    # the judged tail at a pool of 8 sets: two jobs of two requests, a
    # fault in the second half of the first and the first half of the second
    tr["tail"] = dict(tr["tail"], count=4, invalid=[dict(tr["tail"]["invalid"][0], at=1),
                                                    dict(tr["tail"]["invalid"][1], at=2)])
    tr["drain_s"] = 240
    tr["check"] = dict(tr["check"], sample=2)
    return cell
