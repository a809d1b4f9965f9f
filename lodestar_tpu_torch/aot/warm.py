"""Capture the registered programs before a node serves.

Counterpart of the warm step of ``lodestar_tpu/aot/warm.py``:
``warm_programs(programs, device)`` captures each program's CUDA graph in
the order given (the registry's priority order) and returns one row per
program.  A capture costs about one eager run of the program, plus the
graph's instantiation.  A sharded entry (``sharded/b{B}@m{M}``) is
captured over ``sharded.default_group(M)`` after its own eager warm-up,
which runs the group's collective: every rank of the group warms it at
the same time.

Not ported, because a CUDA graph cannot outlive its process: the
persistent compile cache (``aot/cache.py``, its spy and quarantine), the
on-disk manifest with its source fingerprint, ``jax.export`` and the
``python -m lodestar_tpu.aot`` command line.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence

import torch

from lodestar_tpu_torch._device import resolve_device
from . import registry


def constant_entries() -> int:
    """Entries in the ops' per-device constant caches: the tensors a
    capture must find already made."""
    from lodestar_tpu_torch.ops.bls12_381 import fp_kernels as fpk, h2c, tower as tw, verify as dv

    caches = (fpk.limb_const, fpk._bit_tables, h2c._on, tw._gamma1_stacked, dv._neg_g1)
    return sum(f.cache_info().currsize for f in caches)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def warm_programs(programs: Sequence, device=None) -> List[Dict]:
    """Capture every program not yet captured on ``device``, in order; one
    row per program.  ``status`` is ``captured`` (here), ``warm`` (before)
    or ``eager`` (the host has nothing to capture).  A captured row gives
    the eager warm-up's seconds (None after the device's first capture),
    capture and instantiate seconds, the graph's nodes, each kernel's launches
    it holds, the growth of host RSS (and the process's RSS after it) and
    of ``torch.cuda.memory_reserved``, and the constants the warm-up
    added.  A capture that fails raises."""
    dev = resolve_device(device)
    rows: List[Dict] = []
    for prog in programs:
        row: Dict = {"key": prog.key, "note": prog.note}
        if dev.type != "cuda":
            row["status"] = "eager"
        elif registry.is_captured(prog.kernel, prog.bucket, dev, prog.mesh_size):
            row["status"] = "warm"
        else:
            torch.cuda.empty_cache()  # the capture empties it too: start level
            rss0, reserved0 = _rss_bytes(), torch.cuda.memory_reserved(dev)
            consts0 = constant_entries()
            t0 = time.perf_counter()
            graphed = registry.program(prog.kernel, prog.bucket, dev, prog.mesh_size)
            row.update(
                status="captured",
                wall_s=time.perf_counter() - t0,
                warmup_s=graphed.warmup_s,
                capture_s=graphed.capture_s,
                instantiate_s=graphed.instantiate_s,
                nodes=graphed.nodes,
                launches=dict(graphed.launches),
                host_rss_mb=(_rss_bytes() - rss0) / 2**20,
                reserved_mb=(torch.cuda.memory_reserved(dev) - reserved0) / 2**20,
                host_rss_total_mb=_rss_bytes() / 2**20,
                constants_added=constant_entries() - consts0,
            )
        rows.append(row)
    return rows
