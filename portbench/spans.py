"""Spans around the pool's calls into the program, from the benchmark's own
files (traced runs only).

``SpanBackend`` wraps ``lodestar_tpu_torch.ops.bls12_381.verify`` and is
handed to ``DeviceBlsVerifier(_backend=...)``.  It forwards the four calls
the pool makes and records, for each:

- ``encode_job``: the host clock around it and the real sets in the job;
- ``execute_batch`` and ``verify_each_device``: the host clock around it
  and a pair of ``torch.cuda.Event``s recorded on the calling thread's
  current stream (the executor thread's, where the pool runs them) before
  and after, so the card's own time is read once the window has closed.

Spans are kept in memory; ``finish`` turns them into plain records with
times in seconds after ``origin`` (the window's opening, on the host's
monotonic clock).
"""
from __future__ import annotations

import threading
import time
from typing import List


class SpanBackend:
    def __init__(self, backend, torch_module, timed_device: bool = True):
        self._dv = backend
        self._torch = torch_module
        self._timed = timed_device
        self._lock = threading.Lock()
        self._spans: List[dict] = []

    def _add(self, span: dict) -> None:
        with self._lock:
            self._spans.append(span)

    def warm_programs(self, programs, device=None):
        return self._dv.warm_programs(programs, device)

    def encode_job(self, sets, rand=None, bucket=None, device=None):
        t0 = time.monotonic()
        job = self._dv.encode_job(sets, rand=rand, bucket=bucket, device=device)
        self._add({"kind": "encode", "t0": t0, "t1": time.monotonic(), "n": len(sets), "bucket": bucket})
        return job

    def _device_call(self, kind: str, n: int, width, fn, *args, **kwargs):
        events = None
        if self._timed:
            events = (self._torch.cuda.Event(enable_timing=True), self._torch.cuda.Event(enable_timing=True))
        t0 = time.monotonic()
        if events:
            events[0].record()
        try:
            return fn(*args, **kwargs)
        finally:
            if events:
                events[1].record()
            self._add({"kind": kind, "t0": t0, "t1": time.monotonic(), "n": n, "bucket": width,
                       "events": events})

    def execute_batch(self, job):
        return self._device_call("execute", job.n, job.bucket, self._dv.execute_batch, job)

    def verify_each_device(self, sets, bucket=None, device=None):
        return self._device_call("each", len(sets), bucket, self._dv.verify_each_device,
                                 sets, bucket=bucket, device=device)

    def finish(self, origin: float) -> List[dict]:
        """Every span, its times after ``origin`` and, for a device call,
        ``device_s`` from its events (the card is synchronized first)."""
        if self._timed:
            self._torch.cuda.synchronize()
        out = []
        with self._lock:
            spans = list(self._spans)
        for s in spans:
            rec = {k: v for k, v in s.items() if k != "events"}
            rec["t0"] -= origin
            rec["t1"] -= origin
            if s.get("events"):
                rec["device_s"] = s["events"][0].elapsed_time(s["events"][1]) / 1e3
            out.append(rec)
        return out
