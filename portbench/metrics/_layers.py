"""What the per-layer readers share: the traced run's context and the
arithmetic over its spans and its profiled replay.

A reader (``metrics/<name>.py``) is ``read(ctx) -> float | None``; it
returns None where it finds nothing to read, and the harness then leaves
the metric out of the line.  ``ctx`` is a ``TraceContext``:

- ``window_s``: the measured window's length;
- ``spans``: ``spans.SpanBackend.finish`` records (``kind`` encode,
  execute or each; ``t0``/``t1`` in seconds after the window opened;
  ``n`` real sets; ``bucket``; ``device_s`` for device calls);
- ``profile``: one replay of the ``hashed`` program profiled after the
  window (``key``, ``kernels`` as (name, launches, device seconds),
  ``captured_sizes`` of K1-K3 per replay), or None;
- ``warm_rows``: the pool's warm rows (``aot/warm.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

HAND_WRITTEN = ("mont_mul", "f2_mul", "f2_sqr")


@dataclass
class TraceContext:
    window_s: float
    spans: List[dict] = field(default_factory=list)
    profile: Optional[dict] = None
    warm_rows: List[dict] = field(default_factory=list)

    def in_window(self, kind: str) -> List[dict]:
        """Spans of ``kind`` that started inside the window."""
        return [s for s in self.spans if s["kind"] == kind and 0 <= s["t0"] < self.window_s]


def _mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def sets_per_job(ctx: TraceContext) -> Optional[float]:
    return _mean([s["n"] for s in ctx.in_window("encode")])


def encode_ms_per_job(ctx: TraceContext) -> Optional[float]:
    return _mean([1e3 * (s["t1"] - s["t0"]) for s in ctx.in_window("encode")])


def replay_ms(ctx: TraceContext) -> Optional[float]:
    return _mean([1e3 * s["device_s"] for s in ctx.in_window("execute") if "device_s" in s])


def device_intervals(ctx: TraceContext) -> List[tuple]:
    """(start, end) on the host's clock of the card's work in each device
    call: its event time, ending where the call returned (each call ends
    in a sync with the card)."""
    out = []
    for s in ctx.spans:
        if s["kind"] in ("execute", "each") and "device_s" in s:
            out.append((max(s["t0"], s["t1"] - s["device_s"]), s["t1"]))
    return sorted(out)


def idle_pct(ctx: TraceContext) -> Optional[float]:
    intervals = device_intervals(ctx)
    if not intervals:
        return None
    busy = sum(max(0.0, min(b, ctx.window_s) - max(a, 0.0)) for a, b in intervals)
    return 100.0 * (1.0 - busy / ctx.window_s)


def kernel_device_s(ctx: TraceContext, kernel: str) -> float:
    return sum(t for name, _, t in ctx.profile["kernels"] if f"{kernel}_kernel" in name)


def kernel_roofline_pct(ctx: TraceContext, kernel: str, bound_us: Callable[[int], float]) -> Optional[float]:
    """The profiled replay's least time for ``kernel`` (``bound_us(n)`` at
    each launch size the replayed graph holds) over the kernel's device
    time in that replay."""
    if not ctx.profile:
        return None
    sizes = ctx.profile["captured_sizes"].get(kernel) or {}
    spent = kernel_device_s(ctx, kernel)
    if not sizes or spent <= 0:
        return None
    least_us = sum(count * bound_us(int(n)) for n, count in sizes.items())
    return 100.0 * least_us / (spent * 1e6)


def elementwise_ms(ctx: TraceContext) -> Optional[float]:
    """Card time per replay of every kernel but the hand-written ones."""
    if not ctx.profile:
        return None
    total = sum(t for _, _, t in ctx.profile["kernels"])
    ours = sum(kernel_device_s(ctx, k) for k in HAND_WRITTEN)
    return 1e3 * (total - ours)


def warm_sum(ctx: TraceContext, key: str) -> Optional[float]:
    values = [row[key] for row in ctx.warm_rows if row.get(key) is not None]
    return float(sum(values)) if values else None
