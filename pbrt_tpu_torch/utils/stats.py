"""Render statistics (counterpart of ``pbrt_tpu/utils/stats.py``): a
process-wide counter and timer registry (the builder's ``scene/*`` and
the renderer's ``render/*`` counters)."""

from __future__ import annotations

import threading
from collections import defaultdict

_lock = threading.Lock()
_counters: dict = defaultdict(int)
_timers: dict = defaultdict(float)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


def timed_add(name: str, seconds: float) -> None:
    with _lock:
        _timers[name] += seconds


def snapshot() -> dict:
    with _lock:
        return {"counters": dict(_counters), "timers": dict(_timers)}


def reset() -> None:
    with _lock:
        _counters.clear()
        _timers.clear()


def report(out=None) -> str:
    """Human-readable stats dump (the analogue of pbrt's PrintStats)."""
    snap = snapshot()
    lines = ["Statistics:"]
    for k in sorted(snap["counters"]):
        lines.append(f"  {k:<40} {snap['counters'][k]:>15,}")
    for k in sorted(snap["timers"]):
        lines.append(f"  {k:<40} {snap['timers'][k]:>12.3f} s")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text

