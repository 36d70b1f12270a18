"""Per-stage timing with EMA smoothing.

Equivalent of the reference ``TimeTable`` (RayZath/engine_parts.hpp:50-74):
named stage entries with exponentially smoothed durations (avg factor 0.05) plus a
separately tracked wait time, surfaced as a debug string.
"""
from __future__ import annotations

import time
from collections import OrderedDict

AVG_FACTOR = 0.05


class TimeTable:
    def __init__(self):
        self._entries: "OrderedDict[str, tuple[float, float]]" = OrderedDict()
        self._t0 = time.perf_counter()

    def update(self, name: str) -> float:
        """Record the time since the previous update under ``name``; returns ms."""
        now = time.perf_counter()
        dt_ms = (now - self._t0) * 1e3
        self._t0 = now
        last, avg = self._entries.get(name, (dt_ms, dt_ms))
        avg = avg + (dt_ms - avg) * AVG_FACTOR
        self._entries[name] = (dt_ms, avg)
        return dt_ms

    def set(self, name: str, dt_ms: float) -> None:
        last, avg = self._entries.get(name, (dt_ms, dt_ms))
        avg = avg + (dt_ms - avg) * AVG_FACTOR
        self._entries[name] = (dt_ms, avg)

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def entries(self):
        return {k: v for k, v in self._entries.items()}

    def __str__(self) -> str:
        width = max((len(k) for k in self._entries), default=0)
        lines = [
            f"{name:<{width}} : {last:8.3f} ms (avg {avg:8.3f} ms)"
            for name, (last, avg) in self._entries.items()
        ]
        return "\n".join(lines)
