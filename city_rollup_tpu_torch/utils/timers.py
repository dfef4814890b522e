"""Color-coded lap timers wrapping circuit builds and prove steps.

Reference role: city_common/src/logging/{trace_timer,debug_timer}.rs
(SURVEY.md §5 Tracing/profiling) — every toolbox build and worker prove in
the reference is wrapped in one of these.

Counterpart of the reference's ``utils/timers.py``: a copy.
"""

from __future__ import annotations

import logging
import time

logger = logging.getLogger("city_rollup_tpu_torch")

_CYAN = "\x1b[36m"
_YELLOW = "\x1b[33m"
_RESET = "\x1b[0m"


class TraceTimer:
    """Named lap timer: .lap("msg") logs delta since the previous lap and
    total elapsed; .event("msg") logs without timing."""

    def __init__(self, name: str, color: str = _CYAN, enabled: bool = True):
        self.name = name
        self.color = color
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.laps: list[tuple[str, float]] = []

    def lap(self, msg: str) -> float:
        now = time.perf_counter()
        delta = now - self.last
        self.last = now
        self.laps.append((msg, delta))
        if self.enabled:
            logger.info("%s[%s]%s %s: %.3fs (total %.3fs)", self.color,
                        self.name, _RESET, msg, delta, now - self.t0)
        return delta

    def event(self, msg: str):
        if self.enabled:
            logger.info("%s[%s]%s %s", self.color, self.name, _RESET, msg)

    def total(self) -> float:
        return time.perf_counter() - self.t0


class DebugTimer(TraceTimer):
    def __init__(self, name: str, enabled: bool = True):
        super().__init__(name, color=_YELLOW, enabled=enabled)
