"""Scoped wall-clock timer (samgraph/common/timer.h analog)."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def passed(self) -> float:
        """Seconds since construction / last reset (Timer::Passed)."""
        return time.perf_counter() - self._start

    def passed_micro(self) -> float:
        return self.passed() * 1e6

    @staticmethod
    def now_us() -> float:
        """Monotonic microseconds (TimePointMicro analog)."""
        return time.perf_counter() * 1e6
