"""Timers and moving averages: an accumulating timer with pause and resume,
a windowed moving average, and a per-tick FPS meter."""

from __future__ import annotations

import time
from collections import deque


class Timer:
    """Accumulating timer with pause/resume."""

    def __init__(self, name: str = "", is_verbose: bool = False):
        self.name = name
        self.is_verbose = is_verbose
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._accumulated = 0.0
        self._paused = False

    def start(self):
        self._start = time.perf_counter()
        self._paused = False

    def pause(self):
        if not self._paused:
            self._accumulated += time.perf_counter() - self._start
            self._paused = True

    def resume(self):
        if self._paused:
            self._start = time.perf_counter()
            self._paused = False

    def elapsed(self) -> float:
        e = self._accumulated
        if not self._paused:
            e += time.perf_counter() - self._start
        if self.is_verbose:
            print(f"Timer::{self.name} - elapsed: {e:.4f}s")
        return e


class MovingAverage:
    def __init__(self, window: int = 10):
        self._vals = deque(maxlen=window)

    def add(self, v: float):
        self._vals.append(v)
        return self.average()

    def average(self) -> float:
        return sum(self._vals) / len(self._vals) if self._vals else 0.0


class TimerFps(Timer):
    """Per-tick FPS with a moving average over `average_width` ticks."""

    def __init__(self, name: str = "", average_width: int = 10,
                 is_verbose: bool = False):
        super().__init__(name, is_verbose)
        self._avg = MovingAverage(average_width)
        self._last = time.perf_counter()

    def refresh(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        if dt > 0:
            self._avg.add(1.0 / dt)
        fps = self._avg.average()
        if self.is_verbose:
            print(f"TimerFps::{self.name} - fps: {fps:.2f}")
        return fps
