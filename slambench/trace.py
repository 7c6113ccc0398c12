"""The measured window, traced: torch.profiler's CUDA activity over the
whole window of every run, read back from its Chrome trace.

Only the device's activity is traced (CUPTI; host operators are not
recorded, which slowed the host-bound loop about twice over). GPU
activity is every kernel, copy and fill on the device; busy time is the
union of their intervals inside the window, whose bounds and the host's
phase ranges the harness takes on the wall clock, the trace's own time
base. Idle gaps are put down to the host range the gap's middle falls in
(reader, frontend, tracker, mapper; `other` outside them). On the CPU,
for the harness's own tests, the host's operators stand in for the
device's activity.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATS = ("cpu_op",)


def cats(device) -> tuple:
    """The trace categories that count as the device's activity."""
    return GPU_CATS if torch.device(device).type == "cuda" else CPU_CATS


def profiler(device):
    """The device's activity (CUDA); on the CPU, for the harness's own
    tests, the host's operators stand in."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[
        ProfilerActivity.CUDA if torch.device(device).type == "cuda"
        else ProfilerActivity.CPU])


def warm_profiler(device):
    """Start and stop the tracer once around a small operation, so that
    its first start (loading CUPTI) falls in set-up, not in the window."""
    with profiler(device):
        torch.ones(8, device=device).add_(1.0)
        synchronize(device)


class Trace:
    """events: Chrome-trace events, `ts` in us after base_ns; window (t0,
    t1) and spans [(name, t0, t1)] in wall-clock seconds."""

    def __init__(self, events: list, base_ns: float, window: tuple,
                 spans: list, cats: tuple = GPU_CATS):
        gpu = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            if cat in cats:
                t0 = base_ns / 1e9 + float(e["ts"]) / 1e6
                gpu.append((t0, t0 + float(e["dur"]) / 1e6, cat,
                            e.get("name", "")))
        self.t0, self.t1 = window
        self.gpu = sorted((max(a, self.t0), min(b, self.t1), c, n)
                          for a, b, c, n in gpu if b > self.t0 and a < self.t1)
        self.spans = [(a, b, name) for name, a, b in spans]
        self.busy = self._merge()

    @classmethod
    def from_profiler(cls, prof, window: tuple, spans: list,
                      cats: tuple = GPU_CATS) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        finally:
            os.remove(path)
        return cls(data["traceEvents"], float(data.get(
            "baseTimeNanoseconds", 0)), window, spans, cats)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _merge(self) -> list:
        out = []
        for a, b, _, _ in self.gpu:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def kernel_seconds(self, patterns: list) -> float:
        """Summed duration of the kernels whose name matches a pattern."""
        return sum(b - a for a, b, c, n in self.gpu
                   if c == "kernel" and any(p.search(n) for p in patterns))

    def top_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for a, b, _, name in self.gpu:
            tot[name] += b - a
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_span(self, n: int = 10) -> list:
        """Idle seconds inside the window, by the host range the gap's
        middle falls in (the harness's ranges do not nest)."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        spans = sorted(self.spans)
        starts = [s[0] for s in spans]
        tot = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            k = bisect.bisect_right(starts, mid) - 1
            name = spans[k][2] if k >= 0 and spans[k][1] >= mid else "other"
            tot[name] += b - a
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
