"""The program's tracer: host spans and kernel launch counters, one per
process (`TRACER`), so that a reader can reach them after a run.

A span is a named host interval kept as the tuple (name, id, parent id,
frame, start ns, end ns, syncs). Times are `time.time_ns()`, the clock that
torch.profiler's Chrome trace is based on (its `baseTimeNanoseconds`), so
an idle gap in the device trace can be put down to the span that was open
on the host. The parent is the span that was open when it started; every
span of one `PointNeRFSLAM.step` carries that step's frame index (-1
outside a step). Spans are kept in memory (`TRACER.spans`) and written
out only by `write_chrome_trace`.

Recording. Spans are recorded only while a torch.profiler session is
active in the process, or while a caller has switched recording on
(`record()`, for tests). Otherwise a span site costs a flag check,
except for the two kinds that time themselves always:

  phase(name)   the system's phases (frontend, tracker, mapper); on exit
                `self_ns` is the phase's host time without the waits
                inside it and `wait_ns` those waits;
  wait(site)    the host blocked on the card: one blocking device-to-host
                read or pageable host-to-device copy, or one call that
                makes `syncs` of them (a card SVD reads its status
                twice). Spans are named `wait.<site>` and carry `syncs`
                (0 on every other span); every wait adds to
                `TRACER.wait_ns`.

`frame(idx)` is the root span `step` of one frame, timed always too, so
the system can log the frame's waits.

Counters (`TRACER.counters`): kernel launches by wrapper, counted
always; ops/fused_vg.py's `launches` is the same dict. Spans and
counters come from the thread that runs the system.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from torch.autograd import profiler as _profiler

WAIT = "wait."


class Tracer:
    def __init__(self):
        self.forced = False     # recording switched on by a caller
        self.spans = []         # (name, id, parent, frame, t0, t1, syncs)
        self.counters = {}      # kernel launches by wrapper
        self.frame = -1         # the frame index of the open step
        self.wait_ns = 0        # every wait's host ns, recorded or not
        self._stack = []        # (id, name) of the open recorded spans
        self._next = 0

    @property
    def recording(self) -> bool:
        return self.forced or _profiler._is_profiler_enabled


TRACER = Tracer()


class _Span:
    """One span site's interval; recorded when the tracer records at its
    start, timed always (the tracer's own `wait_ns` moves with the wait
    spans, those with syncs)."""

    __slots__ = ("name", "syncs", "id", "parent", "t0", "w0", "self_ns",
                 "wait_ns")

    def __init__(self, name: str, syncs: int = 0):
        self.name = name
        self.syncs = syncs

    def __enter__(self):
        T = TRACER
        self.id = 0
        if T.forced or _profiler._is_profiler_enabled:
            T._next += 1
            self.id = T._next
            self.parent = T._stack[-1][0] if T._stack else 0
            T._stack.append((self.id, self.name))
        self.w0 = T.wait_ns
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        T = TRACER
        dur = t1 - self.t0
        if self.syncs:
            T.wait_ns += dur
        self.wait_ns = T.wait_ns - self.w0
        self.self_ns = dur - self.wait_ns
        if self.id:
            T._stack.pop()
            T.spans.append((self.name, self.id, self.parent, T.frame,
                            self.t0, t1, self.syncs))
        return False


class _Step(_Span):
    __slots__ = ("idx", "outer")

    def __init__(self, idx: int):
        super().__init__("step")
        self.idx = idx

    def __enter__(self):
        self.outer, TRACER.frame = TRACER.frame, self.idx
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        TRACER.frame = self.outer
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span recorded only while the tracer records."""
    if TRACER.forced or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def phase(name: str) -> _Span:
    return _Span(name)


def wait(site: str, syncs: int = 1) -> _Span:
    return _Span(WAIT + site, syncs)


def frame(idx: int) -> _Step:
    return _Step(int(idx))


def count(name: str) -> None:
    """One more of counter `name`."""
    TRACER.counters[name] += 1


def record(on: bool = True) -> bool:
    """Switches recording on (or off) whatever the profiler does; returns
    the setting it replaces."""
    before, TRACER.forced = TRACER.forced, bool(on)
    return before


def write_chrome_trace(path: str, spans=None) -> str:
    """The spans (default every recorded one) as one Chrome-trace JSON
    file: complete events on the host's clock, `ts` in microseconds after
    `baseTimeNanoseconds` as in torch.profiler's trace, so both lie on one
    timeline. Returns the path."""
    spans = TRACER.spans if spans is None else spans
    base = min((s[4] for s in spans), default=0)
    pid = os.getpid()
    events = [{"name": name, "ph": "X", "cat": "program_span",
               "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
               "pid": pid, "tid": pid,
               "args": {"id": sid, "parent": parent, "frame": frame,
                        "syncs": syncs}}
              for name, sid, parent, frame, t0, t1, syncs in spans]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base,
                   "displayTimeUnit": "ms"}, fh)
    return path
