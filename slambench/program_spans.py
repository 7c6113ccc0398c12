"""The program's own spans over the measured window, for the metrics whose
source is `program_span` and that read the program's tracer
(`pointnerf_slam_torch.utils.tracing`): each span clipped to the window
`[ctx.trace.t0, ctx.trace.t1]` (the host's clock, on which the tracer
records), with its parent and its name.

A program without the tracer, or a window in which it recorded nothing,
gives None, and each reader then returns None.
"""

from __future__ import annotations

from collections import defaultdict

WAIT = "wait."
PHASES = ("frontend", "tracker", "mapper")


class Window:
    """spans: {id: (name, parent, clipped seconds, syncs)} of the spans
    that overlap the window; children: {parent id: [ids]}."""

    def __init__(self, raw: list, t0: float, t1: float):
        lo, hi = int(t0 * 1e9), int(t1 * 1e9)
        self.spans, self.children = {}, defaultdict(list)
        for name, sid, parent, _frame, a, b, syncs in raw:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                self.spans[sid] = (name, parent, (b - a) / 1e9, syncs)
                self.children[parent].append(sid)

    def named(self, pred) -> list:
        return [s for s, v in self.spans.items() if pred(v[0])]

    def count(self, pred) -> int:
        return len(self.named(pred))

    def syncs(self, pred) -> int:
        """The blocking transfers the spans named by pred hold."""
        return sum(self.spans[s][3] for s in self.named(pred))

    def seconds(self, pred) -> float:
        """Summed clipped seconds of the spans whose name meets pred."""
        return sum(self.spans[s][2] for s in self.named(pred))

    def outside(self, pred, leave_out) -> float:
        """Seconds in the spans named by pred that no descendant named by
        leave_out covers (the highest such descendant counts)."""
        total = 0.0
        for s in self.named(pred):
            total += self.spans[s][2] - self._covered(s, leave_out)
        return total

    def _covered(self, sid, leave_out) -> float:
        out = 0.0
        for c in self.children.get(sid, ()):
            name, _, sec, _ = self.spans[c]
            out += sec if leave_out(name) else self._covered(c, leave_out)
        return out


def window(ctx):
    """The program's spans over ctx's window, or None."""
    try:
        from pointnerf_slam_torch.utils.tracing import TRACER
    except ImportError:
        return None
    tr = getattr(ctx, "trace", None)
    if tr is None or tr.t1 <= tr.t0:
        return None
    w = Window(list(TRACER.spans), tr.t0, tr.t1)
    return w if w.spans else None


def is_wait(name: str) -> bool:
    return name.startswith(WAIT)


def host_ms_per(ctx, name: str, per: float):
    """Host milliseconds in spans `name` outside their waits, over per."""
    w = window(ctx)
    if w is None or not per or not w.count(lambda n: n == name):
        return None
    return w.outside(lambda n: n == name, is_wait) / per * 1e3
