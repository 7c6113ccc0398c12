"""The port's tracer (pointnerf_slam_torch/utils/tracing.py) on the CPU.

(a) Recording follows torch.profiler and the caller's switch: on inside a
    profiler session and after `record(True)`, off outside, where no span
    is recorded but the phases' and waits' totals still accrue; the
    launch counters count always, and a wait span carries its syncs.
(b) The spans share torch.profiler's clock: a span around a CPU torch op
    contains that op's event as slambench.trace.Trace places it.
(c) A traced one-cycle run of each benchmark cell at a reduced size (the
    harness's own, slambench/tests/test_slambench_run.py's SMALL) is
    correct and
    reports every program-span metric BENCHMARK.json lists for the cell,
    finite and positive; the step spans' named children cover at least
    90% of their time.
(d) Tracing changes no draw: a run recording from its first frame and a
    warm-up whose tracer never records give, at one seed, bit-equal
    mapping losses.
"""

import math
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import slambench.run as bench_run
from pointnerf_slam_torch.utils import tracing
from slambench import registry
from slambench.frames import FrameSource
from slambench.tests.test_slambench_run import SEED, SMALL
from slambench.trace import CPU_CATS, Trace
from tests.torch_threads import share_cores

share_cores()

NEW_METRICS = ("map_host_iter_ms", "track_host_iter_ms", "frontend_host_ms",
               "vg_host_ms", "host_wait_ms_per_frame",
               "host_syncs_per_frame", "step_host_ms")
CELLS = ("imap_rgbd_room.orbit", "pointnerf_weak_room.orbit",
         "imap_rgbd_room.gt_camera")


def _touch(name):
    """One recorded-only span, one phase, one wait of two syncs and one
    counter."""
    tracing.TRACER.counters.setdefault(name, 0)
    with tracing.span(name):
        pass
    with tracing.phase(name + ".phase") as ph:
        with tracing.wait(name, syncs=2):
            time.sleep(0.002)
    tracing.count(name)
    return ph


def test_recording_follows_the_profiler_and_the_switch():
    T = tracing.TRACER
    assert not T.recording
    n0, w0 = len(T.spans), T.wait_ns
    ph = _touch("off")
    assert len(T.spans) == n0 and T.counters["off"] == 1
    assert T.wait_ns - w0 >= 2e6 and ph.wait_ns >= 2e6
    assert 0 <= ph.self_ns < ph.wait_ns

    with profile(activities=[ProfilerActivity.CPU]):
        assert T.recording
        _touch("prof")
    assert not T.recording
    names = [s[0] for s in T.spans[n0:]]
    assert names == ["prof", "wait.prof", "prof.phase"]
    assert T.counters["prof"] == 1
    wait, outer = T.spans[n0 + 1], T.spans[n0 + 2]
    assert wait[2] == outer[1]                  # the wait's parent
    assert wait[6] == 2 and outer[6] == 0       # syncs on waits alone
    assert outer[4] <= wait[4] <= wait[5] <= outer[5]

    before = tracing.record(True)
    try:
        assert T.recording
        with tracing.frame(7):
            _touch("on")
    finally:
        tracing.record(before)
    assert not T.recording
    new = T.spans[n0 + 3:]
    assert [s[0] for s in new] == ["on", "wait.on", "on.phase", "step"]
    assert {s[3] for s in new} == {7} and T.counters["on"] == 1
    assert T.frame == -1


def test_a_span_contains_its_torch_op_on_the_profilers_clock():
    a = torch.randn(384, 384)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w0 = time.time_ns() / 1e9
        with tracing.span("matmul"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
        w1 = time.time_ns() / 1e9
    span = tracing.TRACER.spans[-1]
    assert span[0] == "matmul"
    tr = Trace.from_profiler(prof, (w0, w1), [], CPU_CATS)
    mm = [(t0, t1) for t0, t1, _, name in tr.gpu if name == "aten::mm"]
    assert len(mm) == 1
    t0, t1 = mm[0]
    assert span[4] / 1e9 <= t0 <= t1 <= span[5] / 1e9


@pytest.fixture
def session_jax(monkeypatch):
    """The harness refuses a process that has loaded JAX; here the test
    session's conftest has, so only what a run itself loads counts."""
    loaded = set(bench_run.forbidden_modules())
    forbidden = bench_run.forbidden_modules
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: [
        m for m in forbidden() if m not in loaded])


def _frames(cell):
    _, cfg, traffic = bench_run.cell_parts(cell, cfg_over=SMALL)
    return FrameSource(traffic["sequence"], cfg["cam"], cfg["scale"],
                       traffic["render_frames"], "cpu")


def _map_losses(slam) -> dict:
    return {r["idx"]: r["map_losses"] for r in slam.frame_log
            if "map_losses" in r}


def _child_cover(spans) -> float:
    """Share of the step spans' time their direct children cover."""
    kids = {}
    for name, sid, parent, _, t0, t1, _ in spans:
        kids[parent] = kids.get(parent, 0) + t1 - t0
    steps = [(sid, t1 - t0) for name, sid, _, _, t0, t1, _ in spans
             if name == "step"]
    return sum(kids.get(sid, 0) for sid, _ in steps) / sum(
        d for _, d in steps)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_span_metrics(cell, session_jax,
                                                     monkeypatch):
    frames = _frames(cell)
    follow = cell == "imap_rgbd_room.orbit"
    runs = []
    tally = bench_run.window_tally
    monkeypatch.setattr(bench_run, "window_tally", lambda slam, *a: (
        runs.append(_map_losses(slam)), tally(slam, *a))[1])
    n0 = len(tracing.TRACER.spans)
    before = tracing.record(follow)     # recording from the first frame
    try:
        res = bench_run.run(cell, SEED, 0.0, True, device="cpu",
                            cfg_over=SMALL, frames=frames)
    finally:
        tracing.record(before)
    assert res["correct"], res["lines"]
    assert res["failed"] == 0
    listed = [m for m in registry.cell_metrics(cell, True)
              if m in NEW_METRICS]
    assert listed and "map_host_iter_ms" in listed
    for name in listed:
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
    spans = tracing.TRACER.spans[n0:]
    assert _child_cover(spans) >= 0.9
    if follow:
        # the warm-up again at the same seed with the tracer never
        # recording: the same draws, the same losses
        n1 = len(tracing.TRACER.spans)
        monkeypatch.setattr(tracing, "_profiler", SimpleNamespace(
            _is_profiler_enabled=False))
        slam, rec = bench_run.build_cell(cell, SEED, "cpu", cfg_over=SMALL,
                                         frames=frames)[4:6]
        rec.want_map = True
        try:
            for idx in range(res["win"]["first"]):
                bench_run._frame(slam, rec, frames, idx)
        finally:
            rec.uninstall()
        assert len(tracing.TRACER.spans) == n1
        untraced = _map_losses(slam)
        assert len(untraced) >= 2
        for idx, ls in untraced.items():
            assert torch.equal(ls, runs[0][idx]), idx
