"""Whole runs of the harness on the CPU, at a reduced size: without a card
the command stops with a message; with the look for a card skipped, a
sound run comes out correct, a run with the timed path broken underneath
does not, and neither does the control (the reference in the next
precision down, put in the program's place)."""

import os
import subprocess
import sys

import pytest
import torch
import torch.optim.adam as adam_mod

import pointnerf_slam_torch.engine.system as system_mod
import pointnerf_slam_torch.frontend.frontend as frontend_mod
import pointnerf_slam_torch.ops.fused_vg as fused_vg
from slambench import check, registry
from slambench.run import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# a quarter of the frame each way (the front-end still bootstraps), a
# sixteenth of the rays, and a few more iterations a call than the check
# follows
SMALL = {"cam": {"H": 170, "W": 300, "fx": 150.0, "fy": 150.0, "cx": 149.5,
                 "cy": 84.5},
         "mapping": {"pixels": 312, "iters": 12, "iters_first": 12},
         "tracking": {"pixels": 312, "iters": 6, "resample_every": 3}}
SEED = 2_600_000_011
# weak depth: within three cycles a tracked frame's parallax gives a
# pseudo-depth at this size and seed (one cycle gives none)
CYCLES = {"pointnerf_weak_room.orbit": 3}


def _run(cell, **kw):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(
        os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
    return run(cell, SEED, 0.0, False, device="cpu", cfg_over=SMALL,
               min_cycles=CYCLES.get(cell, 1), **kw)


def test_without_a_card_the_command_stops():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run(
        [sys.executable, "-m", "slambench", "--workload",
         "imap_rgbd_room.orbit", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.parametrize("cell", ["imap_rgbd_room.orbit",
                                  "pointnerf_weak_room.orbit"])
def test_sound_run_is_correct_and_control_is_not(cell):
    res = _run(cell, control=True)
    assert res["correct"], res["lines"]
    assert res["failed"] == 0
    assert res["attempted"] == 5 * CYCLES.get(cell, 1)
    assert set(res["metrics"]) == {"device_ms_per_frame", "setup_s"}
    # the control is judged on what it computes: without the initial
    # decoder, which it rounds whatever its products read
    limits = registry.workload(cell)["limits"]
    ctl = {k: v for k, v in res["control_numbers"].items()
           if k != "init_gap"}
    ok, lines = check.judge(ctl, limits, require_all=False)
    assert not ok, lines
    assert any(ln.startswith("map_loss1 ") and ln.endswith("FAILED")
               for ln in lines), lines


def _noop_adam(*a, **k):
    """Adam's update, left out: every step returns its state unchanged."""
    return None


def _half_batch(spec, params, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, z2,
                bound):
    """K1's loss over the first half of the rays, doubled."""
    h = rays_o.shape[0] // 2
    loss, dp, dro, drd, aux = _K1(spec, params, rays_o[:h], rays_d[:h],
                                  gt_d[:h], gt_c[:h], ray_w[:h],
                                  None if t_reg is None else t_reg[:h],
                                  z2[:h], bound)
    pad = torch.zeros_like(rays_o[h:])
    dp = None if dp is None else {k: 2 * v for k, v in dp.items()}
    return (2 * loss, dp, torch.cat([2 * dro, pad]),
            torch.cat([2 * drd, pad]), aux)


_K1 = fused_vg.fused_vg_reference
_TRACK = system_mod.make_tracking_step
_SPLAT = frontend_mod.splat_pseudo_depth


def _moved_pose(*a, **k):
    step = _TRACK(*a, **k)

    def track(*args, **kw):
        best, best_loss, first, losses = step(*args, **kw)
        return best + 1e-3, best_loss, first, losses
    return track


def _moved_depth(*a, **k):
    return _SPLAT(*a, **k) * 1.01


FAULTS = {
    "state_unchanged": (adam_mod, "adam", _noop_adam),
    "half_batch": (fused_vg, "fused_vg_reference", _half_batch),
    "pose_altered": (system_mod, "make_tracking_step", _moved_pose),
    "pseudo_depth_altered": (frontend_mod, "splat_pseudo_depth",
                             _moved_depth),
}
# the faults each cell can have: no front-end with sensor depth; one
# card, so no exchange between cards
CELL_FAULTS = [
    ("imap_rgbd_room.orbit", "state_unchanged"),
    ("imap_rgbd_room.orbit", "half_batch"),
    ("imap_rgbd_room.orbit", "pose_altered"),
    ("pointnerf_weak_room.orbit", "state_unchanged"),
    ("pointnerf_weak_room.orbit", "half_batch"),
    ("pointnerf_weak_room.orbit", "pose_altered"),
    ("pointnerf_weak_room.orbit", "pseudo_depth_altered"),
]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    obj, attr, fn = FAULTS[fault]
    monkeypatch.setattr(obj, attr, fn)
    res = _run(cell)
    assert not res["correct"], res["lines"]
