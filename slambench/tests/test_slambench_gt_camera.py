"""Cell imap_rgbd_room.gt_camera on the CPU, at the reduced size of
test_slambench_run.py: a sound run is correct and the control is not (on
map_loss1); a mapper whose K1 hands back its parameter gradients at twice
their size, which leaves the forward loss and Adam's sign-driven first
step as they were, fails on map_grad_med."""

import pointnerf_slam_torch.ops.fused_vg as fused_vg
from slambench import check, registry
from slambench.tests.test_slambench_run import _run

CELL = "imap_rgbd_room.gt_camera"
_K1 = fused_vg.fused_vg_reference


def _doubled_grads(*a, **k):
    """K1 as it is, its parameter gradients doubled."""
    loss, dp, dro, drd, aux = _K1(*a, **k)
    dp = None if dp is None else {n: 2 * g for n, g in dp.items()}
    return loss, dp, dro, drd, aux


def _lines(res, name):
    return [ln for ln in res["lines"] if ln.startswith(name + " ")]


def test_sound_run_is_correct_and_control_is_not():
    res = _run(CELL, control=True)
    assert res["correct"], res["lines"]
    assert res["failed"] == 0
    limits = registry.workload(CELL)["limits"]
    ctl = {k: v for k, v in res["control_numbers"].items()
           if k != "init_gap"}
    ok, lines = check.judge(ctl, limits, require_all=False)
    assert not ok, lines
    assert any(ln.startswith("map_loss1 ") and ln.endswith("FAILED")
               for ln in lines), lines


def test_gradients_of_the_wrong_size_are_not_correct(monkeypatch):
    monkeypatch.setattr(fused_vg, "fused_vg_reference", _doubled_grads)
    res = _run(CELL)
    assert not res["correct"], res["lines"]
    grad = _lines(res, "map_grad_med")
    assert grad and grad[0].endswith("FAILED"), res["lines"]
    for name in ("map_loss1", "map_change1"):
        assert not _lines(res, name)[0].endswith("FAILED"), res["lines"]
