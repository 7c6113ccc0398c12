"""The slice as a whole: the port's PointNeRFSLAM in weak-depth (RGB-only)
mode on the CPU, with tests/test_weak_pipeline.py's `weak_cfg` (120x160,
16 frames of the box room, bootstrap at frame 5), held to what that test
asserts of the JAX run. The decoder is the flagship's 256-wide, 4-block
MLP (the port's engine runs only the kernels' decoder; weak_cfg's 32-wide
one is refused) and the mapping budget is cut for the CPU (iters_first
60, 24 iterations per mapped frame). The JAX weak run itself is not
repeated here (it costs minutes; tests/weak_runs.py).

A second case runs box_ba_dynamic's options (tracking.handle_dynamic and
mapping.BA) for a few frames and checks that the tracker took the
megakernel pair (K3/K4) and the mapper bundle adjustment."""

from functools import lru_cache

import numpy as np
import torch

from pointnerf_slam_torch.engine.system import PointNeRFSLAM
from tests.test_weak_pipeline import weak_cfg
from tests.torch_threads import share_cores

share_cores()


def port_weak_cfg(**tracking):
    cfg = weak_cfg()
    cfg["model"].update(hidden_size=256, n_blocks=4)
    cfg["mapping"].update(iters_first=60, iters=24)
    cfg["tracking"].update(tracking)
    cfg["data"]["frame_cache_dir"] = ""
    return cfg


@lru_cache(maxsize=None)
def weak_run():
    slam = PointNeRFSLAM(port_weak_cfg(), device="cpu")
    est, gt = slam.run()
    return slam, est, gt


def rel_err(slam, i):
    p = slam.pseudo_depths[i].numpy()
    _, _, d, _ = slam.frame_reader[i]
    m = p > 0.01
    return int(m.sum()), float(np.median(np.abs(p[m] - d[m]) / d[m]))


def test_weak_run_meets_the_reference_assertions():
    slam, est, gt = weak_run()
    assert 0 in slam.pseudo_depths and 5 in slam.pseudo_depths
    n5, r5 = rel_err(slam, 5)
    assert n5 > 50 and r5 < 0.15, (n5, r5)
    n0, r0 = rel_err(slam, 0)
    assert r0 < 0.15, (n0, r0)
    for i in slam.pseudo_depths:
        n, r = rel_err(slam, i)
        if n:
            assert r < 0.2, (i, r)
    assert np.isfinite(est).all()
    ate = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert ate.max() < 1.0, ate
    assert ate[5] < 0.2, ate[5]
    assert len(slam.keyframes) >= 3
    assert slam.timings["frontend"] > 0


def test_weak_run_schedule():
    """Bootstrap at frame 5, then continuous tracked frames 10 and 15 with
    the NeRF tracker; mapping starts after the bootstrap with iters_first;
    the keyframes' pseudo-depth slots hold the splats."""
    slam, _, _ = weak_run()
    log = {r["idx"]: r for r in slam.frame_log}
    assert slam.bootstrap_idx == 5
    assert "map_losses" not in log.get(0, {})
    assert log[5]["map_losses"].shape == (60,)
    for idx in (10, 15):
        assert "track_best" in log[idx] and "frontend_s" in log[idx]
        assert float(log[idx]["track_best"]) <= float(log[idx]["track_first"])
        assert log[idx]["map_losses"].shape == (24,)
    assert [t["idx"] for t in slam.scale_telemetry] == [10, 15]
    slot0 = slam.keyframes.frame_idx.index(0)
    assert (slam.keyframes.pseudo_depth[slot0] > 0).sum() > 50
    assert slam.keyframes.frame_idx[:3] == [0, 5, 10]


def test_dynamic_ba_options_take_the_megakernel_pair(monkeypatch):
    """handle_dynamic + BA (box_ba_dynamic's options) for frames 0-10:
    the tracker's render goes through ops/megakernel.make_fused_render."""
    import pointnerf_slam_torch.ops.megakernel as MK
    calls = []
    orig = MK.fused_render_reference

    def spy(*a, **k):
        calls.append(a[1].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(MK, "fused_render_reference", spy)
    cfg = port_weak_cfg(handle_dynamic=True)
    cfg["mapping"].update(BA=True)
    cfg["data"]["n_frames"] = 11
    slam = PointNeRFSLAM(cfg, device="cpu")
    est, gt = slam.run()
    assert calls and set(calls) == {cfg["tracking"]["pixels"]}
    assert len(calls) == cfg["tracking"]["iters"]      # frame 10 only
    log = {r["idx"]: r for r in slam.frame_log}
    assert torch.isfinite(log[10]["track_best"])
    # mapped frames log whether they bundle-adjusted: not with <= 4
    # keyframes (frames 0, 5 and 10 here)
    assert [r["ba"] for r in slam.frame_log if "map_losses" in r] \
        == [False, False]
    assert np.isfinite(est).all()
    assert np.linalg.norm(est[10, :3, 3] - gt[10, :3, 3]) < 0.3
