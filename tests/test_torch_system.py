"""The port's data, system and device handling: synthetic frames equal to
the reference's byte for byte (and the same frame cache format), the
sensor-depth system on configs/Synthetic/box.yaml for 3 frames on the CPU,
and the refusals (no CUDA card, unported modes; weak mode and
handle_dynamic run now, tests/test_torch_weak.py)."""

import os

import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.engine.system import random_select as j_select
from pointnerf_slam_tpu.io.config import load_config as jload
from pointnerf_slam_tpu.io.datasets import get_dataset as j_dataset
from pointnerf_slam_torch.engine.system import PointNeRFSLAM, random_select
from pointnerf_slam_torch.io.config import load_config
from pointnerf_slam_torch.io.datasets import get_dataset
from pointnerf_slam_torch.utils.device import resolve_device
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = os.path.join(REPO, "configs", "Synthetic", "box.yaml")


def box_cfg(load=load_config, **data):
    cfg = load(BOX)
    cfg["data"].update({"frame_cache_dir": "", **data})
    return cfg


@pytest.mark.parametrize("index", [0, 7])
def test_synthetic_frames_byte_identical(index):
    a = get_dataset(box_cfg(depth_noise=0.01))[index]
    b = j_dataset(box_cfg(jload, depth_noise=0.01))[index]
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_frame_cache_format_shared(tmp_path):
    """A cache written by the port is read by the reference and the other
    way round, with identical frames."""
    ours = get_dataset(box_cfg(frame_cache_dir=str(tmp_path / "a")))
    theirs = j_dataset(box_cfg(jload, frame_cache_dir=str(tmp_path / "a")))
    fresh = ours[2]                       # port writes the cache
    cached = theirs[2]                    # reference reads it
    for x, y in zip(fresh[1:], cached[1:]):
        assert x.tobytes() == y.tobytes()
    j_dataset(box_cfg(jload, frame_cache_dir=str(tmp_path / "b")))[4]
    ours_b = get_dataset(box_cfg(frame_cache_dir=str(tmp_path / "b")))
    direct = get_dataset(box_cfg())[4]
    for x, y in zip(ours_b[4][1:], direct[1:]):
        assert x.tobytes() == y.tobytes()


def test_window_selection_draws_match_reference():
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for n, k in ((1, 3), (4, 3), (9, 3), (12, 8)):
        assert [int(v) for v in random_select(n, k, r1)] == \
            [int(v) for v in j_select(n, k, r2)]


def test_upload_quantisation_matches_reference_decode():
    slam = PointNeRFSLAM(box_cfg(), n_frames_cap=2, device="cpu")
    _, color, depth, _ = slam.frame_reader[1]
    c, d, u8 = slam._upload_frame(1, color, depth)
    u8_ref = np.clip(color * 255, 0, 255).astype(np.uint8)
    q = float(depth.max()) / 65535.0
    d16 = np.round(depth / q).astype(np.uint16)
    np.testing.assert_array_equal(u8.numpy(), u8_ref)
    np.testing.assert_array_equal(c.numpy(),
                                  u8_ref.astype(np.float32) / np.float32(255))
    np.testing.assert_array_equal(d.numpy(),
                                  d16.astype(np.float32) * np.float32(q))


def test_system_three_frames_on_cpu():
    """box.yaml, 3 frames, budgets cut for the CPU (iters_first 30, 12
    mapping and 10 tracking iterations, 300 / 200 rays; widths uncut):
    finite losses that fall, a tracked camera near gt."""
    cfg = box_cfg()
    cfg["mapping"].update(iters_first=30, iters=12, pixels=300,
                          fused_outer=True, resample_every=4)
    cfg["tracking"].update(iters=10, pixels=200, resample_every=5)
    slam = PointNeRFSLAM(cfg, n_frames_cap=3, device="cpu")
    est, gt = slam.run()
    log = {r["idx"]: r for r in slam.frame_log}
    m0 = log[0]["map_losses"]
    assert m0.shape == (30,) and torch.isfinite(m0).all()
    assert float(m0[-5:].mean()) < float(m0[:5].mean())
    for idx in (1, 2):
        r = log[idx]
        assert torch.isfinite(r["track_best"])
        assert float(r["track_best"]) <= float(r["track_first"])
        assert float(r["t_err_m"]) < 0.1
    # frame 2 is the last: colour refine, 5 outers of 12 iterations
    assert log[2]["map_losses"].shape == (60,)
    assert np.isfinite(est[:3]).all()
    np.testing.assert_array_equal(est[0], gt[0])


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PointNeRFSLAM(box_cfg(), n_frames_cap=2)     # default device: cuda
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("edit,match", [
    pytest.param(lambda c: c.update(nice=True), "NICE", id="<lambda>-NICE"),
    pytest.param(lambda c: c["mapping"].update(
        keyframe_selection_method="overlap"), "overlap",
        id="<lambda>-overlap"),
    pytest.param(lambda c: None, "multi-device", id="<lambda>-multi-device"),
    # frustum feature masks (the mapper's grid masks, NICE's)
    pytest.param(lambda c: c["mapping"].update(
        frustum_feature_selection=True), "item 11", id="<lambda>-item 11"),
])
def test_unported_modes_raise(edit, match, monkeypatch):
    """Multi-device mapping (parallel/, ROADMAP Queue 1 item 11) is ported
    now, whatever else the config selects: NICE, overlap keyframes,
    frustum masks, or none of them (`match` names the case;
    test_ported_modes_construct runs them). parallel.data_devices 4
    without a process group maps on one device; what is refused is a
    group of more ranks than data_devices resolves to (here a two-rank
    group with data_devices 1), whose other rank would map apart."""
    import pointnerf_slam_torch.engine.system as S
    from pointnerf_slam_torch.parallel import DataGroup
    cfg = box_cfg()
    edit(cfg)
    cfg["parallel"] = {"data_devices": 4}
    slam = PointNeRFSLAM(cfg, n_frames_cap=2, device="cpu")
    assert slam.group.world_size == 1 and slam.group.rank == 0
    cfg["parallel"] = {"data_devices": 1}
    monkeypatch.setattr(S, "make_mesh", lambda device=None: DataGroup(
        None, 0, 2, torch.device("cpu")))
    with pytest.raises(ValueError, match="map apart"):
        PointNeRFSLAM(cfg, n_frames_cap=2, device="cpu")


@pytest.mark.parametrize("edit", [
    lambda c: c.update(nice=True, weak_depth=False),
    lambda c: c["mapping"].update(keyframe_selection_method="overlap"),
    lambda c: c.update(nice=True, weak_depth=False, mapping={
        **c["mapping"], "frustum_feature_selection": True})])
def test_ported_modes_construct(edit):
    """NICE, overlap keyframe selection and frustum masks build a system
    (tests/test_torch_nice.py runs them against the reference)."""
    cfg = box_cfg()
    edit(cfg)
    slam = PointNeRFSLAM(cfg, n_frames_cap=2, device="cpu")
    assert slam.nice == bool(cfg.get("nice"))
    assert bool(slam.c_grid) == slam.nice
    assert slam._use_grid_masks == bool(
        slam.nice and cfg["mapping"].get("frustum_feature_selection"))


@pytest.mark.parametrize("weights,extractor", [
    (os.path.join(REPO, "pretrained", "superpoint_synthetic.npz"),
     "SuperPointExtractor"),
    ("none", "HarrisExtractor"),
    (os.path.join(REPO, "pretrained", "absent.pth"), "HarrisExtractor")])
def test_weak_mode_selects_the_extractor(weights, extractor):
    """The reference's rule: SuperPoint where superpoint_weights names a
    checkpoint that exists, else Harris."""
    cfg = box_cfg()
    cfg.update(weak_depth=True, superpoint_weights=weights)
    slam = PointNeRFSLAM(cfg, n_frames_cap=2, device="cpu")
    assert type(slam.frontend.extractor).__name__ == extractor


@pytest.mark.parametrize("edit", [
    # more samples per ray than the kernels hold
    lambda c: c["rendering"].update(N_samples=96),
    lambda c: c["rendering"].update(megakernel="off")])
def test_plain_renderer_configs_build(edit):
    """Sampling past the kernels' cover and `rendering.megakernel: off`
    take the tracker's and mapper's plain branches (tests/
    test_torch_engine.py holds them against the reference)."""
    cfg = box_cfg()
    edit(cfg)
    slam = PointNeRFSLAM(cfg, n_frames_cap=2, device="cpu")
    assert slam.mesher is None and slam.output == cfg["data"]["output"]
    assert callable(slam.tracking_step)


def test_trajectory_errors_match_reference_ate():
    """run.trajectory_errors' Horn-aligned RMSE and max against the JAX
    reference's tools/eval_ate.evaluate_ate, and its unaligned ones
    against their definition, on a perturbed random trajectory."""
    from pointnerf_slam_torch.run import trajectory_errors
    from pointnerf_slam_tpu.tools.eval_ate import evaluate_ate
    rng = np.random.default_rng(3)
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(scale=0.1, size=(30, 3)), 0)
    est = gt.copy()
    est[:, :3, 3] = gt[:, :3, 3] @ np.array(
        [[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]).T + 0.3 + rng.normal(
            scale=0.02, size=(30, 3))
    got, ref = trajectory_errors(est, gt), evaluate_ate(gt, est)
    assert got["ate_rmse"] == pytest.approx(
        ref["absolute_translational_error.rmse"], rel=1e-9)
    assert got["ate_max"] == pytest.approx(
        ref["absolute_translational_error.max"], rel=1e-9)
    raw = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert got["max"] == pytest.approx(raw.max())
    assert got["rmse"] == pytest.approx(np.sqrt(np.mean(raw ** 2)))
    assert got["ate_rmse"] < 0.05 < got["rmse"]
