"""Checkpoints and resume of the port (outputs/logger.py, the front-end's
state_arrays / load_state_arrays, run.py's supervisor) held against the
JAX package on the CPU.

- The port's own round trip and resume: tests/test_outputs.py's
  TestLoggerRoundTrip and tests/test_resume.py's four tests, mirrored.
- The format: a sensor-depth and a weak-depth run of each package,
  checkpointed at the same frame, give the same key set; each package's
  checkpoint loads into the other's resume_slam with equal decoder,
  poses, keyframes, pseudo-depths and front-end state, and the
  reference finishes the run from the port's checkpoint.
- The supervisor: run.py --max_restarts 1 --frames_per_attempt 2 on a
  4-frame box.yaml run in two attempts, the second resumed.
- scripts/check_run_health.py (numpy only) on the port's weak checkpoint.

The sensor runs use tests/test_engine.py's tiny_cfg (40x52, a 32-wide
decoder: the port's plain branch) with the camera at gt; the weak runs
tests/test_weak_pipeline.py's weak_cfg for frames 0..8 (bootstrap at 5).
Each package's runs are made once per module (module-scoped fixtures).
"""

import os

import jax
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.engine import PointNeRFSLAM as JSLAM
from pointnerf_slam_tpu.outputs.logger import Logger as JLogger
from pointnerf_slam_tpu.outputs.logger import resume_slam as j_resume
from pointnerf_slam_torch.engine.system import PointNeRFSLAM
from pointnerf_slam_torch.models.decoders import (params_from_jax,
                                                  params_to_jax)
from pointnerf_slam_torch.outputs.logger import (Logger, load_checkpoint,
                                                 resume_slam)
from tests.test_engine import tiny_cfg
from tests.test_weak_pipeline import weak_cfg
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENSOR_AT = 4          # sensor runs: checkpoint of frame 4 (ckpt_freq 4)
WEAK_AT = 8            # weak runs: frames 0..8, checkpoint of frame 8


def sensor_cfg(out, n_frames=8, **mapping):
    return tiny_cfg(tracking={"gt_camera": True},
                    data={"n_frames": n_frames, "output": str(out)},
                    mapping={"iters_first": 20, "iters": 9, "ckpt_freq": 4,
                             **mapping})


def port_weak_cfg(out):
    cfg = weak_cfg()
    cfg["data"].update(output=str(out), frame_cache_dir="")
    return cfg


def run_frames(slam, n, logger=None):
    for idx in range(n):
        _, color, depth, gt = slam.frame_reader[idx]
        slam.step(idx, color, depth, gt)
        if logger is not None:
            logger.maybe_log(slam, idx)


def ckpt(out, idx):
    return os.path.join(str(out), "ckpts", f"{idx:05d}.npz")


def port_params(slam):
    return {k: v.detach().cpu().numpy()
            for k, v in slam.decoder.state_dict().items()}


def jax_params(jslam):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jslam.params)).items()}


def assert_params_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def sensor_runs(tmp_path_factory):
    """Frames 0..4 of the sensor config in each package, checkpointed at
    4 by Logger.maybe_log: {package: (system, checkpoint path)}."""
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"sensor_{pkg}")
        if pkg == "jax":
            slam = JSLAM(sensor_cfg(d))
            logger = JLogger(str(d), 4, slam.n_img)
        else:
            slam = PointNeRFSLAM(sensor_cfg(d), device="cpu")
            logger = Logger(str(d), 4, slam.n_img)
        run_frames(slam, SENSOR_AT + 1, logger)
        out[pkg] = (slam, ckpt(d, SENSOR_AT))
    return out


@pytest.fixture(scope="module")
def weak_runs(tmp_path_factory):
    """Frames 0..8 of weak_cfg in each package (bootstrap at 5, the map
    seeded), logged at 8: {package: (system, checkpoint path)}."""
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"weak_{pkg}")
        if pkg == "jax":
            cfg = weak_cfg()
            cfg["data"]["output"] = str(d)
            slam = JSLAM(cfg)
            logger = JLogger(str(d), 1, slam.n_img,
                             no_log_on_first_frame=False)
        else:
            slam = PointNeRFSLAM(port_weak_cfg(d), device="cpu")
            logger = Logger(str(d), 1, slam.n_img,
                            no_log_on_first_frame=False)
        run_frames(slam, WEAK_AT + 1)
        assert slam._bootstrapped
        logger.log(slam, WEAK_AT)
        out[pkg] = (slam, ckpt(d, WEAK_AT))
    return out


# -- the port's own checkpoints (mirrors of the reference's tests) ---------

def test_checkpoint_round_trip(tmp_path):
    """Logger.log then load_checkpoint: equal params and poses
    (tests/test_outputs.py TestLoggerRoundTrip)."""
    cfg = sensor_cfg(tmp_path, n_frames=3, iters_first=5, iters=3,
                     ckpt_freq=2)
    slam = PointNeRFSLAM(cfg, device="cpu")
    slam.logger = Logger(str(tmp_path), 2, slam.n_img)
    slam.run()
    slam.logger.log(slam, 2)
    params, est, gt, kfs, idx = load_checkpoint(
        ckpt(tmp_path, 2), slam.decoder.state_dict())
    assert idx == 2
    np.testing.assert_array_equal(est, slam.estimate_c2w_list)
    np.testing.assert_array_equal(gt, slam.gt_c2w_list)
    assert kfs.tolist() == slam.keyframes.frame_idx
    for k, v in slam.decoder.state_dict().items():
        assert torch.equal(params[k], v), k


def test_resume_continues_run(tmp_path):
    """A run checkpointed at frame 4 and resumed into a fresh system keeps
    its keyframes, poses and params, and finishes the run
    (tests/test_resume.py test_resume_continues_run)."""
    cfg = sensor_cfg(tmp_path)
    slam1 = PointNeRFSLAM(cfg, device="cpu")
    run_frames(slam1, 5, Logger(str(tmp_path), 4, slam1.n_img))
    slam2 = PointNeRFSLAM(cfg, device="cpu")
    start = resume_slam(slam2, ckpt(tmp_path, 4))
    assert start == 5
    assert slam2.keyframes.frame_idx == slam1.keyframes.frame_idx
    np.testing.assert_array_equal(slam2.estimate_c2w_list[:5],
                                  slam1.estimate_c2w_list[:5])
    assert torch.equal(slam2.keyframes.est_c2w, slam1.keyframes.est_c2w)
    assert torch.equal(slam2.keyframes.gt_c2w, slam1.keyframes.gt_c2w)
    assert_params_equal(port_params(slam2), port_params(slam1))
    assert slam2.mapping_first_frame_done
    est, gt = slam2.run(start)
    assert np.abs(est[7]).sum() > 0 and np.isfinite(est).all()
    assert [r["idx"] for r in slam2.frame_log] == [6, 7]   # mapped frames


def test_checkpoint_of_wrong_decoder_raises(tmp_path, sensor_runs):
    """A checkpoint whose decoder does not fit the system's raises instead
    of loading."""
    cfg = sensor_cfg(tmp_path)
    cfg["model"]["hidden_size"] = 16
    slam = PointNeRFSLAM(cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        resume_slam(slam, sensor_runs["torch"][1])


def test_run_writes_the_reference_checkpoint_frames(tmp_path):
    """PointNeRFSLAM.run with a logger checkpoints the frames the
    reference's run does: the pre-bank idx - 1 before each mapping frame,
    ckpt_freq's mapping frames and the last frame."""
    written = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        cfg = sensor_cfg(d, n_frames=7, iters_first=3, iters=3, ckpt_freq=4)
        if pkg == "jax":
            slam = JSLAM(cfg)
            slam.logger = JLogger(str(d), 4, slam.n_img)
        else:
            slam = PointNeRFSLAM(cfg, device="cpu")
            slam.logger = Logger(str(d), 4, slam.n_img)
        slam.run()
        written[pkg] = sorted(os.listdir(d / "ckpts"))
    assert written["torch"] == written["jax"]
    assert written["torch"] == [f"{i:05d}.npz" for i in (1, 3, 4, 5, 6)]


# -- the format, both ways ---------------------------------------------------

@pytest.mark.parametrize("runs", ["sensor_runs", "weak_runs"])
def test_same_key_set_as_reference(request, runs):
    r = request.getfixturevalue(runs)
    a, b = np.load(r["jax"][1]), np.load(r["torch"][1])
    assert set(a.files) == set(b.files)
    for k in a.files:
        assert a[k].dtype.kind == b[k].dtype.kind, k


def test_reference_checkpoint_loads_in_port(tmp_path, sensor_runs):
    jslam, path = sensor_runs["jax"]
    slam = PointNeRFSLAM(sensor_cfg(tmp_path), device="cpu")
    assert resume_slam(slam, path) == SENSOR_AT + 1
    assert_params_equal(port_params(slam), jax_params(jslam))
    np.testing.assert_array_equal(slam.estimate_c2w_list[:SENSOR_AT + 1],
                                  jslam.estimate_c2w_list[:SENSOR_AT + 1])
    assert slam.keyframes.frame_idx == jslam.keyframes.frame_idx
    n = len(slam.keyframes)
    np.testing.assert_array_equal(slam.keyframes.est_c2w[:n].numpy(),
                                  np.asarray(jslam.keyframes.est_c2w)[:n])
    np.testing.assert_array_equal(slam.keyframes.gt_c2w[:n].numpy(),
                                  np.asarray(jslam.keyframes.gt_c2w)[:n])


def test_port_checkpoint_loads_in_reference(tmp_path, sensor_runs):
    """The reference resumes from the port's checkpoint with the port's
    decoder and poses, and finishes the run."""
    slam, path = sensor_runs["torch"]
    jslam = JSLAM(sensor_cfg(tmp_path))
    assert j_resume(jslam, path) == SENSOR_AT + 1
    assert_params_equal(jax_params(jslam), port_params(slam))
    np.testing.assert_array_equal(jslam.estimate_c2w_list[:SENSOR_AT + 1],
                                  slam.estimate_c2w_list[:SENSOR_AT + 1])
    assert jslam.keyframes.frame_idx == slam.keyframes.frame_idx
    est, _ = jslam.run(SENSOR_AT + 1)
    assert np.abs(est[7]).sum() > 0 and np.isfinite(est).all()
    # the reference's own tree flatten reads the port's parameter order
    flat = jax.tree_util.tree_leaves(params_to_jax(slam.decoder.state_dict()))
    z = np.load(path)
    for i, leaf in enumerate(flat):
        np.testing.assert_array_equal(z[f"param_{i}"], leaf)


# -- weak-depth state ---------------------------------------------------------

def alive(fe):
    return [mp for mp in fe.map.points if not mp.is_bad]


def assert_frontend_restored(fe2, fe1):
    """The restored front-end (fe2) holds fe1's state: reference frame and
    features, keyframe window, map, counters and anchors."""
    assert fe2.prev["frame_idx"] == fe1.prev["frame_idx"]
    np.testing.assert_allclose(np.asarray(fe2.prev["feats"][0]),
                               np.asarray(fe1.prev["feats"][0]))
    assert fe2._last_tracked_idx == fe1._last_tracked_idx
    assert fe2._kf_order == fe1._kf_order
    for fidx in fe1._kf_order:
        np.testing.assert_allclose(fe2._kfs[fidx].Tcw, fe1._kfs[fidx].Tcw)
        np.testing.assert_allclose(fe2._kfs[fidx].kps, fe1._kfs[fidx].kps)
    a1, a2 = alive(fe1), alive(fe2)
    assert len(a1) > 0 and len(a2) == len(a1)
    np.testing.assert_allclose(np.stack([mp.pt for mp in a2]),
                               np.stack([mp.pt for mp in a1]))
    assert [mp.num_observations for mp in a2] \
        == [mp.num_observations for mp in a1]
    assert fe2._par_rate == fe1._par_rate
    assert fe2._reject_count == fe1._reject_count
    assert fe2._ref_fail_count == fe1._ref_fail_count
    assert fe2.kp_depth_ratio0 == fe1.kp_depth_ratio0
    assert np.isclose(float(fe2.depth_scale), float(fe1.depth_scale))
    assert np.isclose(float(fe2.median_gt_depth), float(fe1.median_gt_depth))
    assert [t.get("idx") for t in fe2.telemetry] \
        == [t.get("idx") for t in fe1.telemetry]


def assert_pseudo_restored(s2, s1):
    assert s2._bootstrapped
    assert set(s2.pseudo_depths) == set(s1.pseudo_depths)
    for k in s1.pseudo_depths:
        np.testing.assert_allclose(np.asarray(s2.pseudo_depths[k]),
                                   np.asarray(s1.pseudo_depths[k]),
                                   atol=1e-6)


def test_resume_weak_restores_pseudo(tmp_path, weak_runs):
    """Pseudo-depths, the metric-scale anchors and the reference frame
    survive a resume (tests/test_resume.py
    test_resume_weak_restores_pseudo)."""
    slam1, path = weak_runs["torch"]
    slam2 = PointNeRFSLAM(port_weak_cfg(tmp_path), device="cpu")
    assert resume_slam(slam2, path) == WEAK_AT + 1
    assert_pseudo_restored(slam2, slam1)
    fe1, fe2 = slam1.frontend, slam2.frontend
    assert fe1.depth_scale is not None
    assert np.isclose(float(fe2.depth_scale), float(fe1.depth_scale))
    assert np.isclose(float(fe2.median_gt_depth), float(fe1.median_gt_depth))
    assert fe2.prev["frame_idx"] == fe1.prev["frame_idx"]
    assert fe2._last_tracked_idx == fe1._last_tracked_idx
    assert slam2.keyframes.frame_idx == slam1.keyframes.frame_idx


def test_resume_weak_restores_map_and_telemetry(tmp_path, weak_runs):
    """The persistent map, the keyframe window, the reference features and
    the telemetry survive a resume, and the map anchors the same
    (tests/test_resume.py test_resume_weak_restores_map_and_telemetry)."""
    slam1, path = weak_runs["torch"]
    slam2 = PointNeRFSLAM(port_weak_cfg(tmp_path), device="cpu")
    resume_slam(slam2, path)
    fe1, fe2 = slam1.frontend, slam2.frontend
    assert_frontend_restored(fe2, fe1)
    assert [t["idx"] for t in slam2.scale_telemetry] \
        == [t["idx"] for t in slam1.scale_telemetry]
    kfr1 = fe1._kfs[fe1._kf_order[-1]]
    kfr2 = fe2._kfs[fe2._kf_order[-1]]
    assert sum(kfr2.id in mp.observations for mp in alive(fe2)) \
        == sum(kfr1.id in mp.observations for mp in alive(fe1))
    # the restored reference features are device tensors, as extracted
    assert all(torch.is_tensor(f) for f in fe2.prev["feats"])


@pytest.mark.parametrize("strip", ["fe", "fe_and_fe2"])
def test_resume_weak_scale_from_legacy_ckpt(tmp_path, weak_runs, strip):
    """A checkpoint without the fe_* anchors restores anchors derived from
    the data, never 1.0 (tests/test_resume.py
    test_resume_weak_scale_from_legacy_ckpt); without the fe2_* state
    too, the reference keyframe is reseeded at the saved frame from a
    fresh extraction."""
    slam1, path = weak_runs["torch"]
    z = dict(np.load(path))
    for k in ("fe_median_gt_depth", "fe_depth_scale", "fe_step_hist"):
        z.pop(k)
    if strip == "fe_and_fe2":
        z = {k: v for k, v in z.items() if not k.startswith("fe2_")}
    p = str(tmp_path / "legacy.npz")
    np.savez_compressed(p, **z)
    slam2 = PointNeRFSLAM(port_weak_cfg(tmp_path), device="cpu")
    resume_slam(slam2, p)
    fe1, fe2 = slam1.frontend, slam2.frontend
    mgd = fe2.median_gt_depth
    assert mgd is not None and 0.1 < mgd < 100.0
    assert fe1.median_gt_depth / 3 - 1e-6 < mgd \
        < 3 * fe1.median_gt_depth + 1e-6
    assert fe2.prev["frame_idx"] == fe1.prev["frame_idx"]
    if strip == "fe_and_fe2":
        assert fe2._kf_order == [] and alive(fe2) == []
        _, color, _, _ = slam2.frame_reader[fe1.prev["frame_idx"]]
        np.testing.assert_allclose(np.asarray(fe2.prev["feats"][0]),
                                   np.asarray(fe2._extract(color)[0]))


def test_reference_weak_checkpoint_restores_in_port(tmp_path, weak_runs):
    """A weak checkpoint written by the reference restores in the port:
    pseudo-depths, keyframes, the map (point count, positions,
    observations), keyframe order, depth_scale, reference frame and the
    fe2_par_rate / fe2_reject_count counters."""
    jslam, path = weak_runs["jax"]
    slam = PointNeRFSLAM(port_weak_cfg(tmp_path), device="cpu")
    assert resume_slam(slam, path) == WEAK_AT + 1
    assert_pseudo_restored(slam, jslam)
    assert slam.keyframes.frame_idx == jslam.keyframes.frame_idx
    assert_frontend_restored(slam.frontend, jslam.frontend)
    assert_params_equal(port_params(slam), jax_params(jslam))


def test_port_weak_checkpoint_restores_in_reference(tmp_path, weak_runs):
    """The other way: the reference's resume_slam reads the port's weak
    checkpoint to the same state."""
    slam, path = weak_runs["torch"]
    cfg = weak_cfg()
    cfg["data"]["output"] = str(tmp_path)
    jslam = JSLAM(cfg)
    assert j_resume(jslam, path) == WEAK_AT + 1
    assert_pseudo_restored(jslam, slam)
    assert jslam.keyframes.frame_idx == slam.keyframes.frame_idx
    assert_frontend_restored(jslam.frontend, slam.frontend)


# -- scripts/check_run_health.py on the port's checkpoint ------------------

@pytest.mark.parametrize("track_every", [5, 1])
def test_check_run_health_reads_port_checkpoint(weak_runs, capsys,
                                                track_every):
    """The numpy-only run-health check reads the port's weak checkpoint
    (frame 8): every track_every-th pose up to it, and (with at least 3
    poses) the frame-0-anchored ATE proxy of the run's own estimates and
    the carried front-end scale."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_run_health", os.path.join(REPO, "scripts",
                                         "check_run_health.py"))
    health = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(health)
    slam, path = weak_runs["torch"]
    health.main(os.path.dirname(os.path.dirname(path)), track_every)
    out = capsys.readouterr().out
    n = len(range(0, WEAK_AT + 1, track_every))
    assert f"ckpt {os.path.basename(path)}  frame {WEAK_AT}  ({n} tracked " \
        f"poses)" in out
    if n < 3:
        assert "ATE proxy" not in out
        return
    est = slam.estimate_c2w_list[:WEAK_AT + 1:track_every, :3, 3]
    gt = slam.gt_c2w_list[:WEAK_AT + 1:track_every, :3, 3]
    ate = np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1)))
    assert f"ATE proxy (frame-0 anchored RMSE): {ate * 1e3:.1f} mm" in out
    assert f"carried depth_scale {float(slam.frontend.depth_scale):.4f}" \
        in out


# -- the supervisor -----------------------------------------------------------

def test_supervisor_chunked_attempts_resume(tmp_path, monkeypatch):
    """run.py --max_restarts 1 --frames_per_attempt 2 --device cpu
    --no_eval on 4 frames of box.yaml (budgets cut): attempt 0 runs frames
    0..1, attempt 1 resumes from its checkpoint and runs 2..3; the last
    checkpoint is frame 3 and run_log.txt has one line per attempt."""
    from pointnerf_slam_torch.run import main
    yaml = tmp_path / "box_cut.yaml"
    yaml.write_text(
        f"inherit_from: {os.path.join(REPO, 'configs/Synthetic/box.yaml')}\n"
        "verbose: False\n"
        "data:\n  n_frames: 4\n  frame_cache_dir: ''\n"
        "mapping:\n  iters_first: 4\n  iters: 3\n  pixels: 64\n"
        "  mesh_freq: 1000\n"
        "meshing:\n  resolution: 24\n"
        "tracking:\n  iters: 2\n  pixels: 64\n")
    out = tmp_path / "out"
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    rc = main([str(yaml), "--device", "cpu", "--output", str(out),
               "--max_restarts", "1", "--frames_per_attempt", "2",
               "--no_eval"])
    assert rc == 0
    names = sorted(os.listdir(out / "ckpts"))
    assert names[-1] == "00003.npz"
    assert "00001.npz" in names       # attempt 0's last frame
    lines = (out / "run_log.txt").read_text().splitlines()
    assert len(lines) == 2
    assert "frames 0..1" in lines[0] and "frames 2..3" in lines[1]
    assert os.path.exists(out / "mesh" / "final_mesh.ply")
