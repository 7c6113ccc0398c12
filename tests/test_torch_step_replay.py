"""scripts/step_replay.py at the weak test size: one tracked frame of a
port checkpoint through both packages from the same state.

One port run (tests/test_weak_pipeline.py's weak_cfg, frames 0..9,
bootstrap at 5, a plain-branch 32-wide decoder in both packages) is
checkpointed at frame 9, as the system's pre-bank before mapping frame
10 writes it; both tests read that checkpoint.
(a) The script's restore gives both packages equal estimates, reference
    frame and features, keyframe window, step history and last tracked
    frame, the run's own (port to reference: the other direction of
    tests/test_torch_logger.py's weak restore test); resume_slam restores
    the last two from the checkpoint, and the script's note finds them
    equal to its front-end telemetry.
(b) Frame 10 through both packages with the reference's keys turned into
    the port's draws: the motion prior equal, the solve within the
    two-view tolerances of tests/test_torch_frontend.py (translation
    rtol 2e-3, atol 1e-4, rotation 0.1 deg; counts within 1% of the
    matches), the step gate deciding alike, the tracker's losses rtol
    2e-2 and the refined camera within one Adam step (cam_lr) per
    component, as the tracker tests hold it, and moved off the solve by
    more than half a step in both. The tracker runs 2
    iterations here (weak_cfg: 10): on this frame the loss jumps by up
    to 10x between iterations (pseudo-depth rays of near-zero variance),
    so float-level differences part Adam trajectories after about 3
    iterations: along one trajectory the two packages' losses agree to
    1e-4 and their camera gradients in sign, yet the reference's own
    10-iteration best loss reads 26402 or 3701 from this run's checkpoint
    made at 8 or at 2 torch threads, where the port reads 26404 and 26395
    (scripts/step_replay.py's one-ulp variant measures the same scatter
    at full size)."""

import argparse
import os
import sys

import numpy as np
import pytest
import yaml

from pointnerf_slam_tpu.engine import PointNeRFSLAM as JSLAM
from pointnerf_slam_tpu.outputs.logger import resume_slam as j_resume
from pointnerf_slam_torch.engine.system import PointNeRFSLAM
from pointnerf_slam_torch.outputs.logger import Logger, resume_slam
from tests.test_weak_pipeline import weak_cfg
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import step_replay  # noqa: E402

CKPT_AT = 9
TRACK_ITERS = 2


def replay_cfg(out):
    cfg = weak_cfg()
    cfg["data"].update(output=str(out), frame_cache_dir="")
    # one device for the reference (conftest's CPU mesh has eight)
    cfg["parallel"] = {"data_devices": 1}
    cfg["tracking"]["iters"] = TRACK_ITERS
    return cfg


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """(the port's system after frames 0..9, its checkpoint of frame 9,
    the config as YAML)."""
    d = tmp_path_factory.mktemp("replay")
    cfg = replay_cfg(d / "run")
    slam = PointNeRFSLAM(cfg, device="cpu")
    for idx in range(CKPT_AT + 1):
        _, color, depth, gt = slam.frame_reader[idx]
        slam.step(idx, color, depth, gt)
    assert slam._bootstrapped
    Logger(str(d / "run"), 1, slam.n_img).log(slam, CKPT_AT)
    path = d / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return slam, str(d / "run" / "ckpts" / f"{CKPT_AT:05d}.npz"), str(path)


def args_for(ckpt, config, out):
    return argparse.Namespace(ckpt=ckpt, config=config, device="cpu",
                              map_iters=0, out=str(out), variant=None)


def test_restore_gives_both_packages_the_runs_state(port_run, tmp_path):
    slam, ckpt, config = port_run
    args = args_for(ckpt, config, tmp_path)
    z = np.load(ckpt)
    jslam = JSLAM(replay_cfg(tmp_path / "j"))
    tslam = PointNeRFSLAM(replay_cfg(tmp_path / "t"), device="cpu")
    start_j, note_j = step_replay.restore(jslam, j_resume, args, z)
    start_t, note_t = step_replay.restore(tslam, resume_slam, args, z)
    assert start_j == start_t == CKPT_AT + 1
    for note in (note_j, note_t):
        assert note["telemetry_hist_agrees"]
        assert note["telemetry_last_agrees"]
    n = CKPT_AT + 1
    np.testing.assert_array_equal(jslam.estimate_c2w_list[:n],
                                  slam.estimate_c2w_list[:n])
    np.testing.assert_array_equal(tslam.estimate_c2w_list[:n],
                                  slam.estimate_c2w_list[:n])
    fe = slam.frontend
    for other in (jslam.frontend, tslam.frontend):
        assert other.prev["frame_idx"] == fe.prev["frame_idx"]
        for a, b in zip(other.prev["feats"], fe.prev["feats"]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        assert other._kf_order == fe._kf_order
        for fidx in fe._kf_order:
            np.testing.assert_allclose(other._kfs[fidx].Tcw,
                                       fe._kfs[fidx].Tcw)
        assert other._step_hist == fe._step_hist
        assert other._last_tracked_idx == fe._last_tracked_idx == 5
    assert jslam.keyframes.frame_idx == tslam.keyframes.frame_idx \
        == slam.keyframes.frame_idx


def test_one_step_replay_matches_reference(port_run, tmp_path):
    _, ckpt, config = port_run
    args = args_for(ckpt, config, tmp_path)
    rj = step_replay.run_jax(args)
    assert rj["keys"] == ["frontend", "engine"]    # RANSAC, tracker
    assert rj["draws"]["fe"] == 1
    assert rj["draws"]["engine"] == TRACK_ITERS    # the plain tracker's
    rt = step_replay.run_torch(args)       # asserts every draw consumed
    assert rj["frame"] == rt["frame"] == 10
    assert rj["decision"] == rt["decision"] == "accepted"
    np.testing.assert_allclose(rt["prior"], rj["prior"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(rt["solve"], rj["solve"], rtol=2e-3,
                               atol=1e-4)
    assert step_replay.deg(rt["R_solve"], rj["R_solve"]) < 0.1
    m = rj["fe"]["n_matches"]
    assert rt["fe"]["n_matches"] == m
    for key in ("n_inliers", "n_cand", "n_accept"):
        assert abs(rt["fe"][key] - rj["fe"][key]) <= max(1, 0.01 * m), key
    np.testing.assert_allclose(rt["step_d"], rj["step_d"], rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(rt["track_first"], rj["track_first"],
                               rtol=2e-2)
    np.testing.assert_allclose(rt["track_best"], rj["track_best"],
                               rtol=2e-2)
    lr = weak_cfg()["tracking"]["lr"]
    np.testing.assert_allclose(rt["refined"], rj["refined"], rtol=0,
                               atol=lr)
    # both trackers moved the camera off the shared start (the solve): a
    # tracker whose best camera stayed there would pass the check above
    for r in (rj, rt):
        assert np.max(np.abs(np.subtract(r["refined"], r["solve"]))) \
            > lr / 2
    # the comparison's own arithmetic on these records
    g = step_replay.gaps(rj, rt)
    assert g["prior"] == 0.0 and g["refined"] < 1.0


def test_path_gap_on_hand_made_paths():
    """The comparison's arithmetic on hand-made tracker paths: where two
    paths part, each best-of selection's iteration, the gradients'
    cosine."""
    it = np.arange(6, dtype=np.float64)
    # loss, centre (m), translation gradient; b drifts 0.05 mm an
    # iteration from the same start, its least loss at iteration 2
    a = np.c_[10 - it, it * 1e-3, np.zeros(6), np.zeros(6),
              np.ones(6), np.zeros(6), np.zeros(6)]
    b = a.copy()
    b[:, 1] += it * 5e-5
    b[:, 0] = [9, 8, 1, 7, 6, 5]
    b[:, 5] = 1.0
    pg = step_replay.path_gap({"track_path": a.tolist()},
                              {"track_path": b.tolist()})
    np.testing.assert_allclose(pg["centre_mm"], it * 0.05)
    assert pg["parts_at"] == 3 and pg["best_at"] == [5, 2]
    np.testing.assert_allclose(pg["grad_cos"], np.sqrt(0.5))
    assert step_replay.path_gap({"track_path": a.tolist()},
                                {"track_path": []}) is None
