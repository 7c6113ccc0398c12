"""The port's evaluation tools (pointnerf_slam_torch/tools) against the JAX
package's on the same inputs, made from a numpy seed: Horn's alignment
and the ATE statistics (to 1e-12), the native ray caster (depths and
misses exactly), the frustum mask and the culled mesh (exactly), the 3D
metrics and the 2D depth-L1 with the view rejection on and off (to
1e-9), the analytic ground-truth mesh at resolution 48 (vertices and
faces equal), and scripts/eval_room_bench_torch.sh on a small run
directory against the reference's tools run with the same settings.
The tools run on the host in both packages (numpy, scipy, the in-repo
native libraries); the cases mirror tests/test_outputs.py TestRaycaster,
TestEvalATE and TestEvalRecon."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from pointnerf_slam_tpu.tools import cull_mesh as j_cull
from pointnerf_slam_tpu.tools import eval_ate as j_ate
from pointnerf_slam_tpu.tools import eval_recon as j_recon
from pointnerf_slam_tpu.tools import make_synthetic_gt_mesh as j_gt
from pointnerf_slam_tpu.tools.raycast import MeshRaycaster as JRaycaster
from pointnerf_slam_torch.io.config import load_config
from pointnerf_slam_torch.io.datasets import get_dataset
from pointnerf_slam_torch.outputs.mesher import marching_tets, write_ply
from pointnerf_slam_torch.tools import cull_mesh, eval_ate, eval_recon
from pointnerf_slam_torch.tools import make_synthetic_gt_mesh as gt_mesh
from pointnerf_slam_torch.tools.raycast import MeshRaycaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sphere(n=32, r=9.0):
    ax = np.arange(n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    c = (n - 1) / 2
    grid = np.sqrt((gx - c) ** 2 + (gy - c) ** 2 + (gz - c) ** 2)
    verts, tris = marching_tets(grid, r)
    return verts, tris, c


def trajectory(seed, n=40):
    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), 0)
    est = gt.copy()
    a = 0.3
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]])
    est[:, :3, 3] = gt[:, :3, 3] @ rot.T + 0.2 + rng.normal(
        scale=0.01, size=(n, 3))
    return gt, est


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_horn_matches_reference(seed):
    gt, est = trajectory(seed)
    for a, b in zip(eval_ate.align_horn(est[:, :3, 3].T, gt[:, :3, 3].T),
                    j_ate.align_horn(est[:, :3, 3].T, gt[:, :3, 3].T)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_evaluate_ate_matches_reference(dtype):
    """All statistics, with a never-filled row and a non-finite gt row
    dropped, and --scale; float32 as checkpoints hold the poses."""
    gt, est = trajectory(5)
    gt[7] = 0.0
    gt[11, 0, 3] = np.inf
    gt, est = gt.astype(dtype), est.astype(dtype)
    for scale in (1.0, 2.5):
        a = eval_ate.evaluate_ate(gt, est, scale)
        b = j_ate.evaluate_ate(gt, est, scale)
        assert a.keys() == b.keys() and a["compared_pose_pairs"] == 38
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=0, abs=1e-12), k


def test_eval_ate_command_line_matches_reference(tmp_path, capsys,
                                                 monkeypatch):
    """The command line on a checkpoint and on an output directory prints
    the reference's lines."""
    gt, est = trajectory(4)
    os.makedirs(tmp_path / "ckpts")
    path = str(tmp_path / "ckpts" / "00039.npz")
    np.savez(path, gt_c2w_list=gt.astype(np.float32),
             estimate_c2w_list=est.astype(np.float32))
    eval_ate.main([str(tmp_path)])
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["eval_ate", path])
    j_ate.main()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[0] == f"using {path}"
    assert ours[1:] == theirs and len(theirs) == 7


def test_raycaster_matches_reference():
    """Depths and misses of random rays from around and inside a sphere,
    bit for bit."""
    verts, tris, c = sphere()
    rng = np.random.default_rng(0)
    o = (c + rng.uniform(-30, 30, size=(4000, 3))).astype(np.float32)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    t = MeshRaycaster(verts, tris).cast(o, d)
    t_ref = JRaycaster(verts, tris).cast(o, d)
    assert t.tobytes() == t_ref.tobytes()
    assert (t == -1.0).sum() > 100 and (t > 0).sum() > 100


def test_raycaster_hits_and_misses():
    """tests/test_outputs.py TestRaycaster on the port's caster."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    rc = MeshRaycaster(verts, np.array([[0, 1, 2]], np.int64))
    t = rc.cast(np.array([[0.2, 0.2, -1.0], [5.0, 5.0, -1.0]], np.float32),
                np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32))
    assert abs(t[0] - 1.0) < 1e-5 and t[1] == -1.0


def room_frames():
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/room_bench.yaml"))
    cfg["data"]["frame_cache_dir"] = ""
    return np.asarray(get_dataset(cfg).poses)


@pytest.mark.parametrize("frames", [slice(0, 1), slice(0, 500, 25)])
def test_frustum_mask_and_cull_match_reference(frames):
    """frustum_keep_mask and cull_mesh on the resolution-48 room mesh with
    the flagship orbit's gt poses, exactly."""
    verts, tris, _ = gt_mesh.make_gt_mesh(48)
    poses = room_frames()[frames]
    k = cull_mesh.REPLICA_INTRINSICS
    mask = cull_mesh.frustum_keep_mask(verts, poses, **k)
    np.testing.assert_array_equal(
        mask, j_cull.frustum_keep_mask(verts, poses, **k))
    assert 0 < mask.sum() < len(verts)
    for a, b in zip(cull_mesh.cull_mesh(verts, tris, poses, **k),
                    j_cull.cull_mesh(verts, tris, poses, **k)):
        np.testing.assert_array_equal(a, b)


def test_gt_mesh_matches_reference():
    for a, b in zip(gt_mesh.make_gt_mesh(48), j_gt.make_gt_mesh(48)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sphere_meshes(tmp_path_factory):
    """A sphere (the ground truth) and a shifted, coarser sphere (the
    reconstruction) as PLYs, and an unseen point cloud off one side."""
    d = tmp_path_factory.mktemp("spheres")
    v, t, c = sphere(32, 9.0)
    write_ply(str(d / "gt.ply"), v, t)
    v2, t2, _ = sphere(24, 7.0)
    write_ply(str(d / "rec.ply"), v2 + (c - 11.5) + 0.4, t2)
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(200, 3)) * [0.2, 0.2, 1.0]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pc = (c + 60.0 * np.abs(dirs)).astype(np.float32)
    np.save(str(d / "unseen.npy"), pc)
    return str(d / "rec.ply"), str(d / "gt.ply"), str(d / "unseen.npy")


@pytest.mark.parametrize("align", [True, False])
def test_3d_metrics_match_reference(sphere_meshes, align):
    rec, gt, _ = sphere_meshes
    a = eval_recon.calc_3d_metric(rec, gt, n_samples=20000, align=align)
    b = j_recon.calc_3d_metric(rec, gt, n_samples=20000, align=align)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=0, abs=1e-9), k
    assert a["accuracy"] > 0


@pytest.mark.parametrize("reject,cloud", [(True, "all"), (False, "all"),
                                          (True, "one point")])
def test_2d_depth_l1_matches_reference(sphere_meshes, reject, cloud):
    """Depth-L1 with the unseen-region view rejection on and off, and with
    a one-point unseen cloud: the same views drawn (count) and the same
    error."""
    rec, gt, pc = sphere_meshes
    pc = np.load(pc) if cloud == "all" else np.load(pc)[:1]
    kw = dict(n_imgs=4, H=40, W=48, fx=24.0, unseen_pc=pc,
              reject_unseen=reject)
    a = eval_recon.calc_2d_metric(rec, gt, **kw)
    b = j_recon.calc_2d_metric(rec, gt, **kw)
    assert a["n_views"] == b["n_views"] > 0
    assert a["depth l1"] == pytest.approx(b["depth l1"], rel=0, abs=1e-9)


def metrics(text: str) -> list:
    """The numbers of an eval_metrics.txt: ATE lines and the metric
    dictionaries, in order."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("absolute_translational_error") \
                or ln.startswith("compared_pose_pairs"):
            out.append(float(ln.split()[-1]))
        elif ln.startswith("{"):
            out.extend(float(v) for v in ast.literal_eval(ln).values())
    return out


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A small finished run: a checkpoint with the flagship orbit's first
    40 gt poses and perturbed estimates, and a coarse room mesh as the
    reconstruction."""
    d = tmp_path_factory.mktemp("run")
    os.makedirs(d / "ckpts")
    os.makedirs(d / "mesh")
    gt = room_frames()[:40].astype(np.float32)
    est = gt.copy()
    est[:, :3, 3] += np.random.default_rng(2).normal(
        scale=0.02, size=(40, 3)).astype(np.float32)
    np.savez(str(d / "ckpts" / "00039.npz"), gt_c2w_list=gt,
             estimate_c2w_list=est)
    v, t, c = gt_mesh.make_gt_mesh(24)
    write_ply(str(d / "mesh" / "final_mesh_eval_rec.ply"), v + 0.01, t, c)
    return d


def run_reference_tools(out, res, n_imgs, monkeypatch, capsys):
    """scripts/eval_room_bench.sh's steps through the reference's tools'
    command lines (in this process), at a ground-truth resolution and
    view count of our choosing; returns what they print."""
    ck = os.path.join(out, "ckpts", "00039.npz")
    rec = os.path.join(out, "mesh", "final_mesh_eval_rec.ply")
    gt = os.path.join(out, "ref_gt.ply")
    culled = os.path.join(out, "ref_gt_culled.ply")
    steps = [
        (j_gt.main, ["--out", gt, "--resolution", str(res)]),
        (j_cull.main, [gt, "--traj", ck, "--out", culled,
                       "--save_unseen_pc"]),
        (j_ate.main, [ck]),
        (j_recon.main, ["--rec_mesh", rec, "--gt_mesh", culled, "-3d"]),
        (j_recon.main, ["--rec_mesh", rec, "--gt_mesh", culled, "-2d",
                        "--n_imgs", str(n_imgs)]),
        (j_recon.main, ["--rec_mesh", rec, "--gt_mesh", culled, "-2d",
                        "--n_imgs", str(n_imgs), "--no_reject_unseen"])]
    capsys.readouterr()
    text = ""
    for main, argv in steps:
        monkeypatch.setattr(sys, "argv", ["tool"] + argv)
        main()
        printed = capsys.readouterr().out
        text += printed if main in (j_ate.main, j_recon.main) else ""
    return text


def run_port_script(out, **env):
    subprocess.run(["bash", os.path.join(REPO, "scripts",
                                         "eval_room_bench_torch.sh"),
                    str(out)], check=True, capture_output=True,
                   env=dict(os.environ, PYTHON=sys.executable, **env))
    return (out / "eval_metrics.txt").read_text()


def test_eval_script_matches_reference_tools(run_dir, monkeypatch, capsys):
    """scripts/eval_room_bench_torch.sh (resolution 48, 3 views) writes
    eval_metrics.txt with the numbers the reference's tools print for the
    same steps and settings."""
    ours = run_port_script(run_dir, GT_RESOLUTION="48", N_IMGS="3")
    assert re.search(r"== eval_ate .*00039\.npz", ours)
    theirs = run_reference_tools(str(run_dir), 48, 3, monkeypatch, capsys)
    a, b = metrics(ours), metrics(theirs)
    assert len(a) == 7 + 3 + 2 + 2 and a == b


@pytest.mark.slow
def test_eval_script_matches_reference_script(run_dir):
    """The port's script at its defaults against the reference's
    scripts/eval_room_bench.sh unchanged (resolution 256, 200 views of
    500x500: minutes on the host, hence slow)."""
    ours = run_port_script(run_dir)
    theirs_dir = run_dir / "ref"
    os.makedirs(theirs_dir / "ckpts")
    os.makedirs(theirs_dir / "mesh")
    for sub in ("ckpts/00039.npz", "mesh/final_mesh_eval_rec.ply"):
        os.link(run_dir / sub, theirs_dir / sub)
    subprocess.run(["bash", os.path.join(REPO, "scripts",
                                         "eval_room_bench.sh"),
                    str(theirs_dir)], check=True, capture_output=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    theirs = (theirs_dir / "eval_metrics.txt").read_text()
    assert metrics(ours) == metrics(theirs)
