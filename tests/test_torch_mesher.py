"""The port's mesher (pointnerf_slam_torch/outputs/) against the JAX
reference's outputs/mesher.py, on the same system state: the synthetic
room at 40 x 52 with keyframes 0, 4 and 8 at their gt poses and an iMAP*
decoder (32 wide, 2 blocks) the port's mapper trained for 100 iterations,
loaded into both packages.

Bounds: the occupancy grid (field plus TSDF hull) within 1e-4 (the two
packages evaluate the same float32 decoder, summing in other orders);
vertex and triangle counts within 0.5%; mean nearest-vertex distance
under 1e-3 of a voxel; colours within 1/255 on >= 99% of vertices; the
frustum masks (seen / forecast / unseen, with depth_test and
use_all_frames) and clean_components equal; an asynchronous mesh job
equal to the synchronous build; each package reads the other's PLYs."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.engine.state import KeyframeBuffer as JKeyframes
from pointnerf_slam_tpu.engine.system import PointNeRFSLAM as JSLAM
from pointnerf_slam_tpu.io.config import DEFAULT_CONFIG as J_DEFAULT
from pointnerf_slam_tpu.outputs import mesher as JM
from pointnerf_slam_torch.engine.state import KeyframeBuffer
from pointnerf_slam_torch.engine.system import PointNeRFSLAM
from pointnerf_slam_torch.io.config import DEFAULT_CONFIG, update_recursive
from pointnerf_slam_torch.models.decoders import params_to_jax
from pointnerf_slam_torch.outputs import attach_outputs
from pointnerf_slam_torch.outputs import mesher as M
from tests.torch_threads import share_cores

share_cores()

KEYFRAMES = (0, 4, 8)


def tiny_cfg(output, default=DEFAULT_CONFIG, **over):
    """The reference's tests/test_engine.py tiny_cfg with gt cameras."""
    cfg = copy.deepcopy(default)
    update_recursive(cfg, {
        "scale": 1.0, "weak_depth": False, "depth_supervision": True,
        "verbose": False,
        "cam": {"H": 40, "W": 52, "fx": 30.0, "fy": 30.0, "cx": 25.5,
                "cy": 19.5, "crop_edge": 0},
        "model": {"hidden_size": 32, "n_blocks": 2},
        "rendering": {"N_samples": 12, "N_surface": 0, "N_importance": 4},
        "mapping": {"bound": [[-2.2, 2.2]] * 3,
                    "marching_cubes_bound": [[-2.2, 2.2]] * 3,
                    "pixels": 400, "iters": 60, "iters_first": 200,
                    "every_frame": 2, "keyframe_every": 4,
                    "mapping_window_size": 3, "color_refine": False},
        "tracking": {"pixels": 300, "iters": 12, "lr": 2e-3,
                     "gt_camera": True},
        "meshing": {"resolution": 40, "level_set": 0.0},
        "data": {"dataset": "synthetic", "n_frames": 9, "output": output,
                 "frame_cache_dir": ""},
        "track_every_frame": 1})
    update_recursive(cfg, over)
    return cfg


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """(port system, reference system, cfg): the same keyframes and poses,
    the port's briefly mapped decoder in both."""
    out = str(tmp_path_factory.mktemp("mesh"))
    cfg = tiny_cfg(out)
    slam = PointNeRFSLAM(cfg, device="cpu")
    jslam = JSLAM(tiny_cfg(out, J_DEFAULT))
    for idx in KEYFRAMES:
        _, color, depth, gt = slam.frame_reader[idx]
        for s in (slam, jslam):
            s.estimate_c2w_list[idx] = gt
        slam._maybe_insert_keyframe(idx, color, depth)
        jslam._maybe_insert_keyframe(idx, color, depth, gt)
    slam._map_frame(8, color, depth, 100, 1)
    jslam.params = jax.tree_util.tree_map(
        jnp.asarray, params_to_jax(slam.decoder.state_dict()))
    return slam, jslam, cfg


def nearest(a, b):
    """Distance from each row of a to its nearest row of b, and its index."""
    from scipy.spatial import cKDTree
    return cKDTree(b).query(a)


def test_occupancy_grid_matches_reference(systems):
    slam, jslam, cfg = systems
    m, jm = M.Mesher(cfg, slam, 8192), JM.Mesher(cfg, jslam, 8192)
    view = M.MeshSnapshot(slam)
    axes = m.get_grid_uniform()
    for a, b in zip(axes, jm.get_grid_uniform()):
        np.testing.assert_array_equal(a, b)
    pts = m.grid_points(axes, "cpu")
    np.testing.assert_array_equal(pts.numpy(), jm.grid_points(axes))
    occ = m.eval_grid(view, pts)
    hull = m.bound_hull(view)
    occ[~hull(pts)] = 100.0
    jocc = jm.eval_grid(jslam, pts.numpy())
    jocc[~jm.bound_hull(jslam)(pts.numpy())] = 100.0
    assert (jocc == 100.0).mean() > 0.05          # the hull cuts the grid
    np.testing.assert_allclose(occ.numpy(), jocc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("color_method", ["render_ray_along_normal",
                                          "direct_point_query"])
def test_mesh_matches_reference(systems, tmp_path, color_method):
    """get_mesh (TSDF hull, marching tetrahedra, frustum culling,
    components, either colour method) from the same state."""
    slam, jslam, cfg = systems
    cfg = copy.deepcopy(cfg)
    cfg["meshing"]["color_mesh_extraction_method"] = color_method
    got = M.Mesher(cfg, slam, 8192).get_mesh(slam, str(tmp_path / "t.ply"),
                                             cur_idx=8)
    ref = JM.Mesher(cfg, jslam, 8192).get_mesh(jslam, str(tmp_path / "j.ply"),
                                               cur_idx=8)
    (v, t, c), (vj, tj, cj) = got, ref
    assert len(vj) > 1000
    assert abs(len(v) - len(vj)) <= 0.005 * len(vj)
    assert abs(len(t) - len(tj)) <= 0.005 * len(tj)
    voxel = 4.4 / 40
    d_a, i_a = nearest(v, vj)
    d_b, _ = nearest(vj, v)
    assert 0.5 * (d_a.mean() + d_b.mean()) < 1e-3 * voxel
    close = np.abs(c.astype(int) - cj[i_a].astype(int)).max(1) <= 1
    assert close.mean() >= 0.99, close.mean()


def test_point_masks_match_reference(systems):
    """seen / forecast / unseen by the keyframe frustums on the grid, with
    the keyframe depth constraint, with depth_test (whose forecast gate
    sees the reference's zero-padded chunk), and with all frames."""
    slam, jslam, cfg = systems
    pts = np.random.default_rng(0).uniform(-3, 3, (5000, 3)).astype(
        np.float32)
    for over, all_frames in (({}, False), ({"depth_test": True}, False),
                             ({}, True)):
        c = copy.deepcopy(cfg)
        c["meshing"].update(over)
        got = M.Mesher(c, slam, 3000).point_masks(
            M.MeshSnapshot(slam), pts, use_all_frames=all_frames, cur_idx=8)
        ref = JM.Mesher(c, jslam, 3000).point_masks(
            jslam, pts, use_all_frames=all_frames, cur_idx=8)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert 0 < got[0].sum() < len(pts)


def _mask_views(depth_fill):
    """One identity-pose keyframe of constant depth in each package (the
    reference's TestPointMasks scene)."""
    from types import SimpleNamespace
    H, W = 24, 32
    cam = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
    buf, jbuf = KeyframeBuffer(8, H, W, "cpu"), JKeyframes(8, H, W)
    depth = np.full((H, W), depth_fill, np.float32)
    buf.insert(0, np.zeros((H, W, 3), np.uint8), depth, cam)
    jbuf.insert(0, np.zeros((H, W, 3), np.uint8), depth, cam, cam)
    est = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    kw = dict(H=H, W=W, fx=20.0, fy=20.0, cx=15.5, cy=11.5,
              estimate_c2w_list=est)
    return SimpleNamespace(keyframes=buf, **kw), \
        SimpleNamespace(keyframes=jbuf, **kw)


@pytest.mark.parametrize("depth_fill,over,all_frames", [
    (3.0, {}, False), (2.0, {"depth_test": True}, False), (0.5, {}, True)])
def test_point_masks_on_the_reference_scene(depth_fill, over, all_frames):
    view, jview = _mask_views(depth_fill)
    pts = np.array([[0.0, 0.0, -2.0], [0.0, 0.0, 2.0], [3.0, 0.0, -2.0],
                    [0.0, 0.0, -5.0], [300.0, 0.0, -2.0], [0.0, 0.0, -2.1],
                    [0.0, 0.0, -4.6], [0.0, 0.0, -50.0]], np.float32)
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["meshing"].update(over)
    got = M.Mesher(cfg, None, 4096).point_masks(view, pts, all_frames, 0)
    ref = JM.Mesher(cfg, None, 4096).point_masks(jview, pts, all_frames, 0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_clean_components_and_culling_match_reference():
    n = 48
    ax = np.arange(n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    grid = np.minimum(
        np.sqrt((gx - 14) ** 2 + (gy - 24) ** 2 + (gz - 24) ** 2) - 10.0,
        np.sqrt((gx - 38) ** 2 + (gy - 24) ** 2 + (gz - 24) ** 2) - 3.0)
    verts, tris = M.marching_tets(grid, 0.0)
    jverts, jtris = JM.marching_tets(grid, 0.0)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    for largest, area in ((True, 0.0), (False, 4 * np.pi * 18.0),
                          (False, 1e-6)):
        a = M.clean_components(verts, tris, largest, area)
        b = JM.clean_components(verts, tris, largest, area)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    drop = np.random.default_rng(1).uniform(size=len(verts)) < 0.7
    for x, y in zip(M.cull_faces(verts, tris, drop),
                    JM.cull_faces(verts, tris, drop)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(M.vertex_normals(verts, tris),
                                  JM.vertex_normals(verts, tris))


def test_ply_read_by_either_package(tmp_path):
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    tris = rng.integers(0, 50, (70, 3))
    colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    for write, read in ((M.write_ply, JM.read_ply), (JM.write_ply, M.read_ply)):
        for c in (colors, None):
            path = str(tmp_path / "m.ply")
            write(path, verts, tris, c)
            v, t, cc = read(path)
            np.testing.assert_array_equal(v, verts)
            np.testing.assert_array_equal(t, tris)
            assert (cc is None) if c is None else np.array_equal(cc, c)
    M.write_ply(str(tmp_path / "a.ply"), verts, tris, colors)
    JM.write_ply(str(tmp_path / "b.ply"), verts, tris, colors)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply"
                                                 ).read_bytes()


def test_async_job_from_a_snapshot_matches_the_sync_build(systems,
                                                          tmp_path):
    """maybe_mesh at a mesh frame starts a job that advances a few chunks
    per frame from a snapshot; changing the live system (keyframes, poses,
    decoder) mid-build does not change it: equal to the synchronous build.
    The final frame writes final_mesh.ply and final_mesh_eval_rec.ply,
    which the reference reads."""
    slam, _, cfg = systems
    c = copy.deepcopy(cfg)
    c["meshing"].update(chunks_per_frame=2, eval_rec=True)
    c["mapping"].update(mesh_freq=2)
    state = {k: v.clone() for k, v in slam.decoder.state_dict().items()}
    keyframes, est = slam.keyframes, slam.estimate_c2w_list.copy()
    output = slam.output
    slam.output = str(tmp_path)
    try:
        attach_outputs(slam)
        mesher = M.Mesher(c, slam, 8192)
        slam.mesher = mesher
        sync = mesher.get_mesh(slam, str(tmp_path / "sync.ply"), cur_idx=2)
        mesher.maybe_mesh(slam, 2)
        assert mesher._job is not None, "the job should not finish inline"
        slam.keyframes = KeyframeBuffer(4, slam.H, slam.W, "cpu")
        slam.estimate_c2w_list[:] = 0
        with torch.no_grad():
            for p in slam.decoder.parameters():
                p.mul_(0.5)
        for idx in range(3, 40):
            mesher.maybe_mesh(slam, idx if idx % 2 else idx + 1)
            if mesher._job is None:
                break
        mesher.flush(slam)
        v, _, _ = M.read_ply(str(tmp_path / "mesh" / "00002_mesh.ply"))
        np.testing.assert_array_equal(v, sync[0])
        slam.keyframes, slam.estimate_c2w_list[:] = keyframes, est
        slam.decoder.load_state_dict(state)
        mesher.maybe_mesh(slam, slam.n_img - 1)
        for name in ("final_mesh.ply", "final_mesh_eval_rec.ply"):
            vj, tj, cj = JM.read_ply(str(tmp_path / "mesh" / name))
            assert len(vj) > 1000 and len(tj) and cj is not None
    finally:
        slam.keyframes, slam.estimate_c2w_list[:] = keyframes, est
        slam.decoder.load_state_dict(state)
        slam.output, slam.mesher = output, None
    assert os.path.exists(tmp_path / "mesh" / "final_mesh.ply")
