"""The port's front-end library against the JAX reference on the same
inputs: the NMS zoo, the pluggable feature stack, projection-guided search,
windowed bundle adjustment and the front-end's known-pose pseudo-depth
(`SparseFrontend.pseudo_depth_for`, the map wiring's entry).

Bounds: NMS keep masks, matcher indices, search indices and masks, and the
fused slots equal; the feature stack's Harris keypoints, descriptors and
filters as tests/test_torch_frontend.py holds Harris (same pixels,
positions and descriptors within 1e-4); bundle adjustment in float64
within 1e-9 of the reference (the same algorithm; in float32 the
sigma2 = 1e-6 normal equations amplify rounding to ~1e-3 between any two
summation orders, so there the port meets the reference test's own
bounds); pseudo_depth_for's telemetry counts equal and its pseudo-depth
pixels equal with depths within 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointnerf_slam_tpu.frontend.feature_stack as jfs
import pointnerf_slam_tpu.frontend.nms as jnms
import pointnerf_slam_tpu.frontend.search as jse
import pointnerf_slam_torch.frontend.feature_stack as tfs
import pointnerf_slam_torch.frontend.nms as tnms
import pointnerf_slam_torch.frontend.search as tse
from pointnerf_slam_tpu.frontend.ba import bundle_adjustment as j_ba
from pointnerf_slam_tpu.frontend.mapstore import KeyFrame as JKeyFrame
from pointnerf_slam_tpu.frontend.mapstore import Map as JMap
from pointnerf_slam_tpu.frontend.mapstore import MapPoint as JMapPoint
from pointnerf_slam_torch.frontend.ba import bundle_adjustment as t_ba
from pointnerf_slam_torch.frontend.mapstore import KeyFrame, Map, MapPoint
from tests.test_ba import make_scene
from tests.test_feature_stack import checker
from tests.test_frontend import make_two_view
from tests.test_nms import cloud
from tests.torch_threads import share_cores

share_cores()


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# -- NMS ---------------------------------------------------------------------

NMS_CASES = {
    "grid": lambda m, c: m.grid_nms(c[0], c[1], c[2], c[3], c[4], cell=20),
    "grid_default": lambda m, c: m.grid_nms(c[0], c[1], c[2], c[3], c[4]),
    "kdt": lambda m, c: m.kdt_nms(c[0], c[1], c[2], radius=10.0),
    "ssc": lambda m, c: m.ssc_nms(c[0], c[1], c[2], c[3], c[4], k=50),
    "octree": lambda m, c: m.octree_nms(c[0], c[1], c[2], c[3], c[4], k=40),
}


@pytest.mark.parametrize("name", list(NMS_CASES))
@pytest.mark.parametrize("n,seed,invalid", [(300, 0, 0), (500, 1, 0),
                                            (400, 2, 150)])
def test_nms_matches_reference(name, n, seed, invalid):
    kps, scores, valid, H, W = cloud(n=n, seed=seed)
    valid[:invalid] = False
    c = (kps, scores, valid, H, W)
    ours, ref = NMS_CASES[name](tnms, c), NMS_CASES[name](jnms, c)
    assert ours.dtype == bool and ours.sum() > 5
    np.testing.assert_array_equal(ours, ref)
    assert not ours[:invalid].any()


# -- feature stack -----------------------------------------------------------

def blobs(shift=0):
    rng = np.random.default_rng(0)
    big = rng.normal(size=(80, 80)).astype(np.float32)
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5
    return big[2 + shift:66 + shift, 2:66]


@pytest.mark.parametrize("filt", ["none", "grid", "kdt", "ssc", "octree"])
def test_feature_manager_matches_reference(filt):
    img = blobs()
    cfg = dict(num_features=128, keypoint_filter=filt)
    kt, dt, vt = tfs.FeatureManager(
        tfs.FeatureManagerConfig(**cfg), device="cpu").detect_and_compute(img)
    kj, dj, vj = jfs.FeatureManager(
        jfs.FeatureManagerConfig(**cfg)).detect_and_compute(img)
    assert vt.sum() > 5
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(kt, kj, atol=1e-4)
    np.testing.assert_allclose(dt[vt], dj[vj], atol=1e-4)


def test_feature2d_adapter_matches_reference():
    kt, dt = tfs.SuperPointFeature2D(device="cpu").detectAndCompute(checker())
    kj, dj = jfs.SuperPointFeature2D().detectAndCompute(checker())
    assert len(kt) == len(dt) > 5
    assert set(map(tuple, np.floor(kt).astype(int))) == \
        set(map(tuple, np.floor(kj).astype(int)))
    np.testing.assert_allclose(np.linalg.norm(dt, axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("cfg", [dict(), dict(ratio_test=0.9),
                                 dict(cross_check=False),
                                 dict(ratio_test=0.8, cross_check=False)])
def test_matcher_matches_reference(cfg):
    rng = np.random.default_rng(0)
    d1 = rng.normal(size=(30, 16))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.roll(d1, 3, axis=0) + 0.1 * rng.normal(size=(30, 16))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v2 = rng.uniform(size=30) < 0.9
    ours = tfs.FeatureMatcher(tfs.MatcherConfig(**cfg), device="cpu").match(
        d1, d2, valid2=v2)
    ref = jfs.FeatureMatcher(jfs.MatcherConfig(**cfg)).match(
        d1, d2, valid2=v2)
    assert len(ours[0]) >= 20
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_feature_tracker_matches_reference():
    ours = tfs.FeatureTracker(device="cpu").track(blobs(0), blobs(1))
    ref = jfs.FeatureTracker().track(blobs(0), blobs(1))
    assert len(ours["idxs_ref"]) > 5
    for k in ("idxs_ref", "idxs_cur"):
        np.testing.assert_array_equal(ours[k], ref[k])
    for k in ("kps_ref_matched", "kps_cur_matched", "des_ref", "des_cur"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-4)
    d = np.linalg.norm(ours["kps_ref_matched"] - ours["kps_cur_matched"],
                       axis=1)
    assert float(np.median(d)) < 3.0


# -- search ------------------------------------------------------------------

def unit_desc(rng, n, d=16):
    x = rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 1.5])
def test_search_by_projection_matches_reference(noise):
    rng = np.random.default_rng(0)
    pts = rng.uniform([-1, -1, 4], [1, 1, 8], (40, 3)).astype(np.float32)
    fx = fy = 100.0
    cx = cy = 50.0
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, 3] = [0.05, -0.02, 0.1]
    pc = pts + Tcw[:3, 3]
    kps = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                    pc[:, 1] / pc[:, 2] * fy + cy], -1)
    kps = (kps + rng.normal(0, noise, kps.shape)).astype(np.float32)
    desc = unit_desc(rng, 40)
    kp_desc = desc + 0.05 * rng.normal(size=desc.shape).astype(np.float32)
    kp_desc /= np.linalg.norm(kp_desc, axis=1, keepdims=True)
    pt_valid = rng.uniform(size=40) < 0.9
    kp_valid = rng.uniform(size=40) < 0.9
    normal = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    max_dist = rng.uniform(5, 12, 40).astype(np.float32)
    args = (pts, desc, pt_valid, Tcw, kps, kp_desc, kp_valid)
    ours = tse.search_frame_by_projection(*map(T, args), fx, fy, cx, cy,
                                          radius_px=5.0, max_desc_dist=0.5)
    ref = jse.search_frame_by_projection(*map(jnp.asarray, args), fx, fy,
                                         cx, cy, 5.0, 0.5)
    margs = (pts, desc, pt_valid, normal.astype(np.float32), max_dist, Tcw,
             kps, kp_desc, kp_valid)
    ours_m = tse.search_map_by_projection(*map(T, margs), fx, fy, cx, cy,
                                          radius_px=5.0, max_desc_dist=0.5)
    ref_m = jse.search_map_by_projection(*map(jnp.asarray, margs), fx, fy,
                                         cx, cy, 5.0, 0.5)
    for a, b in zip(ours + ours_m, ref + ref_m):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 20 < int(ours[1].sum()) and 0 < int(ours_m[1].sum())


def test_epipolar_search_matches_reference():
    kpn_ref, kpn_cur, Trc, _, _ = make_two_view(n=40)
    R, t = Trc[:3, :3], Trc[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ R).astype(np.float32)
    rng = np.random.default_rng(1)
    desc = unit_desc(rng, 40)
    valid = rng.uniform(size=40) < 0.95
    args = (np.asarray(kpn_cur, np.float32), desc, valid,
            np.asarray(kpn_ref, np.float32), desc, np.ones(40, bool), E)
    ours = tse.search_frame_for_triangulation(*map(T, args))
    ref = jse.search_frame_for_triangulation(*map(jnp.asarray, args))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(ours[1].float().mean()) > 0.8


def test_propagate_matches_reference():
    rng = np.random.default_rng(3)
    has_pt = rng.uniform(size=12) < 0.5
    idx_ref = rng.permutation(12)
    idx_cur = np.arange(12)
    valid = rng.uniform(size=12) < 0.7
    args = (has_pt, idx_ref, idx_cur, valid)
    ours = tse.propagate_map_point_matches(*map(T, args))
    ref = jse.propagate_map_point_matches(*map(jnp.asarray, args))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _fuse_scene(pkg_map, pkg_point, pkg_kf):
    """Ten map points seen by one keyframe; a second keyframe whose first
    six keypoints are the points' projections and four slots already hold
    other points with more or fewer observations."""
    rng = np.random.default_rng(0)
    fx = fy = 100.0
    cx = cy = 50.0
    pts = rng.uniform([-1, -1, 4], [1, 1, 8], (10, 3))
    u = pts[:, 0] / pts[:, 2] * fx + cx
    v = pts[:, 1] / pts[:, 2] * fy + cy
    desc = unit_desc(rng, 10).astype(np.float64)
    kps = np.stack([u, v], -1)
    kps[6:] += 40.0                      # out of the search radius
    kf = pkg_kf(0, kps, desc, np.ones(10, bool), np.eye(4))
    m = pkg_map()
    other = pkg_kf(1, rng.uniform(0, 100, (10, 2)), unit_desc(rng, 10),
                   np.ones(10, bool), np.eye(4))
    for i in range(10):
        mp = pkg_point(pts[i])
        mp.add_observation(other, i, desc[i])
        m.points.append(mp)
    for slot in (2, 3):                  # slots already taken
        mp = pkg_point(pts[slot] + 0.01)
        mp.add_observation(kf, slot, desc[slot])
        if slot == 3:
            mp.add_observation(pkg_kf(2, kps, desc, np.ones(10, bool),
                                      np.eye(4)), slot, desc[slot])
        m.points.append(mp)
    return m, kf, (fx, fy, cx, cy)


def test_search_and_fuse_matches_reference():
    results = []
    for search, parts in ((tse, (Map, MapPoint, KeyFrame)),
                          (jse, (JMap, JMapPoint, JKeyFrame))):
        m, kf, cam = _fuse_scene(*parts)
        fused = search.search_and_fuse(m, kf, *cam, radius_px=3.0,
                                       max_desc_dist=0.3)
        slots = [None if p is None else (round(float(p.pt[0]), 6),
                                         p.num_observations, p.is_bad)
                 for p in kf.points]
        bad = [p.is_bad for p in m.points]
        results.append((fused, slots, bad))
    assert results[0] == results[1]
    assert results[0][0] >= 6


# -- bundle adjustment -------------------------------------------------------

def ba_problem(dtype, outliers=True):
    """tests/test_ba.py's joint-refinement scene; with outliers, 5% of the
    observations masked off and ten of camera 1's displaced."""
    pts, cams7, obs = make_scene(n_pts=120, n_cams=4)
    rng = np.random.default_rng(2)
    cams = np.asarray(cams7, np.float64)
    cams[2:] += rng.normal(0, 0.01, size=(2, 7))
    pts_p = pts + rng.normal(0, 0.02, size=pts.shape)
    valid = rng.uniform(size=obs.shape[:2]) < 0.95
    obs = np.array(obs)
    if outliers:
        obs[1, :10] += 0.05                 # for the Huber iterations
    else:
        valid[:] = True
    return ([a.astype(dtype) for a in (cams, pts_p, obs)] + [valid],
            np.array([True, True, False, False]), (cams7, pts))


@pytest.mark.parametrize("iters,l2_iters", [(30, 15), (6, 2)])
def test_bundle_adjustment_matches_reference_in_float64(iters, l2_iters):
    (cams, pts, obs, valid), fixed, _ = ba_problem(np.float64)
    with jax.enable_x64(True):
        cj, pj, xj = [np.asarray(a) for a in j_ba(
            jnp.asarray(cams), jnp.asarray(pts), jnp.asarray(obs),
            jnp.asarray(valid), jnp.asarray(fixed), sigma2=1e-6,
            iters=iters, l2_iters=l2_iters)]
    assert cj.dtype == np.float64
    ct, pt, xt = t_ba(T(cams), T(pts), T(obs), T(valid), T(fixed),
                      sigma2=1e-6, iters=iters, l2_iters=l2_iters)
    np.testing.assert_allclose(ct.numpy(), cj, atol=1e-9)
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-9)
    np.testing.assert_allclose(float(xt), float(xj), rtol=1e-6)
    np.testing.assert_array_equal(ct.numpy()[:2], cams[:2])


def test_bundle_adjustment_float32_meets_the_reference_bounds():
    """tests/test_ba.py's joint refinement, on the port."""
    (cams, pts, obs, valid), fixed, (cams7, pts_gt) = ba_problem(
        np.float32, outliers=False)
    ct, pt, chi2 = t_ba(T(cams), T(pts), T(obs), T(valid), T(fixed),
                        sigma2=1e-6, iters=30, l2_iters=15)
    cam_err0 = np.abs(cams - cams7).max()
    pt_err0 = np.abs(pts - pts_gt).max()
    assert np.abs(ct.numpy() - cams7).max() < 0.1 * cam_err0
    assert np.abs(pt.numpy() - pts_gt).max() < 0.25 * pt_err0
    assert float(chi2) < 1.0
    np.testing.assert_array_equal(ct.numpy()[:2], cams[:2])


# -- pseudo_depth_for (the map wiring) ---------------------------------------

@pytest.fixture(scope="module")
def box_seq():
    from tests.test_torch_frontend import box_frames
    return box_frames([0, 5, 10], orbit=0.06)


def _pseudo_runs(fe, ds, frames, field):
    """pseudo_depth_for at 5 (partner: the reference frame 0) and 10
    (partner with the map on: the cached keyframe 0, >= 8 frames older),
    at the gt poses; the field callback reads frame 10's depth."""
    f = {i: fr for i, fr in zip((0, 5, 10), frames)}
    est = np.stack([fr[3] for fr in frames])
    est = np.stack([est[0]] * 5 + [est[1]] * 5 + [est[2]])
    fe.median_gt_depth = float(np.median(f[0][2]))
    fe.prev = {"frame_idx": 0, "feats": fe._extract(f[0][1])}
    depth10 = f[10][2]

    def field_depth(uv):
        u = np.clip(np.round(np.asarray(uv)[:, 0]).astype(int), 0,
                    ds.W - 1)
        v = np.clip(np.round(np.asarray(uv)[:, 1]).astype(int), 0,
                    ds.H - 1)
        return depth10[v, u]

    out = [fe.pseudo_depth_for(f, 5, est, f[5][3]),
           fe.pseudo_depth_for(f, 10, est, f[10][3],
                               field_depth_fn=field_depth if field else None)]
    return [None if p is None else np.asarray(p) for p in out]


@pytest.mark.parametrize("map_points,field", [(True, True), (True, False),
                                              (False, False)])
def test_pseudo_depth_for_matches_reference(box_seq, map_points, field):
    from pointnerf_slam_tpu.frontend import SparseFrontend as JFE
    from pointnerf_slam_torch.frontend.frontend import SparseFrontend
    cfg, ds, frames = box_seq
    cfg = dict(cfg, map_points=map_points)
    cam = (ds.H, ds.W, ds.fx, ds.fy, ds.cx, ds.cy)
    fe_t = SparseFrontend(cfg, *cam, device="cpu")
    fe_j = JFE(cfg, *cam)
    ours = _pseudo_runs(fe_t, ds, frames, field)
    ref = _pseudo_runs(fe_j, ds, frames, field)
    keys = ("idx", "n_matches", "n_cand", "n_scale_ok", "n_field_ok",
            "n_accept")
    assert [{k: r[k] for k in keys} for r in fe_t.telemetry] == \
        [{k: r[k] for k in keys} for r in fe_j.telemetry]
    assert fe_t.prev["frame_idx"] == fe_j.prev["frame_idx"] == 10
    if map_points:
        assert len(fe_t.map.points) == len(fe_j.map.points) > 0
        assert fe_t.last_debug["ref_idx"] == fe_j.last_debug["ref_idx"] == 0
    for a, b, (_, _, depth, _) in zip(ours, ref, frames[1:]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        np.testing.assert_array_equal(a > 0, b > 0)
        m = b > 0
        np.testing.assert_allclose(a[m], b[m], rtol=1e-4)
        # known-pose triangulation: scene-consistent depth
        rel = np.abs(a[m] - depth[m]) / depth[m]
        assert m.sum() > 30 and float(np.median(rel)) < 0.3
