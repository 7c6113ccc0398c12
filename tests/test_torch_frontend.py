"""Each module of the port's sparse front-end against its JAX reference, on
the scenes the reference's own tests build (tests/test_frontend.py,
tests/test_ba.py) and on frames of the synthetic box room.

Random draws: the reference draws its RANSAC hypotheses with
jax.random.categorical per split key; `jax_hypotheses` repeats those
splits and the port is handed the same (n_hyp, 8) indices.

Bounds: matching, the orientation gate and the splat exactly; Harris
keypoints as the same set of integer pixels with sub-pixel positions,
descriptors and angles within 1e-4 (float32 summation order only);
triangulation within 1e-4 relative; RANSAC and the two-view steps with
equal inlier / accept masks up to 1% of the matches, rotation within
0.1 deg, translation direction cosine > 0.9999 (E up to sign: singular
vectors carry an arbitrary sign in either package, so E is compared up to
sign and the poses directly); the LM pose within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointnerf_slam_tpu.frontend.ba as jba
import pointnerf_slam_tpu.frontend.epipolar as jep
import pointnerf_slam_tpu.frontend.features as jfe
import pointnerf_slam_tpu.frontend.fused_twoview as jtv
import pointnerf_slam_tpu.frontend.matching as jma
import pointnerf_slam_tpu.frontend.pseudo_depth as jpd
import pointnerf_slam_tpu.frontend.rotation_histogram as jrh
import pointnerf_slam_tpu.frontend.triangulate as jtr
import pointnerf_slam_torch.frontend.ba as tba
import pointnerf_slam_torch.frontend.epipolar as tep
import pointnerf_slam_torch.frontend.features as tfe
import pointnerf_slam_torch.frontend.fused_twoview as ttv
import pointnerf_slam_torch.frontend.matching as tma
import pointnerf_slam_torch.frontend.pseudo_depth as tpd
import pointnerf_slam_torch.frontend.rotation_histogram as trh
import pointnerf_slam_torch.frontend.triangulate as ttr
from pointnerf_slam_torch.engine.state import Draws
from tests.test_frontend import make_two_view
from tests.torch_threads import share_cores

share_cores()

BOX_CAM = {"H": 120, "W": 160, "fx": 90.0, "fy": 90.0, "cx": 79.5,
           "cy": 59.5}


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def jax_hypotheses(key, match_valid, n_hyp=256):
    """The reference's hypothesis indices (epipolar.py:182-188)."""
    logits = jnp.where(match_valid, 0.0, -jnp.inf)
    logits = jnp.where(jnp.any(match_valid), logits, jnp.zeros_like(logits))
    keys = jax.random.split(key, n_hyp)
    return T(jax.vmap(lambda k: jax.random.categorical(
        k, logits, shape=(8,)))(keys)).long()


def rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb)) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def box_frames(idxs, orbit=0.06):
    from pointnerf_slam_torch.io.datasets import get_dataset
    from tests.test_engine import tiny_cfg
    cfg = tiny_cfg(data={"orbit": orbit, "n_frames": 12}, cam=BOX_CAM)
    ds = get_dataset(cfg)
    return cfg, ds, [ds[i] for i in idxs]


def test_matching_matches_reference():
    rng = np.random.default_rng(0)
    d1 = rng.normal(size=(60, 16)).astype(np.float32)
    d2 = np.concatenate([d1[:40] + 0.2 * rng.normal(size=(40, 16)),
                         rng.normal(size=(30, 16))]).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v1, v2 = rng.uniform(size=60) < 0.9, rng.uniform(size=70) < 0.9
    j = jma.match_two_way(d1, v1, d2, v2, 0.7)
    t = tma.match_two_way(T(d1), T(v1), T(d2), T(v2), 0.7)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), atol=1e-5)
    assert 20 < int(t[1].sum()) < 60


@pytest.mark.parametrize("seed,min_keep,min_frac", [(3, 0, 0.0),
                                                    (4, 16, 0.7)])
def test_rotation_histogram_matches_reference(seed, min_keep, min_frac):
    rng = np.random.default_rng(seed)
    M = 200
    delta = np.where(rng.uniform(size=M) < 0.7, rng.normal(0.4, 0.1, M),
                     rng.uniform(0, 2 * np.pi, M))
    ang_ref = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
    ang_cur = (ang_ref + delta).astype(np.float32)
    valid = rng.uniform(size=M) < 0.8
    j = jrh.filter_matches_with_histogram_orientation(
        ang_ref, ang_cur, valid, min_keep=min_keep, min_frac=min_frac)
    t = trh.filter_matches_with_histogram_orientation(
        T(ang_ref), T(ang_cur), T(valid), min_keep=min_keep,
        min_frac=min_frac)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_harris_matches_reference_on_a_room_frame():
    _, _, [(_, color, _, _)] = box_frames([0])
    gray = np.asarray(color, np.float32).mean(-1)
    kj, dj, vj, aj = [np.asarray(a) for a in
                      jfe.HarrisExtractor(max_kps=300).extract(
                          jnp.asarray(gray))]
    kt, dt, vt, at = [a.numpy() for a in
                      tfe.HarrisExtractor(max_kps=300).extract(T(gray))]
    assert vj.sum() > 100
    np.testing.assert_array_equal(vt, vj)
    # the same keypoints as a set of pixels, then element by element
    assert set(map(tuple, np.floor(kt[vt]).astype(int))) == \
        set(map(tuple, np.floor(kj[vj]).astype(int)))
    np.testing.assert_allclose(kt[vt], kj[vj], atol=1e-4)
    np.testing.assert_allclose(dt[vt], dj[vj], atol=1e-4)
    np.testing.assert_allclose(at[vt], aj[vj], atol=1e-4)


def test_harris_score_and_angles_match_reference():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(40, 52)).astype(np.float32)
    np.testing.assert_allclose(tfe.harris_score(T(img)).numpy(),
                               np.asarray(jfe.harris_score(img)), atol=1e-6)
    kps = rng.uniform(0, 40, (20, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tfe.intensity_centroid_angles(T(img), T(kps)).numpy(),
        np.asarray(jfe.intensity_centroid_angles(img, kps)), atol=1e-5)


def test_superpoint_raises_naming_its_queue_item():
    """SuperPoint is ported (ROADMAP Queue 1 item 11); the public
    checkpoint is not in the repository, and naming it raises, naming the
    file (tests/test_torch_superpoint.py holds the extractor itself)."""
    with pytest.raises(FileNotFoundError, match="superpoint_v1.pth"):
        tfe.SuperPointExtractor("pretrained/superpoint_v1.pth")


def _ransac_scene(kind):
    if kind == "clean":
        kr, kc, Trc, _, _ = make_two_view()
        return np.asarray(kr), np.asarray(kc), Trc, 3e-4
    if kind == "outliers":
        kr, kc, Trc, _, _ = make_two_view(n=300)
        rng = np.random.default_rng(3)
        kc = np.array(kc)
        out = rng.choice(300, 90, replace=False)
        kc[out] += rng.uniform(0.05, 0.3, size=(90, 2))
        return np.asarray(kr), kc.astype(np.float32), Trc, 3e-4
    # small baseline, 0.5 px noise at fx 600 (test_small_baseline_noisy)
    rng = np.random.default_rng(5)
    n, fx = 200, 600.0
    pts = rng.uniform([-2, -1.2, 1.5], [2, 1.2, 4.0], size=(n, 3))
    cr, sr = np.cos(0.02), np.sin(0.02)
    R_rc = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    t_rc = np.array([0.03, 0.004, 0.002])
    x_cur = (pts - t_rc) @ R_rc
    kr = pts[:, :2] / pts[:, 2:3] + rng.normal(0, 0.5 / fx, (n, 2))
    kc = x_cur[:, :2] / x_cur[:, 2:3] + rng.normal(0, 0.5 / fx, (n, 2))
    Trc = np.eye(4)
    Trc[:3, :3], Trc[:3, 3] = R_rc, t_rc
    return kr.astype(np.float32), kc.astype(np.float32), Trc, 1.0 / fx


@pytest.mark.parametrize("kind", ["clean", "outliers", "noisy"])
def test_ransac_matches_reference_with_replayed_hypotheses(kind):
    kr, kc, Trc_gt, th = _ransac_scene(kind)
    valid = np.ones(kr.shape[0], bool)
    valid[::17] = False
    key = jax.random.PRNGKey(2)
    Tj, inl_j, _ = jep.estimate_relative_pose_ransac(kr, kc, valid, key,
                                                     thresh=th)
    Tt, inl_t, n_t = tep.estimate_relative_pose_ransac(
        T(kr), T(kc), T(valid), jax_hypotheses(key, valid), thresh=th)
    Tj, Tt = np.asarray(Tj), Tt.numpy()
    mism = float((inl_t.numpy() != np.asarray(inl_j)).mean())
    assert mism <= 0.01, mism
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.1
    assert float(Tt[:3, 3] @ Tj[:3, 3]) > 0.9999
    assert rot_deg(Tt[:3, :3], Trc_gt[:3, :3]) < 1.0
    assert int(n_t) == int(inl_t.sum())


def test_eight_point_matches_reference_up_to_sign():
    kr, kc, _, _ = _ransac_scene("clean")
    Ej = np.asarray(jep._eight_point(kc[:8], kr[:8]))
    Et = tep._eight_point(T(kc[:8]), T(kr[:8])).numpy()
    s = np.sign((Ej * Et).sum())
    np.testing.assert_allclose(s * Et, Ej, atol=1e-4)
    np.testing.assert_allclose(
        tep._sampson(T(Et), T(kc), T(kr)).numpy(),
        np.asarray(jep._sampson(Ej, kc, kr)), rtol=1e-3, atol=1e-10)


def test_triangulation_and_checks_match_reference():
    kr, kc, _, Tcw_cur, _ = make_two_view(n=64)
    kc = np.array(kc)
    kc[:5] += 0.05                      # a few that fail the checks
    Tc = np.asarray(Tcw_cur, np.float32)
    I4 = np.eye(4, dtype=np.float32)
    pj, okj = jtr.triangulate_points(Tc, I4, kc, kr)
    pt, okt = ttr.triangulate_points(T(Tc), T(I4), T(kc), T(kr))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-4)
    cj = jtr.point_checks(pj, Tc, I4, kc, kr, 90.0)
    ct = ttr.point_checks(T(np.asarray(pj)), T(Tc), T(I4), T(kc), T(kr),
                          90.0)
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(cj[0]))
    assert 0 < int(ct[0].sum()) < 64
    for a, b in zip(ct[1:], cj[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_splat_matches_reference_including_overlaps():
    rng = np.random.default_rng(2)
    uv = rng.uniform(-3, [43, 33], (60, 2)).astype(np.float32)
    uv[30:40] = uv[20:30] + 1.0          # overlapping patches
    z = rng.uniform(0.5, 3, 60).astype(np.float32)
    valid = rng.uniform(size=60) < 0.8
    j = np.asarray(jpd.splat_pseudo_depth(uv, z, valid, 30, 40, 3))
    t = tpd.splat_pseudo_depth(T(uv), T(z), T(valid), 30, 40, 3).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t > 0).sum() > 100


def test_pose_optimization_matches_reference():
    from pointnerf_slam_torch.core.se3 import tensor_from_camera
    from tests.test_ba import make_scene
    pts, cams7, obs = make_scene(seed=1)
    rng = np.random.default_rng(1)
    noisy = obs[1] + rng.normal(0, 1e-3, obs[1].shape)
    noisy[:20] += 0.05                   # outliers
    init = cams7[1].copy()
    init[4:] += [0.02, -0.01, 0.03]
    valid = np.ones(len(pts), bool)
    cj, inl_j, _ = jba.pose_optimization(
        jnp.asarray(init), jnp.asarray(pts, jnp.float32),
        jnp.asarray(noisy, jnp.float32), valid, sigma2=1e-6)
    ct, inl_t, _ = tba.pose_optimization(
        T(init), T(pts, torch.float32), T(noisy, torch.float32), T(valid),
        sigma2=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert not inl_t[:20].any()
    assert tensor_from_camera is not None


def _two_view_inputs():
    from pointnerf_slam_torch.frontend.frontend import nerf_c2w_to_cv_w2c
    cfg, ds, frames = box_frames([0, 6])
    feats = []
    for _, color, _, _ in frames:
        gray = np.asarray(color, np.float32).mean(-1)
        feats.append(jfe.HarrisExtractor(max_kps=400).extract(
            jnp.asarray(gray)))
    Tcw_ref = nerf_c2w_to_cv_w2c(frames[0][3]).astype(np.float32)
    med = float(np.median(frames[0][2]))
    return ds, frames, feats, Tcw_ref, med


def _field_decoder():
    from pointnerf_slam_tpu.models.decoders import MLPConfig as JCfg
    from pointnerf_slam_tpu.models.decoders import init_mlp
    from pointnerf_slam_torch.models.decoders import (IMAPDecoder,
                                                      MLPConfig,
                                                      params_from_jax)
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
                n_blocks=4)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(3), jcfg))
    dec = IMAPDecoder(MLPConfig())
    dec.load_state_dict(params_from_jax(tree))
    return jcfg, tree, dec


@pytest.mark.parametrize("mode", ["bootstrap", "continuous", "field"])
def test_two_view_step_matches_reference(mode):
    """The fused two-view step's three variants on frames 0 and 6 of the
    box room, the same Harris features fed to both packages."""
    from pointnerf_slam_tpu.render.renderer import RenderConfig as JRC
    from pointnerf_slam_torch.render.renderer import RenderConfig
    ds, frames, feats, Tcw_ref, med = _two_view_inputs()
    fx, fy, cx, cy = 90.0, 90.0, 79.5, 59.5
    key = jax.random.PRNGKey(11)
    # the reference's match mask, to rebuild its hypothesis draws
    (kr, dr, vr, ar), (kc, dc, vc, ac) = feats
    idx2, mv, _ = jma.match_two_way(dc, vc, dr, vr, 0.7)
    mv = jrh.filter_matches_with_histogram_orientation(
        ar[idx2], ac, mv, min_keep=16, min_frac=0.7)
    jcfg, tree, dec = _field_decoder()
    bound = np.array([[-2.2, 2.2]] * 3, np.float32)
    c2w_pred = np.asarray(frames[1][3], np.float32)
    # the carried scale: the true baseline of the pair
    scale = float(np.linalg.norm(frames[1][3][:3, 3] - frames[0][3][:3, 3]))
    jstep = jtv.make_two_view_step(120, 160, fx, fy, cx, cy, 0.7, 1 / fx,
                                   mode, model_cfg=jcfg, rcfg=JRC())
    kp_j, sm_j = jstep(*feats[0], *feats[1], jnp.asarray(Tcw_ref), key,
                       jnp.float32(med), jnp.float32(scale),
                       jnp.float32(0.7), tree, {}, jnp.asarray(c2w_pred),
                       jnp.asarray(bound))
    tstep = ttv.make_two_view_step(120, 160, fx, fy, cx, cy, 1 / fx, mode,
                                   rcfg=RenderConfig())
    tfeats = [tuple(T(np.asarray(a)) for a in f) for f in feats]
    kp_t, sm_t = tstep(tfeats[0], tfeats[1], T(Tcw_ref),
                       Draws(replay=[jax_hypotheses(key, mv)]), med, scale,
                       0.7, dec, T(c2w_pred), T(bound))
    kp_j, sm_j = np.asarray(kp_j), np.asarray(sm_j)
    kp_t, sm_t = kp_t.numpy(), sm_t.numpy()
    Tj, Tt = sm_j[:16].reshape(4, 4), sm_t[:16].reshape(4, 4)
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.1
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], rtol=2e-3, atol=1e-4)
    acc_j, acc_t = kp_j[:, 6] > 0.5, kp_t[:, 6] > 0.5
    assert acc_j.sum() > 20
    assert float((acc_j != acc_t).mean()) <= 0.01
    # counts: matches exactly, the rest within 1% of the matches
    assert sm_t[16] == sm_j[16]
    np.testing.assert_allclose(sm_t[17:22], sm_j[17:22],
                               atol=max(1.0, 0.01 * sm_j[16]))
    np.testing.assert_allclose(sm_t[22:27], sm_j[22:27], rtol=2e-3,
                               atol=1e-5)
    both = acc_j & acc_t
    np.testing.assert_allclose(kp_t[both][:, :6], kp_j[both][:, :6],
                               rtol=2e-3, atol=2e-3)


def test_convention_bridge_and_pose_error_match_reference():
    """nerf_c2w_to_cv_w2c, its inverse and compute_pose_error on random
    rigid poses, against the reference's numpy functions."""
    import pointnerf_slam_tpu.frontend.frontend as jff
    import pointnerf_slam_torch.frontend.frontend as tff
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(4)
    poses = []
    for _ in range(2):
        P = np.eye(4)
        P[:3, :3] = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        P[:3, 3] = rng.normal(size=3)
        poses.append(P)
    for P in poses:
        w2c = tff.nerf_c2w_to_cv_w2c(P)
        np.testing.assert_array_equal(w2c, jff.nerf_c2w_to_cv_w2c(P))
        np.testing.assert_array_equal(tff.cv_w2c_to_nerf_c2w(w2c),
                                      jff.cv_w2c_to_nerf_c2w(w2c))
        np.testing.assert_allclose(tff.cv_w2c_to_nerf_c2w(w2c), P,
                                   atol=1e-12)
    assert tff.compute_pose_error(*poses) == jff.compute_pose_error(*poses)
    assert tff.compute_pose_error(poses[0], poses[0]) == pytest.approx(
        (0.0, 0.0), abs=1e-4)


def test_bootstrap_on_synthetic_pair():
    """SparseFrontend.bootstrap on frames 0 and 5 of the box room with the
    port's own draws, held to the reference test's bounds
    (tests/test_frontend.py test_bootstrap_on_synthetic)."""
    from pointnerf_slam_torch.frontend.frontend import SparseFrontend
    cfg, ds, frames = box_frames([0, 5], orbit=0.06)
    fe = SparseFrontend(cfg, ds.H, ds.W, ds.fx, ds.fy, ds.cx, ds.cy)
    c2w0, (_, _, depth5, gt5) = frames[0][3], frames[1]
    est5, pseudo0, pseudo5 = fe.bootstrap(ds, 0, 5, c2w0)
    t_est = est5[:3, 3] - c2w0[:3, 3]
    t_gt = gt5[:3, 3] - c2w0[:3, 3]
    cos = float(t_est @ t_gt / (np.linalg.norm(t_est)
                                * np.linalg.norm(t_gt) + 1e-12))
    assert cos > 0.95, cos
    assert rot_deg(est5[:3, :3], gt5[:3, :3]) < 3.0
    p5 = pseudo5.numpy()
    m = p5 > 0.01
    assert m.sum() > 50
    rel = np.abs(p5[m] - depth5[m]) / depth5[m]
    assert float(np.median(rel)) < 0.1, np.median(rel)
    assert fe.prev["frame_idx"] == 5 and fe.map is not None
    assert len(fe.map.points) > 0


def test_flagship_bootstrap_frame_matches_reference():
    """Where the flagship (room_bench_weak, 680x1200, Harris) first
    bootstraps on its 500-frame orbit: both packages refuse frame 5 (too
    few triangulations) and frame 10 (parallax under the 2 deg gate) and
    bootstrap at frame 15, each with its own RANSAC draws, within 5 cm of
    gt and within 1 cm of each other."""
    import os
    from pointnerf_slam_tpu.frontend import SparseFrontend as JFE
    from pointnerf_slam_tpu.io.config import load_config as jload
    from pointnerf_slam_torch.frontend.frontend import SparseFrontend
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.io.datasets import get_dataset
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "configs/Synthetic/room_bench_weak.yaml")
    cfg = load_config(path)
    cfg["data"]["frame_cache_dir"] = ""
    ds = get_dataset(cfg, None, cfg["scale"])
    frames = {i: ds[i] for i in (0, 5, 10, 15)}
    est = {}
    for name, make in (("jax", lambda: JFE(jload(path), ds.H, ds.W, ds.fx,
                                            ds.fy, ds.cx, ds.cy)),
                       ("torch", lambda: SparseFrontend(
                           cfg, ds.H, ds.W, ds.fx, ds.fy, ds.cx, ds.cy,
                           device="cpu"))):
        for idx in (5, 10):
            with pytest.raises(RuntimeError):
                make().bootstrap(frames, 0, idx, frames[0][3])
        est[name] = make().bootstrap(frames, 0, 15, frames[0][3])[0]
        err = np.linalg.norm(est[name][:3, 3] - frames[15][3][:3, 3])
        assert err < 0.05, (name, err)
    assert np.linalg.norm(est["jax"][:3, 3] - est["torch"][:3, 3]) < 0.01
