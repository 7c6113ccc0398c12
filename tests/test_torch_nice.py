"""NICE mode in the port against the JAX reference: the trilinear
sampler, the grids and their frustum masks, the NICE decoder family, the
renderer's NICE sampling, the staged mapper, overlap keyframe selection,
NICE checkpoints in both directions, and the NICE system end to end at
tests/test_nice_mode.py's configuration. Inputs are made from seeds with
numpy; the reference's draws are replayed where the port takes draws."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.engine import PointNeRFSLAM as JSLAM
from pointnerf_slam_tpu.engine.mapper import make_mapper_step as j_mapper
from pointnerf_slam_tpu.engine.state import EngineConfig as JEC
from pointnerf_slam_tpu.core.rays import sample_uv_uniform
from pointnerf_slam_tpu.io.config import load_config as j_load_config
from pointnerf_slam_tpu.models import decoders as JD
from pointnerf_slam_tpu.models import grids as JG
from pointnerf_slam_tpu.ops.grid_sample import trilinear_sample as j_tri
from pointnerf_slam_tpu.render import renderer as JR
from pointnerf_slam_torch.engine import PointNeRFSLAM
from pointnerf_slam_torch.engine.mapper import make_mapper_step
from pointnerf_slam_torch.engine.state import Draws, EngineConfig
from pointnerf_slam_torch.io.config import load_config
from pointnerf_slam_torch.models import decoders as TD
from pointnerf_slam_torch.models import grids as TG
from pointnerf_slam_torch.ops.grid_sample import trilinear_sample
from pointnerf_slam_torch.render import renderer as TR
from tests.test_nice_mode import nice_cfg
from tests.torch_threads import share_cores

share_cores()


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("seed", [0, 1])
def test_trilinear_sample_values_and_gradients(seed):
    """Values and both gradients (grid, points) at atol 1e-6, with points
    inside and outside [-1, 1] (border clamping)."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(5, 6, 7, 4)).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, (300, 3)).astype(np.float32)
    w = rng.normal(size=(300, 4)).astype(np.float32)
    out_j = np.asarray(j_tri(grid, pts))
    gg_j, gp_j = jax.grad(lambda g, p: jnp.sum(j_tri(g, p) * w),
                          argnums=(0, 1))(grid, pts)
    g_t, p_t = T(grid).requires_grad_(True), T(pts).requires_grad_(True)
    out_t = trilinear_sample(g_t, p_t)
    (out_t * T(w)).sum().backward()
    assert (np.abs(pts) > 1).any(axis=1).sum() > 50
    np.testing.assert_allclose(N(out_t), out_j, atol=1e-6)
    np.testing.assert_allclose(N(g_t.grad), np.asarray(gg_j), atol=1e-6)
    np.testing.assert_allclose(N(p_t.grad), np.asarray(gp_j), atol=1e-6)


def test_trilinear_axis_order_is_the_reference_layout():
    """A point's x indexes the grid's first axis: a grid that varies only
    along x gives x's interpolation."""
    grid = torch.zeros(3, 4, 5, 1)
    grid[:, :, :, 0] = torch.arange(3.0)[:, None, None]
    p = torch.tensor([[0.0, -1.0, 1.0], [1.0, 0.3, -0.2]])
    np.testing.assert_allclose(N(trilinear_sample(grid, p))[:, 0], [1.0, 2.0])


# ------------------------------------------------------------------ grids

def test_init_grids_shapes_match_reference():
    """Shapes at tests/test_nice_mode.py's nice_cfg and at
    configs/nice_slam.yaml's defaults; values 0.01 * N(0, 1)."""
    for cfg in (nice_cfg(), j_load_config("configs/nice_slam.yaml")):
        bound = np.array(cfg["mapping"]["bound"], np.float32) * cfg["scale"]
        gj = JG.init_grids(jax.random.PRNGKey(0), cfg, bound)
        gt = TG.init_grids(torch.Generator().manual_seed(0), cfg, bound)
        assert list(gt) == list(gj)
        for k in gj:
            assert tuple(gt[k].shape) == tuple(gj[k].shape), k
            assert 0.005 < float(gt[k].abs().mean()) < 0.012
    cfg = load_config("configs/nice_slam.yaml")
    assert cfg["coarse"] and "grid_coarse" in TG.grid_shapes(
        cfg, np.array(cfg["mapping"]["bound"]))


def look_at(eye, target):
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, u, -f, eye
    return c2w.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frustum_masks_equal_cell_for_cell(seed):
    """Every level of nice_cfg's grids, a camera inside the room looking
    at a random point, a depth map with holes: equal masks."""
    cfg = nice_cfg()
    rng = np.random.default_rng(seed)
    H, W, fx, fy, cx, cy = 40, 52, 30.0, 30.0, 25.5, 19.5
    bound = np.array(cfg["mapping"]["bound"], np.float32)
    c2w = look_at(rng.uniform(-1.0, 1.0, 3), rng.uniform(-1.5, 1.5, 3))
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    for name, shape in TG.grid_shapes(cfg, bound).items():
        mj = np.asarray(JG.make_frustum_mask_fn(shape, H, W, fx, fy, cx, cy)(
            jnp.asarray(bound), jnp.asarray(c2w), jnp.asarray(depth)))
        mt = N(TG.make_frustum_mask_fn(shape, H, W, fx, fy, cx, cy)(
            T(bound), T(c2w), T(depth)))
        assert mt.shape == mj.shape == shape + (1,)
        assert 0 < mj.sum() < mj.size, name
        np.testing.assert_array_equal(mt, mj, err_msg=name)


# --------------------------------------------------------------- decoders

BOUND = np.array([[-2.2, 2.2]] * 3, np.float32)


def nice_setup(seed, pos="fourier", coarse=True, c_dim=8, hidden=8):
    jcfg = JD.NICEConfig(c_dim=c_dim, hidden_size=hidden, coarse=coarse,
                         coarse_grid_len=1.2, middle_grid_len=0.6,
                         fine_grid_len=0.4, color_grid_len=0.4,
                         pos_embedding_method=pos)
    tree = jax.tree_util.tree_map(np.asarray, JD.init_nice(
        jax.random.PRNGKey(seed), jcfg))
    cfg = nice_cfg(model={"c_dim": c_dim, "hidden_size": hidden,
                          "pos_embedding_method": pos}, coarse=coarse)
    grids_j = jax.tree_util.tree_map(np.asarray, JG.init_grids(
        jax.random.PRNGKey(seed + 1), cfg, BOUND))
    # feature values of a trained grid's scale, not the 0.01 init
    grids_j = {k: v * 30.0 for k, v in grids_j.items()}
    tcfg, make = TD.get_model(cfg, nice=True)
    dec = make()
    dec.load_state_dict(TD.params_from_jax(tree))
    return jcfg, tree, grids_j, tcfg, dec, TD.grids_from_jax(grids_j)


@pytest.mark.parametrize("pos", ["fourier", "nerf", "same", "fc_relu"])
def test_apply_nice_each_stage_matches_reference(pos):
    """apply_nice at coarse, middle, fine and color with the reference's
    weights and grids (params_from_jax, grids_from_jax): rtol 1e-5."""
    jcfg, tree, grids_j, tcfg, dec, grids_t = nice_setup(3, pos)
    assert tcfg.sub_configs == {k: TD.MLPConfig(**{
        f: getattr(v, f) for f in TD.MLPConfig.__dataclass_fields__})
        for k, v in jcfg.sub_configs.items()}
    pts = np.random.default_rng(4).uniform(-2.5, 2.5, (400, 3)).astype(
        np.float32)
    for stage in ("coarse", "middle", "fine", "color"):
        a = N(dec(T(pts), grids_t, stage, T(BOUND)))
        b = np.asarray(JD.apply_nice(tree, jcfg, pts, grids_j, stage, BOUND))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(
            b).max(), err_msg=stage)


@pytest.mark.parametrize("leaky,skips,concat,no_xyz", [
    (True, (2,), False, False), (False, (1, 2), True, False),
    (False, (2,), False, True)])
def test_apply_mlp_general_path_and_grid_gradient(leaky, skips, concat,
                                                  no_xyz):
    """The general apply_mlp (fc_c per block, skips, concat_feature with
    the middle feature detached, no_xyz, leaky): outputs rtol 1e-5 and
    the gradient with respect to every grid atol 1e-5 of its scale (the
    middle grid gets none through concat_feature)."""
    c_dim = 16 if no_xyz else 6     # no_xyz: the feature is the input
    jc = JD.MLPConfig(name="fine" if not no_xyz else "coarse", c_dim=c_dim,
                      hidden_size=16, n_blocks=4, leaky=leaky, skips=skips,
                      color=False, concat_feature=concat, no_xyz=no_xyz)
    tc = TD.MLPConfig(**{f: getattr(jc, f)
                         for f in TD.MLPConfig.__dataclass_fields__})
    tree = jax.tree_util.tree_map(np.asarray,
                                  JD.init_mlp(jax.random.PRNGKey(7), jc))
    m = TD.MLP(tc)
    m.load_state_dict(TD.params_from_jax(tree))
    rng = np.random.default_rng(7)
    grids = {k: rng.normal(size=(6, 5, 7, c_dim)).astype(np.float32) * 0.3
             for k in ("grid_fine", "grid_middle", "grid_coarse")}
    pts = rng.uniform(-2.0, 2.0, (200, 3)).astype(np.float32)
    w = rng.normal(size=200).astype(np.float32)
    out_j = np.asarray(JD.apply_mlp(tree, jc, pts, grids, BOUND))
    g_j = jax.grad(lambda g: jnp.sum(JD.apply_mlp(tree, jc, pts, g, BOUND)
                                     * w))(grids)
    gt = {k: T(v).requires_grad_(True) for k, v in grids.items()}
    out_t = m(T(pts), gt, T(BOUND))
    (out_t * T(w)).sum().backward()
    np.testing.assert_allclose(N(out_t), out_j, rtol=1e-5,
                               atol=1e-5 * np.abs(out_j).max())
    for k, g in g_j.items():
        g = np.asarray(g)
        got = np.zeros_like(g) if gt[k].grad is None else N(gt[k].grad)
        np.testing.assert_allclose(got, g, atol=1e-5 * max(np.abs(g).max(),
                                                           1.0), err_msg=k)
    if concat:
        assert gt["grid_middle"].grad is None


def test_params_and_grids_round_trip_the_reference_tree():
    _, tree, grids_j, _, dec, grids_t = nice_setup(5)
    back = TD.params_to_jax(dec.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    for k in grids_j:
        np.testing.assert_array_equal(N(grids_t[k]), grids_j[k])


# --------------------------------------------------------------- renderer

@pytest.mark.parametrize("case", ["nice_surface_occupancy", "lindisp_perturb",
                                  "nice_perturb_importance"])
def test_render_rays_nice_sampling(case):
    """render_rays with the surface band, occupancy compositing,
    N_importance 0, lindisp and the reference's perturb uniforms replayed:
    depth, variance and colour rtol 1e-4."""
    jcfg, tree, grids_j, tcfg, dec, grids_t = nice_setup(8)
    rng = np.random.default_rng(8)
    n = 96
    ro = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    gt = rng.uniform(0.5, 2.0, n).astype(np.float32)
    if case != "lindisp_perturb":     # lindisp needs near = 0.01 d > 0
        gt[::7] = 0.0
    kw = {"nice_surface_occupancy": dict(N_samples=10, N_surface=6,
                                         N_importance=0, occupancy=True),
          "lindisp_perturb": dict(N_samples=12, N_importance=4,
                                  lindisp=True, perturb=1.0),
          "nice_perturb_importance": dict(N_samples=10, N_surface=4,
                                          N_importance=5, perturb=1.0,
                                          occupancy=True)}[case]
    key = jax.random.PRNGKey(9)
    out_j = JR.render_rays(tree, jcfg, JR.RenderConfig(**kw), ro, rd, BOUND,
                           key, gt, c_grid=grids_j, stage="color")
    t_rand = u_imp = None
    if kw.get("perturb"):
        k_s, k_i = jax.random.split(key)
        t_rand = T(jax.random.uniform(k_s, (n, kw["N_samples"])))
        if kw["N_importance"]:
            u_imp = T(jax.random.uniform(k_i, (n, kw["N_importance"])))
    out_t = TR.render_rays(dec, TR.RenderConfig(**kw), T(ro), T(rd),
                           T(BOUND), T(gt), c_grid=grids_t, stage="color",
                           t_rand=t_rand, u_imp=u_imp)
    for a, b, name in zip(out_t, out_j, ("depth", "var", "color", "w")):
        b = np.asarray(b)
        np.testing.assert_allclose(N(a), b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-3),
                                   err_msg=name)


def test_render_rays_refuses_perturb_without_uniforms():
    *_, dec, grids_t = nice_setup(2)
    with pytest.raises(ValueError, match="uniforms"):
        TR.render_rays(dec, TR.RenderConfig(perturb=1.0), torch.zeros(4, 3),
                       torch.ones(4, 3), T(BOUND), torch.ones(4),
                       c_grid=grids_t)


# ----------------------------------------------------------------- mapper

H, W, F = 16, 20, 2
N_MAP, ITERS = 120, 3


def mapper_draws(key, iters):
    """The reference NICE mapper's draws (loss_fn, one pixel batch per
    iteration; occupancy: no regulation uniforms)."""
    ppf = N_MAP // F
    out = []
    for k in jax.random.split(key, iters):
        ks = jax.random.split(k, F + 1)
        out.append(torch.stack([
            T(sample_uv_uniform(ks[f], W, 0, H, 0, W, ppf)).long()
            for f in range(F)]))
    return out


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_mapper_stage_matches_reference(stage):
    """One mapper call per stage with the stage's learning rates, grid
    masks on, BA at 'color': per-iteration losses rtol 1e-3, the grid and
    decoder updates within 2e-2 of their scale, masked cells exactly 0,
    and only the stage's trained decoders moved."""
    jcfg, tree, grids_j, tcfg, dec, grids_t = nice_setup(11)
    cfg = nice_cfg()
    st = cfg["mapping"]["stage"][stage]
    grid_lrs = {k: st[f"{k[5:]}_lr"] for k in grids_j}
    ekw = dict(H=H, W=W, fx=14.0, fy=14.0, cx=9.5, cy=7.5,
               mapping_pixels=N_MAP, weak_depth=False, occupancy=True,
               BA=True, fix_fine=False, fix_color=False)
    rc = dict(N_samples=10, N_surface=6, N_importance=0, occupancy=True)
    rng = np.random.default_rng(11)
    colors = (rng.uniform(size=(F, H, W, 3)) * 255).astype(np.uint8)
    depths = rng.uniform(0.5, 2.5, (F, H, W)).astype(np.float32)
    cams = np.array([[1.0, 0, 0, 0, 0, 0, 1.0],
                     [1.0, 0.01, 0, 0, 0.05, 0, 1.0]], np.float32)
    valid = np.ones(F, bool)
    ba = np.array([False, stage == "color"])
    masks_j = {k: (rng.uniform(size=v.shape[:3] + (1,)) < 0.7).astype(
        np.float32) for k, v in grids_j.items()}
    key = jax.random.PRNGKey(12)
    jstep = j_mapper(jcfg, JR.RenderConfig(**rc), JEC(**ekw), F,
                     stage=stage, grid_lrs=grid_lrs,
                     decoders_lr=st["decoders_lr"], use_grid_masks=True)
    p_j, g_j, c_j, l_j = jstep(tree, grids_j, colors, depths, cams, valid,
                               ba, BOUND, key, masks_j, ITERS)
    sd0 = {k: v.clone() for k, v in dec.state_dict().items()}
    g0 = {k: v.clone() for k, v in grids_t.items()}
    c_t, l_t = make_mapper_step(
        tcfg, TR.RenderConfig(**rc), EngineConfig(**ekw), F, stage=stage,
        grid_lrs=grid_lrs, decoders_lr=st["decoders_lr"])(
        dec, T(colors), T(depths), T(cams), T(valid), T(ba), T(BOUND),
        Draws(replay=mapper_draws(key, ITERS)), ITERS, grids_t,
        {k: T(v) for k, v in masks_j.items()})
    np.testing.assert_allclose(N(l_t), np.asarray(l_j), rtol=1e-3)
    for k in grids_j:
        d_j = np.asarray(g_j[k]) - grids_j[k]
        d_t = N(grids_t[k] - g0[k])
        assert not d_t[masks_j[k][..., 0] == 0].any(), k
        scale = max(np.abs(d_j).max(), 1e-12)
        assert np.abs(d_t - d_j).max() <= 2e-2 * scale, (k, scale)
        assert (np.abs(d_j).max() > 0) == (np.abs(d_t).max() > 0), k
    flat_j = TD.params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
    for k, v in dec.state_dict().items():
        d_t = N(v - sd0[k])
        d_j = N(flat_j[k] - sd0[k])
        scale = max(np.abs(d_j).max(), 1e-12)
        assert np.abs(d_t - d_j).max() <= 2e-2 * scale, (k, scale)
        level = k.split(".")[0]
        if level in ("middle", "coarse") or st["decoders_lr"] == 0:
            assert not d_t.any(), k
    np.testing.assert_allclose(N(c_t), np.asarray(c_j), atol=1e-5)


# ---------------------------------------------------------------- tracker

def with_scan_outputs(step):
    """The reference tracking step, jitted so that it also returns its
    scan's per-iteration losses (the step itself returns only the
    first): jax.lax.scan is wrapped while the step traces."""
    from unittest import mock
    raw = step.__wrapped__
    scan = jax.lax.scan

    def f(*args):
        ys = []

        def recording_scan(*a, **kw):
            out = scan(*a, **kw)
            ys.append(out[1])
            return out

        with mock.patch.object(jax.lax, "scan", recording_scan):
            out = raw(*args)
        return out, ys[-1]

    return jax.jit(f)


def test_nice_tracking_step_matches_reference():
    """The NICE tracker (plain branch, 'color' stage, handle_dynamic)
    against the reference's, pixel draws replayed: per-iteration losses
    rtol 1e-3 and the best camera within 1e-5. The frame is the field's
    own render at the gt camera (grids at 3x their init scale); the start
    is 2 cm off, and the loss falls in both."""
    from pointnerf_slam_tpu.engine.tracker import make_tracking_step as jt
    from pointnerf_slam_torch.core.rays import rays_from_uv
    from pointnerf_slam_torch.core.se3 import camera_from_tensor
    from pointnerf_slam_torch.engine.tracker import make_tracking_step
    jcfg, tree, grids_j, tcfg, dec, grids_t = nice_setup(13)
    grids_j = {k: v * 0.1 for k, v in grids_j.items()}
    grids_t = {k: v * 0.1 for k, v in grids_t.items()}
    n, iters = 150, 8
    rc = dict(N_samples=10, N_surface=6, N_importance=0, occupancy=True)
    ekw = dict(H=H, W=W, fx=14.0, fy=14.0, cx=9.5, cy=7.5,
               tracking_pixels=n, num_cam_iters=iters, weak_depth=False,
               depth_supervision=True, handle_dynamic=True, cam_lr=2e-3,
               w_color_loss_t=0.2)
    cam_gt = np.array([1.0, 0, 0, 0, 0, 0, 1.0], np.float32)
    cam0 = cam_gt + np.array([0, 0, 0, 0, 0.02, 0, 0], np.float32)
    jj, ii = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    ro, rd = rays_from_uv(T(ii.reshape(-1)), T(jj.reshape(-1)),
                          camera_from_tensor(T(cam_gt)), 14.0, 14.0, 9.5,
                          7.5)
    params = dec.params()
    with torch.no_grad():
        dep, _, col, _ = TR.render_rays(
            lambda x, g, st, b: TD.apply_nice(params, tcfg, x, g, st, b),
            TR.RenderConfig(**rc), ro, rd, T(BOUND),
            torch.full((H * W,), 2.0), c_grid=grids_t)
    depth = N(dep).reshape(H, W)
    color = N(col).reshape(H, W, 3).clip(0, 1)
    key = jax.random.PRNGKey(3)
    (bc_j, bl_j, fl_j), l_j = with_scan_outputs(
        jt(jcfg, JR.RenderConfig(**rc), JEC(**ekw)))(
        tree, grids_j, cam0, color, depth, BOUND, key)
    draws = [T(sample_uv_uniform(jax.random.split(k)[0], W, 0, H, 0, W,
                                 n)).long()
             for k in jax.random.split(key, iters)]
    bc_t, bl_t, fl_t, l_t = make_tracking_step(
        tcfg, TR.RenderConfig(**rc), EngineConfig(**ekw))(
        dec, T(cam0), T(color), T(depth), T(BOUND), Draws(replay=draws),
        grids_t)
    np.testing.assert_allclose(N(l_t), np.asarray(l_j), rtol=1e-3)
    np.testing.assert_allclose(float(bl_t), float(bl_j), rtol=1e-3)
    np.testing.assert_allclose(N(bc_t), np.asarray(bc_j), atol=1e-5)
    assert float(l_j[-1]) < 0.2 * float(l_j[0])
    assert np.abs(np.asarray(bc_j) - cam0).max() > 1e-3


# ----------------------------------------------------------------- system

def systems(n_frames=5):
    """The reference's and the port's NICE systems at nice_cfg, the port
    starting from the reference's initial weights and grids (the two
    packages' generators draw different ones), the reference on one
    device as the port (tests/conftest.py's eight virtual CPU devices
    would shard its mapper's pixels)."""
    cfg = nice_cfg(data={"n_frames": n_frames, "orbit": 0.04},
                   parallel={"data_devices": 1})
    j = JSLAM(copy.deepcopy(cfg))
    t = PointNeRFSLAM(copy.deepcopy(cfg), device="cpu")
    t.decoder.load_state_dict(TD.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j.params)))
    t.c_grid = TD.grids_from_jax({k: np.asarray(v)
                                  for k, v in j.c_grid.items()})
    return j, t


def test_overlap_selection_equal_given_the_same_rng():
    """'overlap' scoring and the np_rng draws: the same window from the
    same keyframes, depth and pose (one keyframe moved 50 m away)."""
    j, t = systems()
    for k in range(4):
        _, color, depth, c2w = j.frame_reader[k]
        if k == 2:
            c2w = c2w.copy()
            c2w[:3, 3] += 50.0
        u8 = (np.asarray(color) * 255).astype(np.uint8)
        j.keyframes.insert(k, u8, depth, j._cam7(c2w), j._cam7(c2w))
        t.keyframes.insert(k, u8, depth, t._cam7(c2w),
                           gt_c2w7=t._cam7(c2w))
    _, _, depth, c2w = j.frame_reader[4]
    for seed in range(3):
        j.np_rng = np.random.default_rng(seed)
        t.np_rng = np.random.default_rng(seed)
        cj = j._overlap_select(None, depth, c2w, 4, 2)
        ct = t._overlap_select(T(depth), c2w, 4, 2)
        assert [int(c) for c in ct] == [int(c) for c in cj]
    sj = np.asarray(j._overlap_scores_fn()(
        jnp.asarray(np.zeros((1, 3), np.float32)), j.keyframes.est_c2w))
    st = t._overlap_scores(torch.zeros(1, 3), 4)
    np.testing.assert_array_equal(st, sj[:4])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_nice_checkpoint_restores_in_the_other_package(writer, tmp_path):
    """A checkpoint with the NICE decoder tree and grids (grid_{i},
    n_grids) written by one package restores bit for bit in the other."""
    from pointnerf_slam_tpu.outputs.logger import Logger as JLogger
    from pointnerf_slam_tpu.outputs.logger import resume_slam as j_resume
    from pointnerf_slam_torch.outputs.logger import Logger as TLogger
    from pointnerf_slam_torch.outputs.logger import resume_slam as t_resume
    j, t = systems()
    _, _, grids_j, _, dec, grids_t = nice_setup(13)
    j.c_grid = {k: jnp.asarray(v) for k, v in grids_j.items()}
    t.c_grid = grids_t
    t.decoder.load_state_dict(dec.state_dict())
    j.params = jax.tree_util.tree_map(jnp.asarray, TD.params_to_jax(
        dec.state_dict()))
    src, dst = (j, t) if writer == "jax" else (t, j)
    for s in (src, dst):
        s.output = str(tmp_path)
    zero = {k: v * 0 for k, v in (dst.c_grid.items())}
    if writer == "jax":
        JLogger(str(tmp_path), 500, 5).log(j, 0)
        t.c_grid = {k: torch.zeros_like(v) for k, v in t.c_grid.items()}
        with torch.no_grad():
            for p in t.decoder.parameters():
                p.zero_()
        t_resume(t, str(tmp_path / "ckpts" / "00000.npz"))
    else:
        TLogger(str(tmp_path), 500, 5).log(t, 0)
        j.c_grid = zero
        j.params = jax.tree_util.tree_map(jnp.zeros_like, j.params)
        j_resume(j, str(tmp_path / "ckpts" / "00000.npz"))
    z = np.load(tmp_path / "ckpts" / "00000.npz")
    assert int(z["n_grids"]) == 4
    for k, v in grids_j.items():
        np.testing.assert_array_equal(N(t.c_grid[k]), v)
        np.testing.assert_array_equal(np.asarray(j.c_grid[k]), v)
    flat = TD.params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    for k, v in t.decoder.state_dict().items():
        np.testing.assert_array_equal(N(v), N(flat[k]))


@pytest.fixture(scope="module")
def nice_runs():
    j, t = systems(3)
    g0 = {k: N(v).copy() for k, v in t.c_grid.items()}
    j.run()
    t.run()
    return j, t, g0


def test_nice_system_end_to_end(nice_runs):
    """The NICE system at nice_cfg, 3 frames, in both packages from the
    same initial weights and grids (their own pixel draws): finite poses
    near gt, every trained grid moved, the same mapping events (frame,
    stage, length), and per event the port's end loss within a factor 2
    of the reference's (frame 0's stages fall from 900-1100 to 40-270 in
    both; draws alone move an end loss by ~25%)."""
    j, t, g0 = nice_runs
    assert np.isfinite(t.estimate_c2w_list).all()
    err = np.linalg.norm(t.estimate_c2w_list[:, :3, 3]
                         - t.gt_c2w_list[:, :3, 3], axis=1)
    err_j = np.linalg.norm(j.estimate_c2w_list[:, :3, 3]
                           - j.gt_c2w_list[:, :3, 3], axis=1)
    assert err.max() < max(3 * err_j.max(), 0.05), (err, err_j)
    moved = {k: float(np.abs(N(t.c_grid[k]) - g0[k]).max()) for k in g0}
    assert moved["grid_middle"] > 1e-5 and moved["grid_fine"] > 1e-6 \
        and moved["grid_color"] > 1e-6, moved
    from pointnerf_slam_torch.outputs.draw import loss_log
    ev_t = loss_log(t)["mapping"]
    ev_j = [(i, np.asarray(l)) for i, l in j.loss_log["mapping"]]
    assert [(i, len(l)) for i, l in ev_t] == [(i, len(l)) for i, l in ev_j]
    for (i, lt), (_, lj) in zip(ev_t, ev_j):
        assert np.isfinite(lt).all()
        assert 1 / 2 < lt[-1] / lj[-1] < 2, (i, lt[-1], lj[-1])
    tr_t = loss_log(t)["tracking"]
    assert [i for i, _, _ in tr_t] == [int(i) for i, _, _ in
                                       j.loss_log["tracking"]]


def test_nice_out_of_frustum_cells_frozen():
    """frustum_feature_selection on a static camera (the reference's
    tests/test_nice_mode.py check): cells outside frame 0's frustum are
    bit-for-bit unmoved after three frames; in-frustum cells move."""
    cfg = nice_cfg(data={"n_frames": 3, "orbit": 0.0})
    from pointnerf_slam_torch.io.config import update_recursive
    update_recursive(cfg, {
        "mapping": {"frustum_feature_selection": True, "BA": False},
        "coarse": False, "tracking": {"gt_camera": True}})
    slam = PointNeRFSLAM(cfg, device="cpu")
    assert slam._use_grid_masks
    _, color, depth, gt_c2w = slam.frame_reader[0]
    slam.step(0, color, depth, gt_c2w)
    masks = slam._frustum_masks(0, T(depth))
    g0 = {k: N(v).copy() for k, v in slam.c_grid.items()}
    for i in (1, 2):
        slam.step(i, *slam.frame_reader[i][1:])
    for name in ("grid_middle", "grid_fine", "grid_color"):
        m = N(masks[name])[..., 0] > 0
        delta = np.abs(N(slam.c_grid[name]) - g0[name]).max(-1)
        assert m.any() and (~m).any(), name
        assert float(delta[~m].max()) == 0.0, name
    m_mid = N(masks["grid_middle"])[..., 0] > 0
    assert float(np.abs(N(slam.c_grid["grid_middle"])
                        - g0["grid_middle"]).max(-1)[m_mid].max()) > 1e-6
