"""The slice as a whole: the port's tracker step, then its fused-outer
mapper, chained as the system chains them (the tracked camera joins the
mapping window), against the JAX reference's steps with megakernel="on"
(Pallas interpret mode on the CPU). The reference's random draws (pixel
indices, regulation uniforms) are replayed into the port by repeating the
reference's key splits (tracker.py round_body, mapper.py vg_round /
mapper_multi_step) with scripts/replay_draws.py.

Bounds: tracker first/best loss rtol 2e-2 and best camera within 1e-3
per component, one Adam step at cam_lr (Adam's normalised step moves a
component whose gradient is near 0 by ~lr whichever its sign, so gradient
noise shows at that scale);
mapper per-iteration losses rtol 2e-2 over its 8 iterations; the change
of the learned field (decoder output at points of the mapped volume, final
minus initial) cosine > 0.98 with norm ratio in [0.9, 1.1], the bound the
reference uses for two of its own mapper paths (tests/test_fused_vg.py
test_beyond_loss_mapper_step_parity)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.engine.mapper import make_mapper_step as j_mapper
from pointnerf_slam_tpu.engine.state import EngineConfig as JEC
from pointnerf_slam_tpu.engine.tracker import make_tracking_step as j_tracker
from pointnerf_slam_tpu.models.decoders import MLPConfig as JCfg
from pointnerf_slam_tpu.models.decoders import init_mlp
from pointnerf_slam_tpu.render.renderer import RenderConfig as JRC
from pointnerf_slam_torch.core.rays import rays_from_uv
from pointnerf_slam_torch.core.se3 import camera_from_tensor
from pointnerf_slam_torch.engine.mapper import make_mapper_step
from pointnerf_slam_torch.engine.state import Draws, EngineConfig
from pointnerf_slam_torch.engine.tracker import make_tracking_step
from pointnerf_slam_torch.models.decoders import (IMAPDecoder, MLPConfig,
                                                  params_from_jax)
from pointnerf_slam_torch.ops.megakernel import make_fused_render
from pointnerf_slam_torch.render.renderer import RenderConfig
from tests.torch_threads import share_cores

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from replay_draws import mapper_draws, pixel_draws  # noqa: E402

share_cores()

H, W, F, O = 16, 24, 2, 2
N_TRACK, N_MAP = 128, 384
TRACK_ITERS, TRACK_K = 10, 5
MAP_ITERS, MAP_K = 4, 4
SR = 32
ECFG = dict(H=H, W=W, fx=12.0, fy=12.0, cx=11.5, cy=7.5,
            tracking_pixels=N_TRACK, num_cam_iters=TRACK_ITERS,
            mapping_pixels=N_MAP, weak_depth=False, depth_supervision=True,
            w_beyond_loss=1.0, no_ba_fast=True, fused_outer=True,
            map_resample_every=MAP_K, track_resample_every=TRACK_K,
            seperate_LR=True)
BOUND = np.array([[-4.0, 4.0]] * 3, np.float32)


def T(a):
    return torch.as_tensor(np.array(a))


def test_tracker_then_mapper_match_reference():
    tracker_then_mapper(w_beyond=1.0)


def test_tracker_then_mapper_without_beyond_term_match_reference():
    """The same at w_beyond_loss 0.0, EngineConfig's default and
    bench_torch.py's: the fused-outer mapper on K1 without the beyond
    term. Both mappers map the window with the reference's tracked camera:
    at 0.0 the losses are about half as large, and the reference's own
    mapper losses move by about the loss bound between its tracked camera
    and the port's (which the tracker's bound lets differ), so chaining
    each package's own camera would measure the handoff, not the
    mapper."""
    tracker_then_mapper(w_beyond=0.0, shared_window=True)


def tracker_then_mapper(w_beyond: float, shared_window: bool = False):
    """shared_window: the port's mapper maps the window with the
    reference's tracked camera instead of its own."""
    ecfg = dict(ECFG, w_beyond_loss=w_beyond)
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
                n_blocks=4)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(0), jcfg))
    dec = IMAPDecoder(MLPConfig())
    dec.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(0)
    colors = (rng.uniform(size=(F, H, W, 3)) * 255).astype(np.uint8)
    depths = rng.uniform(0.5, 3.0, (F, H, W)).astype(np.float32)
    cam_gt = np.array([1.0, 0, 0, 0, 0, 0, 2.5], np.float32)
    cam0 = np.array([1.0, 0.01, 0, 0, 0.02, 0, 2.5], np.float32)

    # --- tracker on frame 1
    jtrack = j_tracker(jcfg, JRC(), JEC(**ecfg, megakernel="on"))
    ttrack = make_tracking_step(MLPConfig(), RenderConfig(),
                                EngineConfig(**ecfg))
    k_track = jax.random.PRNGKey(1)
    color1 = colors[1].astype(np.float32) / 255.0
    bc_j, bl_j, fl_j = jtrack(tree, {}, cam0, color1, depths[1], BOUND,
                              k_track)
    bc_t, bl_t, fl_t, losses_t = ttrack(
        dec, T(cam0), T(color1), T(depths[1]), T(BOUND),
        Draws(replay=pixel_draws(k_track, TRACK_ITERS // TRACK_K, N_TRACK,
                                 W, H)))
    assert losses_t.shape == (TRACK_ITERS,)
    np.testing.assert_allclose(float(fl_t), float(fl_j), rtol=2e-2)
    np.testing.assert_allclose(float(bl_t), float(bl_j), rtol=2e-2)
    np.testing.assert_allclose(bc_t.numpy(), np.asarray(bc_j), atol=1e-3)

    # --- mapper: window [frame 0 at gt, frame 1 at its tracked camera]
    jmap = j_mapper(jcfg, JRC(), JEC(**ecfg, megakernel="on"), F,
                    outer_fused=True)
    tmap = make_mapper_step(MLPConfig(), RenderConfig(),
                            EngineConfig(**ecfg), F, outer_fused=True)
    k_map = jax.random.PRNGKey(2)
    cams_j = np.stack([cam_gt, np.asarray(bc_j)])
    cams_t = torch.stack([T(cam_gt), T(np.asarray(bc_j)) if shared_window
                          else bc_t])
    rep = lambda a: np.broadcast_to(a, (O,) + a.shape).copy()
    valid = np.ones((O, F), bool)
    ba = np.zeros((O, F), bool)
    p_j, _, _, ml_j = jmap(tree, {}, rep(colors), rep(depths), rep(cams_j),
                           valid, ba, BOUND, k_map, MAP_ITERS)
    _, ml_t = tmap(dec, T(rep(colors)), T(rep(depths)),
                   cams_t.expand(O, F, 7), T(valid), T(ba), T(BOUND),
                   Draws(replay=mapper_draws(k_map, F, N_MAP // F, SR, W, H,
                                             MAP_ITERS, MAP_K, outers=O)),
                   MAP_ITERS)
    assert ml_t.shape == (O * MAP_ITERS,)
    np.testing.assert_allclose(ml_t.numpy(), np.asarray(ml_j), rtol=2e-2)

    # the learned field: change of the decoder's raw output at points in
    # the mapped volume (Adam's normalised steps make the raw parameter
    # deltas of near-zero-gradient weights noise-dominated)
    from pointnerf_slam_tpu.models.decoders import apply_mlp
    pts = np.random.default_rng(3).uniform(-0.4, 0.4, (512, 3)) + [0, 0, 1]
    pts = pts.astype(np.float32)
    f0 = np.asarray(apply_mlp(tree, jcfg, pts), np.float64)
    d_j = np.asarray(apply_mlp(p_j, jcfg, pts), np.float64) - f0
    with torch.no_grad():
        d_t = dec(T(pts)).numpy().astype(np.float64) - f0
    cos = (d_t * d_j).sum() / (np.linalg.norm(d_t) * np.linalg.norm(d_j))
    ratio = np.linalg.norm(d_t) / np.linalg.norm(d_j)
    assert cos > 0.98 and 0.9 <= ratio <= 1.1, (cos, ratio)


def test_mapper_budget_rescale_and_invalid_slots(monkeypatch):
    """An invalid window slot gets ray_w 0 and the valid ones
    max_frames / n_valid (the reference's budget rescale,
    mapper.py:181-182)."""
    import pointnerf_slam_torch.engine.mapper as M
    seen = []
    orig = M.fused_vg_loss

    def spy(main, dec, ro, rd, gt_d, gt_c, ray_w, *rest):
        seen.append(ray_w.clone())
        return orig(main, dec, ro, rd, gt_d, gt_c, ray_w, *rest)

    monkeypatch.setattr(M, "fused_vg_loss", spy)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0))
    step = make_mapper_step(MLPConfig(), RenderConfig(),
                            EngineConfig(**ECFG), 3)
    rng = np.random.default_rng(1)
    colors = T((rng.uniform(size=(3, H, W, 3)) * 255).astype(np.uint8))
    depths = T(rng.uniform(0.5, 3.0, (3, H, W)).astype(np.float32))
    cams = T(np.tile([1.0, 0, 0, 0, 0, 0, 2.5], (3, 1)).astype(np.float32))
    valid = T(np.array([True, False, True]))
    _, losses = step(dec, colors, depths, cams, valid, T(np.zeros(3, bool)),
                     T(BOUND), Draws(torch.Generator().manual_seed(0)), 4)
    ppf = N_MAP // 3
    w = seen[0].numpy()
    np.testing.assert_allclose(w[:ppf], 1.5)
    np.testing.assert_allclose(w[ppf:2 * ppf], 0.0)
    np.testing.assert_allclose(w[2 * ppf:], 1.5)
    assert torch.isfinite(losses).all() and losses.shape == (4,)


def test_mapper_bundle_adjustment_matches_reference():
    """BA on (no fast path): the kernel's ray gradients chain into the
    window cameras selected by ba_mask; losses and the moved camera follow
    the reference (camera within one Adam step at BA_cam_lr)."""
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
                n_blocks=4)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(4), jcfg))
    dec = IMAPDecoder(MLPConfig())
    dec.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(4)
    colors = (rng.uniform(size=(F, H, W, 3)) * 255).astype(np.uint8)
    depths = rng.uniform(0.5, 3.0, (F, H, W)).astype(np.float32)
    cams = np.array([[1.0, 0, 0, 0, 0, 0, 2.5],
                     [1.0, 0.01, 0, 0, 0.02, 0, 2.5]], np.float32)
    valid = np.ones(F, bool)
    ba = np.array([False, True])
    cfg = dict(ECFG, BA=True, no_ba_fast=False, fused_outer=False,
               BA_cam_lr=1e-3)
    key = jax.random.PRNGKey(6)
    _, _, cams_j, ml_j = j_mapper(jcfg, JRC(), JEC(**cfg, megakernel="on"),
                                  F)(tree, {}, colors, depths, cams, valid,
                                     ba, BOUND, key, MAP_ITERS)
    cams_t, ml_t = make_mapper_step(MLPConfig(), RenderConfig(),
                                    EngineConfig(**cfg), F)(
        dec, T(colors), T(depths), T(cams), T(valid), T(ba), T(BOUND),
        Draws(replay=mapper_draws(key, F, N_MAP // F, SR, W, H, MAP_ITERS,
                                  MAP_K)), MAP_ITERS)
    np.testing.assert_allclose(ml_t.numpy(), np.asarray(ml_j), rtol=2e-2)
    np.testing.assert_array_equal(cams_t[0].numpy(), cams[0])
    assert float((cams_t[1] - T(cams[1])).abs().max()) > 1e-3
    np.testing.assert_allclose(cams_t.numpy(), np.asarray(cams_j),
                               atol=1e-3)


@pytest.mark.parametrize("weak,dynamic,depth_sup", [
    (False, True, True), (True, True, True), (True, False, False)])
def test_two_kernel_tracker_matches_reference(weak, dynamic, depth_sup):
    """The megakernel-pair tracker (handle_dynamic's batch-median mask, or
    colour-only tracking) against the reference's with megakernel="on",
    draws replayed: first and best loss rtol 2e-2, best camera within one
    Adam step (1e-3) per component."""
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
                n_blocks=4)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(0), jcfg))
    dec = IMAPDecoder(MLPConfig())
    dec.load_state_dict(params_from_jax(tree))
    cam_gt = np.array([1.0, 0, 0, 0, 0, 0, 2.5], np.float32)
    cam0 = np.array([1.0, 0.01, 0, 0, 0.02, 0, 2.5], np.float32)
    # the frame is the decoder's own render at cam_gt (the plain version),
    # depth with 2% noise, and 10% "dynamic" pixels 1 m off: the batch
    # median mask then separates them by far more than the bf16 noise. The
    # AABB is tight, so every ray's far end (AABB exit + 0.01) holds the
    # constant sentinel density: no ray sits at the last-interval step
    # (alpha 0 or 1 there as a near-zero sigma's sign falls)
    bound = np.array([[-1.0, 1.0]] * 3, np.float32)
    rng = np.random.default_rng(7)
    jj, ii = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    ro, rd = rays_from_uv(T(ii.reshape(-1)), T(jj.reshape(-1)),
                          camera_from_tensor(T(cam_gt)), 12.0, 12.0, 11.5,
                          7.5)
    with torch.no_grad():
        dep, _, col, _ = make_fused_render(RenderConfig(), with_reg=False)(
            dec, ro, rd, torch.full((H * W,), 4.0), torch.zeros(H * W, 32),
            T(bound))
    depth = dep.numpy().reshape(H, W) * rng.uniform(0.98, 1.02, (H, W))
    depth[rng.uniform(size=(H, W)) < 0.1] += 1.0
    depth[0, 0] = 4.0         # far = AABB exit on every ray
    depth = depth.astype(np.float32)
    color = col.numpy().reshape(H, W, 3).clip(0, 1).astype(np.float32)
    if weak:                  # sparse pseudo-depth: most pixels hold none
        depth[rng.uniform(size=(H, W)) < 0.6] = 0.0
    cfg = dict(ECFG, weak_depth=weak, handle_dynamic=dynamic,
               depth_supervision=depth_sup, track_resample_every=1)
    key = jax.random.PRNGKey(3)
    bc_j, bl_j, fl_j = j_tracker(jcfg, JRC(), JEC(**cfg, megakernel="on"))(
        tree, {}, cam0, color, depth, bound, key)
    bc_t, bl_t, fl_t, losses_t = make_tracking_step(
        MLPConfig(), RenderConfig(), EngineConfig(**cfg))(
        dec, T(cam0), T(color), T(depth), T(bound),
        Draws(replay=pixel_draws(key, TRACK_ITERS, N_TRACK, W, H,
                                 valid=depth > 0.01 if weak else None)))
    assert losses_t.shape == (TRACK_ITERS,)
    assert dec.layers[0].w.grad is None        # no decoder gradient
    np.testing.assert_allclose(float(fl_t), float(fl_j), rtol=2e-2)
    np.testing.assert_allclose(float(bl_t), float(bl_j), rtol=2e-2)
    np.testing.assert_allclose(bc_t.numpy(), np.asarray(bc_j), atol=1e-3)


def test_median_of_takes_the_mean_of_the_middle_pair():
    from pointnerf_slam_torch.engine.tracker import median_of
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(median_of(x)) == float(np.median(x.numpy())) == 2.5
    assert float(median_of(x[:3])) == 3.0


def field_change(tree, p_j, dec, jcfg, pts=None):
    """(cosine, norm ratio) of the port's and the reference's change of the
    decoder output at points of the mapped volume (or at pts (N, 3))."""
    from pointnerf_slam_tpu.models.decoders import apply_mlp
    if pts is None:
        pts = np.random.default_rng(3).uniform(-0.4, 0.4, (512, 3)) \
            + [0, 0, 1]
    pts = pts.astype(np.float32)
    f0 = np.asarray(apply_mlp(tree, jcfg, pts), np.float64)
    d_j = np.asarray(apply_mlp(p_j, jcfg, pts), np.float64) - f0
    with torch.no_grad():
        d_t = dec(T(pts)).numpy().astype(np.float64) - f0
    cos = (d_t * d_j).sum() / (np.linalg.norm(d_t) * np.linalg.norm(d_j))
    return cos, np.linalg.norm(d_t) / np.linalg.norm(d_j)


@pytest.mark.parametrize("w_beyond,n_samples,n_importance,megakernel", [
    (1.0, 32, 12, "off"), (0.0, 32, 12, "off"), (0.0, 40, 24, "on")])
def test_mapper_off_fused_vg_matches_reference(w_beyond, n_samples,
                                               n_importance, megakernel):
    """The mapper's plain branch (megakernel off: render_rays with the
    beyond term from its weights and z, then regulation at the replayed
    t_reg; fused False, the reference's XLA numerics) and its two-kernel
    branch (40 + 24 samples: 104 points per ray with regulation, past
    fused value-and-grad's cover, w_beyond_loss 0: K3/K4, here their plain
    versions, against the reference's Pallas pair in interpret mode), with
    the reference's draws replayed: per-iteration losses rtol 2e-2 and the
    change of the learned field as in the fused test."""
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
                n_blocks=4)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(5), jcfg))
    dec = IMAPDecoder(MLPConfig())
    dec.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(5)
    colors = (rng.uniform(size=(F, H, W, 3)) * 255).astype(np.uint8)
    depths = rng.uniform(0.5, 3.0, (F, H, W)).astype(np.float32)
    cams = np.array([[1.0, 0, 0, 0, 0, 0, 2.5],
                     [1.0, 0.01, 0, 0, 0.02, 0, 2.5]], np.float32)
    valid = np.ones(F, bool)
    ba = np.zeros(F, bool)
    cfg = dict(ECFG, fused_outer=False, w_beyond_loss=w_beyond,
               megakernel=megakernel)
    jrc = JRC(N_samples=n_samples, N_importance=n_importance)
    trc = RenderConfig(N_samples=n_samples, N_importance=n_importance)
    key = jax.random.PRNGKey(8)
    p_j, _, _, ml_j = j_mapper(jcfg, jrc, JEC(**cfg), F)(
        tree, {}, colors, depths, cams, valid, ba, BOUND, key, MAP_ITERS)
    _, ml_t = make_mapper_step(MLPConfig(), trc, EngineConfig(**cfg), F)(
        dec, T(colors), T(depths), T(cams), T(valid), T(ba), T(BOUND),
        Draws(replay=mapper_draws(key, F, N_MAP // F, SR, W, H, MAP_ITERS,
                                  1)), MAP_ITERS)
    assert ml_t.shape == (MAP_ITERS,)
    np.testing.assert_allclose(ml_t.numpy(), np.asarray(ml_j), rtol=2e-2)
    cos, ratio = field_change(tree, p_j, dec, jcfg)
    assert cos > 0.98 and 0.9 <= ratio <= 1.1, (cos, ratio)


def test_plain_tracker_matches_reference():
    """The tracker's plain branch (megakernel off, fused False: render_rays
    with autograd to the camera, one pixel batch per iteration) against
    the reference's XLA tracker, draws replayed: first and best loss rtol
    2e-2, best camera within one Adam step (1e-3) per component."""
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
                n_blocks=4)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(0), jcfg))
    dec = IMAPDecoder(MLPConfig())
    dec.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(9)
    color = rng.uniform(size=(H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    cam0 = np.array([1.0, 0.01, 0, 0, 0.02, 0, 2.5], np.float32)
    cfg = dict(ECFG, megakernel="off")
    key = jax.random.PRNGKey(3)
    bc_j, bl_j, fl_j = j_tracker(jcfg, JRC(), JEC(**cfg))(
        tree, {}, cam0, color, depth, BOUND, key)
    bc_t, bl_t, fl_t, losses_t = make_tracking_step(
        MLPConfig(), RenderConfig(), EngineConfig(**cfg))(
        dec, T(cam0), T(color), T(depth), T(BOUND),
        Draws(replay=pixel_draws(key, TRACK_ITERS, N_TRACK, W, H)))
    assert losses_t.shape == (TRACK_ITERS,)
    assert dec.layers[0].w.grad is None        # no decoder gradient
    np.testing.assert_allclose(float(fl_t), float(fl_j), rtol=2e-2)
    np.testing.assert_allclose(float(bl_t), float(bl_j), rtol=2e-2)
    np.testing.assert_allclose(bc_t.numpy(), np.asarray(bc_j), atol=1e-3)


def test_engine_dispatch_follows_the_reference(monkeypatch):
    """Which branch each configuration takes: fused value-and-grad for the
    flagship, K3/K4 past its point cap (w_beyond 0) or for handle_dynamic,
    plain for megakernel off or past the cap with the beyond term."""
    import pointnerf_slam_torch.engine.mapper as M
    import pointnerf_slam_torch.engine.tracker as Tr
    from pointnerf_slam_torch.ops.fused_vg import (supports_fused_vg,
                                                   supports_megakernel)
    wide = RenderConfig(N_samples=40, N_importance=24)
    assert supports_megakernel(MLPConfig(), wide)
    assert not supports_fused_vg(MLPConfig(), wide)
    assert supports_fused_vg(MLPConfig(), RenderConfig())
    assert supports_fused_vg(MLPConfig(), RenderConfig(N_samples=24,
                                                       N_importance=8))
    seen = []
    for mod in (M, Tr):
        for name in ("make_fused_vg_split", "make_fused_render"):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                                seen.append(_n) or (None, None))
    vg, mk = "make_fused_vg_split", "make_fused_render"
    cases = [(dict(), RenderConfig(), vg, vg),
             (dict(w_beyond_loss=0.0), wide, mk, mk),
             (dict(), wide, None, mk),
             (dict(megakernel="off"), RenderConfig(), None, None),
             (dict(handle_dynamic=True), RenderConfig(), vg, mk)]
    for over, rc, want_m, want_t in cases:
        e = EngineConfig(**dict(ECFG, **over))
        for make, want in ((lambda: M.make_mapper_step(MLPConfig(), rc, e,
                                                       F), want_m),
                           (lambda: Tr.make_tracking_step(MLPConfig(), rc,
                                                          e), want_t)):
            seen.clear()
            make()
            assert seen == ([want] if want else []), (over, rc, seen)
