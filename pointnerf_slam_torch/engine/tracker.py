"""Tracking step: camera pose refinement by Adam through the renderer.

Loss per iteration:
  depth:       sum(|D - D_hat| / sqrt(stopgrad(Var) + 1e-10) * m)
               + w_color * sum(|C - C_hat|_1 * m)
  colour-only: sum(|C - C_hat|_1 * m)       (depth_supervision off)
  m = D > 0; with tracking.handle_dynamic also
  |D - D_hat| / sqrt(Var + 1e-10) < 10 * median over the whole batch.

Three paths, chosen as the JAX reference's engine/tracker.py chooses
(`rendering.megakernel` "auto" and "on" both mean the kernels here):
  - fused value-and-grad (depth loss, no handle_dynamic, the sampling K1
    takes): the K1/K2 kernels with camera-only gradients;
    resample-every-K (one pixel batch and one importance z2, prepared at
    the round's first camera, per K iterations; rays rebuilt from the
    live camera every iteration).
  - two-kernel (handle_dynamic, colour-only, or sampling past K1's cover):
    the dynamic-pixel median is cross-ray state the fused loss cannot see,
    so each iteration renders its own pixel batch with the megakernel pair
    (K3 forward, K4 backward, ops/megakernel.py, no regulation pass) and
    computes the loss in torch; autograd chains K4's ray gradients to the
    camera.
  - plain (`megakernel: off`, or a decoder or sampling the kernels do not
    cover, NICE among them): render.renderer.render_rays on the live
    camera with autograd to it, one pixel batch per iteration (and with
    rendering.perturb > 0 its stratified and importance uniforms); the
    iMAP* decoder runs through models.decoders.decoder_apply, so
    MLPConfig.fused evaluates it with K5 and backpropagates with K6 (dx
    only: no parameter gradient); NICE renders its field at the 'color'
    stage with the grids (c_grid) as constants.
In each the camera gradient reaches the pose through ray generation by
autograd, and the candidate kept for a loss is the PRE-step camera (the one
the loss was evaluated at). `seperate_LR`: the quaternion gets lr * 0.2.

Pixels: weak mode draws among pseudo-depth > 0.01 pixels, otherwise
uniformly over the edge-cropped image.
"""

from __future__ import annotations

import torch

from ..core.rays import (gather_pixels, rays_from_uv, sample_uv_uniform,
                         sample_uv_valid)
from ..core.se3 import camera_from_tensor
from ..models.decoders import NICEConfig, apply_nice, decoder_apply
from ..ops.fused_vg import (fused_vg_loss, make_fused_vg_split,
                            supports_fused_vg, supports_megakernel)
from ..ops.megakernel import make_fused_render
from ..render.renderer import render_rays
from ..utils import tracing
from .state import Draws, EngineConfig


def median_of(x: torch.Tensor) -> torch.Tensor:
    """Median over all values, the mean of the two middle ones for an even
    count (jnp.median; torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1))[0]
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def make_tracking_step(model_cfg, rcfg, ecfg: EngineConfig):
    H, W = ecfg.H, ecfg.W
    He, We = ecfg.ignore_edge_H, ecfg.ignore_edge_W
    n_rays = ecfg.tracking_pixels
    use_mega = (ecfg.megakernel != "off"
                and supports_megakernel(model_cfg, rcfg))
    use_vg = (use_mega and supports_fused_vg(model_cfg, rcfg)
              and ecfg.depth_supervision and not ecfg.handle_dynamic)
    per_iter = not use_vg          # one pixel batch per iteration
    K = 1
    if use_mega and not use_vg:
        fused_render = make_fused_render(rcfg, with_reg=False)

        def render(params, ro, rd, gt_d, bound):
            t0 = torch.zeros(n_rays, rcfg.N_samples, device=ro.device)
            return fused_render(params, ro, rd, gt_d, t0, bound)[:3]
    elif not use_mega:
        def render(params, ro, rd, gt_d, bound, c_grid=None, pert=None):
            t_rand, u_imp = pert or (None, None)
            if isinstance(model_cfg, NICEConfig):
                return render_rays(
                    lambda x, g, st, b: apply_nice(params, model_cfg, x, g,
                                                   st, b),
                    rcfg, ro, rd, bound, gt_d, c_grid=c_grid, stage="color",
                    t_rand=t_rand, u_imp=u_imp)[:3]
            return render_rays(lambda x: decoder_apply(model_cfg, params, x),
                               rcfg, ro, rd, bound, gt_d, t_rand=t_rand,
                               u_imp=u_imp)[:3]
    else:
        prep, main = make_fused_vg_split(
            rcfg, "tracker", ecfg.w_color_loss_t,
            with_color=ecfg.use_color_in_tracking, param_grads=False)
        K = max(int(ecfg.track_resample_every), 1)
        if ecfg.num_cam_iters % K:
            K = 1

    def render_loss(params, ro, rd, gt_d, gt_c, bound, c_grid=None,
                    pert=None):
        if use_mega:
            dep, var, col = render(params, ro, rd, gt_d, bound)
        else:
            dep, var, col = render(params, ro, rd, gt_d, bound, c_grid, pert)
        var = var.detach()
        if ecfg.handle_dynamic:
            tmp = (gt_d - dep).abs() / torch.sqrt(var + 1e-10)
            mask = (tmp < 10 * median_of(tmp.detach())) & (gt_d > 0)
        else:
            mask = gt_d > 0
        mask = mask.to(torch.float32)
        col_l1 = ((gt_c - col).abs().sum(-1) * mask).sum()
        if not ecfg.depth_supervision:
            return col_l1
        loss = ((gt_d - dep).abs() / torch.sqrt(var + 1e-10) * mask).sum()
        if ecfg.use_color_in_tracking:
            loss = loss + ecfg.w_color_loss_t * col_l1
        return loss

    def tracking_step(decoder, cam_tensor, color, depth_sup, bound,
                      draws: Draws, c_grid: dict | None = None):
        """Refine one camera (7,) (NICE: against the grids c_grid). Returns
        (best_cam, best_loss, first_loss, losses (num_cam_iters,))."""
        if ecfg.weak_depth:
            valid = depth_sup > 0.01

            def sample(gen):
                return sample_uv_valid(gen, valid, n_rays)[0]
        else:
            def sample(gen):
                return sample_uv_uniform(gen, W, He, H - He, We, W - We,
                                         n_rays)
        if isinstance(model_cfg, NICEConfig):
            params = {n: {k: v.detach() for k, v in sub.items()}
                      for n, sub in decoder.params().items()}
            c_grid = {k: v.detach() for k, v in c_grid.items()}
        else:
            params = {k: v.detach() for k, v in decoder.named_parameters()}
        cam0 = cam_tensor.detach().to(torch.float32)
        quad = cam0[:4].clone().requires_grad_(True)
        trans = cam0[4:].clone().requires_grad_(True)
        lr = ecfg.cam_lr
        opt = torch.optim.Adam(
            [{"params": [quad], "lr": lr * 0.2 if ecfg.seperate_LR else lr},
             {"params": [trans], "lr": lr}], eps=1e-8)
        best_cam = cam0.clone()
        with tracing.wait("best_loss"):
            best_loss = torch.tensor(1e10, device=cam0.device)
        losses = []
        for _ in range(ecfg.num_cam_iters // K):
            with tracing.span("tracker.batch"):
                idx = draws.take(sample)
                i, j, gt_d, gt_c = gather_pixels(idx, W, depth_sup, color)

                def rays_of(cam):
                    return rays_from_uv(i, j, camera_from_tensor(cam),
                                        ecfg.fx, ecfg.fy, ecfg.cx, ecfg.cy)

                if not per_iter:
                    ones = torch.ones_like(gt_d)
                    with torch.no_grad():
                        ro0, rd0 = rays_of(torch.cat([quad, trans]))
            if not per_iter:
                with torch.no_grad():
                    z2 = prep(decoder, ro0, rd0, gt_d, bound)
            for _ in range(K):
                with tracing.span("tracker.batch"):
                    cam = torch.cat([quad, trans])
                    ro, rd = rays_of(cam)
                if per_iter:
                    pert = None
                    if rcfg.perturb > 0 and not use_mega:
                        pert = draws.take(lambda g: (
                            torch.rand(n_rays, rcfg.N_samples, generator=g,
                                       device=g.device),
                            torch.rand(n_rays, rcfg.N_importance,
                                       generator=g, device=g.device)
                            if rcfg.N_importance > 0 else None))
                    loss = render_loss(params, ro, rd, gt_d, gt_c, bound,
                                       c_grid, pert)
                else:
                    loss = fused_vg_loss(main, decoder, ro, rd, gt_d, gt_c,
                                         ones, None, z2, bound)[0]
                with tracing.span("optim.step"):
                    lv = loss.detach()
                    improved = lv < best_loss
                    best_cam = torch.where(improved, cam.detach(), best_cam)
                    best_loss = torch.where(improved, lv, best_loss)
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
                losses.append(lv)
        losses = torch.stack(losses)
        return best_cam, best_loss, losses[0], losses

    return tracking_step
