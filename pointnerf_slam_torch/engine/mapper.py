"""Mapping step: keyframe-window optimisation of the iMAP* decoder (and of
the window cameras under BA).

Loss per iteration (the JAX reference's engine/mapper.py loss_fn):
  sum |D - D_hat| * m + w_color * sum |C - C_hat|_1 * ray_w
  + 0.0005 * sum |sigma_free| * ray_w + w_beyond * sum (1 - in-band mass) * m
with m = (D > 0) * ray_w. The window has a static size `max_frames`;
invalid slots get ray_w 0 and valid ones max_frames / n_valid, so the
expected pixel budget is mapping_pixels as in the upstream per-frame
mapping_pixels // len(window).

Three paths, chosen as the reference chooses (`rendering.megakernel`
"auto" and "on" both mean the kernels here):
  - fused value-and-grad (the flagship): K1/K2, resample-every-K (one
    pixel batch and one importance z2 per K iterations);
  - two-kernel (sampling past K1's cover, with w_beyond_loss 0): the
    megakernel pair K3/K4 renders depth, colour and the regulation sigma,
    the loss is torch, autograd reaches the decoder through K4;
  - plain (`megakernel: off`, or a decoder or sampling the kernels do not
    cover): render_rays(with_zvals) for the beyond term's weights and z,
    then regulation at the caller's uniforms t_reg (the draws the fused
    paths take); the decoder runs through models.decoders.decoder_apply,
    so MLPConfig.fused evaluates it with K5 and backpropagates with K6.
The two-kernel and plain paths draw one pixel batch per iteration.

A fresh Adam (eps 1e-8, optax's update formula) per call, as upstream
builds a fresh optimizer per optimize_map. No-BA fast path (`no_ba_fast`
with BA off): rays built once per round and no ray gradients (the
reference's masked camera gradients are zero there, so its camera Adam
moves nothing either). `mapper_multi_step` runs the 3-outer schedule as a
plain loop over outers, each with its own window and a fresh Adam.

NICE mode, grid masks and multi-device mapping are not ported (ROADMAP
Queue 1 item 11).
"""

from __future__ import annotations

import torch

from ..core.rays import rays_from_uv, sample_uv_uniform, sample_uv_valid
from ..core.se3 import camera_from_tensor
from ..models.decoders import decoder_apply
from ..ops.fused_vg import (_BEYOND_HI, _BEYOND_LO, fused_vg_loss,
                            make_fused_vg_split, supports_fused_vg,
                            supports_megakernel)
from ..ops.megakernel import make_fused_render
from ..render.renderer import regulation, render_rays
from .state import Draws, EngineConfig


def make_mapper_step(model_cfg, rcfg, ecfg: EngineConfig, max_frames: int,
                     outer_fused: bool = False):
    H, W = ecfg.H, ecfg.W
    ppf = max(ecfg.mapping_pixels // max_frames, 1)
    no_cam = bool(ecfg.no_ba_fast and not ecfg.BA)
    use_mega = (ecfg.megakernel != "off"
                and supports_megakernel(model_cfg, rcfg)
                and (ecfg.w_beyond_loss == 0.0
                     or supports_fused_vg(model_cfg, rcfg)))
    use_vg = use_mega and supports_fused_vg(model_cfg, rcfg)
    if use_vg:
        prep, main = make_fused_vg_split(
            rcfg, "mapper", ecfg.w_color_loss_m, 0.0005, with_color=True,
            w_beyond=ecfg.w_beyond_loss, with_ray_grads=not no_cam)
    elif use_mega:
        fused_render = make_fused_render(rcfg, with_reg=not ecfg.occupancy)
    SR = rcfg.N_samples

    def render_loss(decoder, ro, rd, gt_d, gt_c, ray_w, t_reg, bound):
        """The two-kernel and plain paths' loss (loss_fn's non-VG part)."""
        if use_mega:
            depth, _, color, sigma = fused_render(decoder, ro, rd, gt_d,
                                                  t_reg, bound)
        else:
            params = dict(decoder.named_parameters())

            def field(x):
                return decoder_apply(model_cfg, params, x)

            depth, _, color, w, z, _ = render_rays(field, rcfg, ro, rd,
                                                   bound, gt_d,
                                                   with_zvals=True)
        depth_mask = (gt_d > 0).to(torch.float32) * ray_w
        loss = ((gt_d - depth).abs() * depth_mask).sum()
        if ecfg.w_beyond_loss > 0:          # plain path only (see use_mega)
            in_band = ((z > gt_d[:, None] - _BEYOND_LO)
                       & (z < gt_d[:, None] + _BEYOND_HI)).to(torch.float32)
            m_in = (w * in_band).sum(-1)
            loss = loss + ecfg.w_beyond_loss * ((1.0 - m_in)
                                                * depth_mask).sum()
        loss = loss + ecfg.w_color_loss_m * (
            (gt_c - color).abs().sum(-1) * ray_w).sum()
        if not ecfg.occupancy:
            if not use_mega:
                sigma = regulation(field, rcfg, ro, rd, gt_d, bound,
                                   t_reg).reshape(ro.shape[0], -1)
            loss = loss + 0.0005 * (sigma.abs() * ray_w[:, None]).sum()
        return loss

    def sample(gen, depths):
        if ecfg.weak_depth:
            return torch.stack([sample_uv_valid(gen, d > 0.01, ppf)[0]
                                for d in depths])
        return torch.stack([sample_uv_uniform(gen, W, 0, H, 0, W, ppf)
                            for _ in range(depths.shape[0])])

    def mapper_step(decoder, colors, depths, fixed_cams, frame_valid,
                    ba_mask, bound, draws: Draws, num_iters: int):
        """num_iters iterations on the window (colors (F, H, W, 3) uint8,
        depths (F, H, W), fixed_cams (F, 7), frame_valid / ba_mask (F,)
        bool). Updates the decoder in place. Returns (cams, losses)."""
        F = colors.shape[0]
        dev = fixed_cams.device
        opt = torch.optim.Adam(decoder.parameters(),
                               lr=ecfg.imap_decoders_lr, eps=1e-8)
        cams_opt = fixed_cams.detach().clone().requires_grad_(not no_cam)
        cam_opt = (None if no_cam else
                   torch.optim.Adam([cams_opt], lr=ecfg.BA_cam_lr, eps=1e-8))
        valid_f = frame_valid.to(torch.float32)
        ray_w = valid_f.repeat_interleave(ppf) * (
            max_frames / valid_f.sum().clamp(min=1.0))
        K = max(int(ecfg.map_resample_every), 1) if use_vg else 1
        if num_iters % K:
            K = 1
        fr = torch.arange(F, device=dev)[:, None]
        losses = []
        for _ in range(num_iters // K):
            idx = draws.take(lambda g: sample(g, depths))      # (F, ppf)
            gt_d = depths.reshape(F, -1)[fr, idx].reshape(-1)
            gt_c = (colors.reshape(F, -1, 3)[fr, idx].to(torch.float32)
                    / 255.0).reshape(-1, 3)
            i = (idx % W).to(torch.float32)
            j = torch.div(idx, W, rounding_mode="floor").to(torch.float32)

            def rays_fn(cams_o):
                cams = torch.where(ba_mask[:, None], cams_o, fixed_cams)
                c2w = camera_from_tensor(cams)[:, None]       # (F, 1, 3, 4)
                ro, rd = rays_from_uv(i, j, c2w, ecfg.fx, ecfg.fy, ecfg.cx,
                                      ecfg.cy)
                return ro.reshape(-1, 3), rd.reshape(-1, 3)

            with torch.no_grad():
                ro0, rd0 = rays_fn(cams_opt)
                if use_vg:
                    z2 = prep(decoder, ro0, rd0, gt_d, bound)
            for _ in range(K):
                t_reg = draws.take(lambda g: torch.rand(
                    gt_d.shape[0], SR, generator=g, device=g.device))
                ro, rd = (ro0, rd0) if no_cam else rays_fn(cams_opt)
                if use_vg:
                    loss = fused_vg_loss(main, decoder, ro, rd, gt_d, gt_c,
                                         ray_w, t_reg, z2, bound)[0]
                else:
                    loss = render_loss(decoder, ro, rd, gt_d, gt_c, ray_w,
                                       t_reg, bound)
                opt.zero_grad(set_to_none=True)
                if cam_opt is not None:
                    cam_opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                if cam_opt is not None:
                    cams_opt.grad.mul_(ba_mask[:, None].to(torch.float32))
                    cam_opt.step()
                losses.append(loss.detach())
        cams = torch.where(ba_mask[:, None], cams_opt.detach(), fixed_cams)
        return cams, torch.stack(losses)

    def mapper_multi_step(decoder, colors_o, depths_o, cams_o, valid_o,
                          ba_o, bound, draws: Draws, num_iters: int):
        """The outer schedule: one mapper_step per window (leading axis O),
        decoder carried across outers. Returns (cams_last, losses)."""
        losses = []
        for o in range(colors_o.shape[0]):
            cams, ls = mapper_step(decoder, colors_o[o], depths_o[o],
                                   cams_o[o], valid_o[o], ba_o[o], bound,
                                   draws, num_iters)
            losses.append(ls)
        return cams, torch.cat(losses)

    return mapper_multi_step if outer_fused else mapper_step
