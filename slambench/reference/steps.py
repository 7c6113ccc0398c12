"""The reference's own first steps of a mapper or a tracker call, from the
state the call started from and the pixels and uniforms it drew.

Each call is followed for `steps` optimizer steps on the reference's own
path: its own rays, far bounds, importance depths, loss, gradients by
autograd and Adam, starting from the program's state at the call's start
(the decoder, or the camera), since a SLAM run's state after hundreds of
frames can only be taken from the run. The pixel indices and regulation
uniforms are consumed in the engine's order: one pixel batch (and one set
of importance depths) per resample round of K steps, one set of
regulation uniforms per mapper step.
"""

from __future__ import annotations

import torch

from . import imap


def _pixels(idx: torch.Tensor, width: int):
    return ((idx % width).to(torch.float32),
            torch.div(idx, width, rounding_mode="floor").to(torch.float32))


def follow_map(cap: dict, c: dict, steps: int = 3, quant="bf16") -> dict:
    """cap: params0, colors (F, H, W, 3) u8, depths (F, H, W), cams (F, 7),
    valid (F,), bound, draws; c: ppf, k_map, intr, width, w_color, w_reg,
    w_beyond, lr, s1, si. Returns losses [steps], grads1 {leaf: tensor},
    params1 and params {leaf: tensor} after the first step and after
    `steps`."""
    p = {k: v.detach().float().clone() for k, v in cap["params0"].items()}
    adam = imap.Adam({k: c["lr"] for k in p})
    draws = iter(cap["draws"])
    colors, depths = cap["colors"], cap["depths"]
    F = colors.shape[0]
    fr = torch.arange(F, device=depths.device)[:, None]
    valid = cap["valid"].to(torch.float32)
    ppf = c["ppf"]
    ray_w = valid.repeat_interleave(ppf) * (F / valid.sum().clamp(min=1.0))
    losses, grads1, params1, done = [], None, None, 0
    while done < steps:
        idx = next(draws)
        gt_d = depths.reshape(F, -1)[fr, idx].reshape(-1)
        gt_c = (colors.reshape(F, -1, 3)[fr, idx].to(torch.float32)
                / 255.0).reshape(-1, 3)
        i, j = _pixels(idx, c["width"])
        ro, rd = [], []
        for f in range(F):
            o, d = imap.rays(cap["cams"][f].float(), i[f], j[f], c["intr"])
            ro.append(o)
            rd.append(d)
        ro, rd = torch.cat(ro), torch.cat(rd)
        far = imap.far_clip(ro, rd, gt_d, cap["bound"])
        z = imap.importance_z(p, ro, rd, gt_d, far, cap["bound"], c["s1"],
                              c["si"], quant)
        for _ in range(c["k_map"]):
            if done == steps:
                break
            t_reg = next(draws)
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            loss = imap.mapper_loss(leaves, ro, rd, gt_d, gt_c, ray_w, t_reg,
                                    z, cap["bound"], c["w_color"],
                                    c["w_reg"], c["w_beyond"], quant)
            g = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
            grads1 = g if grads1 is None else grads1
            losses.append(float(loss.detach()))
            with torch.no_grad():
                p = adam.step({k: v.detach() for k, v in leaves.items()}, g)
            params1 = p if params1 is None else params1
            done += 1
    return {"losses": losses, "grads1": grads1, "params1": params1,
            "params": p}


def follow_track(cap: dict, c: dict, steps: int = 3,
                 quant="bf16") -> dict:
    """cap: params (the decoder), cam0 (7,), color (H, W, 3) float,
    depth (H, W), bound, draws; c: k_track, intr, width, w_color, lr_quad,
    lr_trans, s1, si. Returns losses [steps], grads1 {quad, trans}, cam1
    and cam (7,) after the first step and after `steps`."""
    p = {k: v.detach().float() for k, v in cap["params"].items()}
    cam = {"quad": cap["cam0"][:4].clone(), "trans": cap["cam0"][4:].clone()}
    adam = imap.Adam({"quad": c["lr_quad"], "trans": c["lr_trans"]})
    draws = iter(cap["draws"])
    width = c["width"]
    losses, grads1, cam1, done = [], None, None, 0
    while done < steps:
        idx = next(draws)
        gt_d = cap["depth"].reshape(-1)[idx]
        gt_c = cap["color"].reshape(-1, 3)[idx].float()
        i, j = _pixels(idx, width)
        with torch.no_grad():
            ro, rd = imap.rays(torch.cat([cam["quad"], cam["trans"]]), i, j,
                               c["intr"])
            far = imap.far_clip(ro, rd, gt_d, cap["bound"])
            z = imap.importance_z(p, ro, rd, gt_d, far, cap["bound"],
                                  c["s1"], c["si"], quant)
        for _ in range(c["k_track"]):
            if done == steps:
                break
            q = cam["quad"].detach().requires_grad_(True)
            t = cam["trans"].detach().requires_grad_(True)
            ro, rd = imap.rays(torch.cat([q, t]), i, j, c["intr"])
            loss = imap.tracker_loss(p, ro, rd, gt_d, gt_c, z, cap["bound"],
                                     c["w_color"], quant)
            gq, gt = torch.autograd.grad(loss, [q, t])
            g = {"quad": gq, "trans": gt}
            grads1 = g if grads1 is None else grads1
            losses.append(float(loss.detach()))
            with torch.no_grad():
                cam = adam.step({"quad": q.detach(), "trans": t.detach()}, g)
            cam1 = torch.cat([cam["quad"], cam["trans"]]) if cam1 is None \
                else cam1
            done += 1
    return {"losses": losses, "grads1": grads1, "cam1": cam1,
            "cam": torch.cat([cam["quad"], cam["trans"]])}
