#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: needs CUDA; prints `nvidia-smi --query-gpu=name,power.limit`
  2. build: compiles every kernel from pointnerf_slam_torch/ops/csrc with
     nvcc for sm_90a, one process per source, all started together;
     prints the seconds, ptxas' register and spill lines and each
     library's count of HGMMA (wgmma) instructions (cuobjdump -sass);
     fails if fused_vg, p1_sigma or megakernel has none, if ptxas reports
     a spilled byte in any kernel of the four libraries, or if fused_vg or
     megakernel holds one of the WMMA kernels (vg_forward, vg_chain,
     vg_wgrad, p1_kernel) that K1-K4 left for the Hopper tile
  3. kernels, random cell: at the main paths' shapes (5000 rays, 32+12
     samples, 32 regulation samples, 256-wide MLP) and a random decoder,
     each kernel is held against its plain PyTorch version on the same
     inputs and timed with CUDA events:
       p1_sigma          vs p1_sigma_reference
       fused_vg mapper   (colour, w_beyond 1, with and without ray grads)
       fused_vg tracker  vs fused_vg_reference
       megakernel K3/K4  vs fused_render_reference, at the tracker shape
                         (5000 rays, no regulation) and the mapper shape
                         (4998 rays, with regulation)
       fused_mlp K5/K6   vs mlp_forward_reference / mlp_backward_reference:
                         K5 at a 500,000-point chunk of room_bench's mesh
                         grid and at the mapper's plain-path 539,784
                         points, K6 at the 379,848 its loss reaches (random
                         and the loss's own cotangent); the decoder as five
                         bf16 torch.matmul calls is timed beside K5
  4. engine: the bench workload (680x1200, 6-frame window) through the
     port's tracker (50 iterations, K=5) and fused-outer mapper (3 x 100,
     K=4, no BA); ms per iteration; losses finite and falling
  5. system, sensor depth: PointNeRFSLAM on room_bench.yaml at full
     680x1200 width with the flagship schedule (fused_outer, K=4/5) for
     frames 0..5, colour refine off, the mesher attached
     (outputs.attach_outputs): mapping losses fall on every mapped frame,
     tracking lowers the summed loss, camera errors stay small; the last
     frame writes final_mesh.ply and final_mesh_eval_rec.ply at
     resolution 256 (float32 decoder) under output/chip_smoke/room_bench
  5b. engine, handle_dynamic tracker: the bench workload's tracker at full
     width (5000 rays, 32+12 samples, 50 iterations) with
     tracking.handle_dynamic on: K3/K4 launched exactly 50 times each (one
     pixel batch per iteration); ms per iteration; the loss falls
  6. mesh: both PLYs read back; the same mesh from a snapshot with the
     fused decoder (K5) is held against final_mesh.ply (counts within 1%,
     mean nearest-vertex distance under half a voxel); seconds by stage
  7. engine, plain branch (megakernel: off): the bench workload with
     MLPConfig(fused=True) (K5/K6 launched exactly 100 / 50 times by the
     tracker, 900 / 600 by the mapper) and with fused=False (no kernel);
     losses fall, first losses compared
  8. mapper two-kernel branch: 40 + 24 samples (past fused value-and-
     grad's cover), w_beyond_loss 0: K3/K4 for 20 iterations, loss falls
  9. system, weak depth: room_bench_weak.yaml (the flagship) at 680x1200,
     frames 0..20 as configured (iters_first 1500, colour refine on the
     last frame): the sparse front-end bootstraps by frame 15 (its 2 deg
     parallax gate needs ~15 frames of this orbit), continuous tracked
     frames follow, pseudo-depth agrees with the sensor depth the run never
     sees, mapping losses fall, poses stay finite and near gt
 10. system, dynamic: configs/Synthetic/ablations/box_ba_dynamic.yaml, all
     40 frames (weak depth, handle_dynamic, BA): the tracker runs K3/K4,
     the mapper K1 with ray gradients (BA); tracking lowers the summed loss
 11. the launch counts of phases 4-10, each path counted from 0 (every
     kernel must have launched on the main paths; K3/K4 on the
     handle_dynamic tracker, mapper two-kernel and dynamic paths)
 12. tracking check: the tracker pulls frame 0 back from a 2 cm shift on
     the map that phase 5 built
 13. kernels, map cell: the kernels against their plain versions again,
     on that map's decoder and on rays of frames 0 and 5 as the tracker
     and the mapper draw them (losses at their real scale)
 14. kernels, dynamic cell: K2, K3 and K4 again on the decoder phase 10
     mapped, at its tracker's shape (1500 rays, 24+8 samples, no
     regulation, pseudo-depth pixels of its last tracked frame)
 15. one `{"kernels": [...]}` line (launches per path beside the total;
     every row with bound_share = bound_ms / ms), then the device line
     last.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
H, W, FX, CX, CY = 680, 1200, 600.0, 599.5, 339.5
FLOP_FWD = 2 * (93 * 256 + 3 * 256 * 256 + 256 * 4)   # decoder, per point

# Tolerances (see phase_kernels). The loss and gradient ones are the JAX
# reference's own (tests/test_fused_vg.py); the per-ray ones are bf16 tie
# noise as read on the card (PERF.md, Findings).
LOSS_RTOL = 1e-3
GRAD_ATOL = 2e-2            # x max|g|, parameter gradients
RAY_COS, RAY_RATIO = 0.999, (0.98, 1.02)
OUT_ATOL, OUT_SHARE = 1e-3, 0.05   # depth, colour: share of rays beyond
OUT_MAX = 2e-2              # depth, colour: every ray off the last step
SIG_ATOL, SIG_SHARE = 1e-3, 0.05   # p1 sigma: x (1 + |s|), share beyond
SIG_MAX = 2e-2              # p1 sigma: x max|s| inside the AABB
VAR_ORDINARY = 1e-4         # tracker rays with var >= this weigh <= 100
SHIFT_M, SHIFT_BACK_M = 0.02, 2e-3   # tracking check: shift, error after
CAM_T_MAX = 0.05            # system: translation error of tracked frames
# K3/K4: the backward is judged by a loss linear in the outputs with fixed
# random cotangents, the JAX reference's own check (tests/test_megakernel.py)
MK_RAY_COS, MK_RAY_RATIO = 0.999, (0.995, 1.005)
MK_W_COS, MK_W_RATIO = 0.999, (0.99, 1.01)
# K3's own importance samples vs the plain version's end to end: share of
# rays moved by more than Z2_REL of the ray's pass-1 spacing
Z2_REL, Z2_SHARE = 1e-2, 0.05
# K3's middle on K2's sigma: the CDF values of the two versions differ by
# float32 summation order in the weights and the CDF (up to 1.90e-5 read
# on the card, PERF.md); a floor of 1e-6 instead of + 1e-5 moves them by
# 0.05-0.7 (tests/test_torch_megakernel.py)
MID_ETA = 2e-5
# K5/K6 against their plain versions (check_mlp), in check_vg's style:
# forward within 1e-3 (1 + |raw|) on >= 98% of values and within 2e-2
# max|raw| on every value (bf16 tie noise); dx and every parameter
# gradient by cosine and norm ratio
MLP_ATOL, MLP_SHARE, MLP_MAX = 1e-3, 0.02, 2e-2
MLP_COS, MLP_RATIO = 0.9999, 1e-3
N_MESH_CHUNK = 500_000      # the mesher's points_batch_size
MESH_COUNT_REL = 0.01       # mesh: K5 vs float32 vertex / triangle counts
# engine plain branch: first losses, K5/K6 (bf16 products) against plain
# float32 at the same draws
PLAIN_FIRST_RTOL = {"tracker": 0.1, "mapper": 2e-2}
PSEUDO_REL = 0.15           # weak: median relative pseudo-depth error
WEAK_FRAMES, WEAK_BOOT_BY = 21, 15   # weak: frames run, bootstrap frame
WEAK_T_MAX = 0.05           # weak: translation error of tracked frames
DYN_T_MAX = 1.0             # dynamic: max translation error, any frame


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, reps: int = 10) -> float:
    """Median ms of fn() over reps, CUDA events around each call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# WMMA kernels of mlp_tile.cuh / vg_shared.cuh that only K5/K6 may keep
WMMA_KERNELS = ("vg_forward", "vg_chain", "vg_wgrad", "p1_kernel")


def sass_summary(build, names) -> dict:
    """{library: (count of HGMMA (wgmma) instructions in its SASS, names of
    its kernels)} from cuobjdump -sass."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", build._lib_path(name)],
                              capture_output=True, text=True,
                              timeout=300).stdout.splitlines()
        out[name] = (sum("HGMMA" in ln for ln in sass),
                     [ln.split("Function :", 1)[1].strip() for ln in sass
                      if "Function :" in ln])
    return out


def spilled(log: str) -> list:
    """ptxas -v lines of a build log that report a spilled byte."""
    import re
    return [ln.strip() for ln in log.splitlines()
            if any(int(v) for v in re.findall(r"(\d+) bytes spill", ln))]


def rays_batch(torch, gen, n, cams, depth_hi=3.0):
    """n random pixels spread over the frames of `cams` (F, 7) at the
    bench intrinsics -> rays_o, rays_d, gt_d, gt_c (on the card)."""
    from pointnerf_slam_torch.core.rays import rays_from_uv
    from pointnerf_slam_torch.core.se3 import camera_from_tensor
    dev = cams.device
    F = cams.shape[0]
    f = torch.arange(n, device=dev) % F
    i = torch.randint(0, W, (n,), generator=gen, device=dev).float()
    j = torch.randint(0, H, (n,), generator=gen, device=dev).float()
    c2w = camera_from_tensor(cams)[f]
    ro, rd = rays_from_uv(i, j, c2w, FX, FX, CX, CY)
    gt_d = 0.5 + (depth_hi - 0.5) * torch.rand(n, generator=gen, device=dev)
    gt_c = torch.rand(n, 3, generator=gen, device=dev)
    return ro.contiguous(), rd.contiguous(), gt_d, gt_c


def check_p1(torch, F, pw, rays, bound, cell, S1=32):
    """p1_sigma against its plain version at S1 samples per ray. Returns
    the max abs err (the sigma noise: the largest difference seen at any
    point)."""
    sk = F.p1_sigma(pw, rays, bound, S1)
    sp = F.p1_sigma_reference(pw, rays, bound, S1)
    torch.cuda.synchronize()
    inside = sp != 100.0
    err = (sk - sp).abs()
    scale = float(sp[inside].abs().max())
    frac = float((err > SIG_ATOL * (1 + sp.abs())).float().mean())
    print(f"kernels[{cell}]: p1_sigma max err {float(err.max()):.3e} "
          f"(max|s| {scale:.3e}), {frac:.5f} of values beyond "
          f"{SIG_ATOL}(1+|s|)", flush=True)
    if not torch.isfinite(sk).all() or float(err.max()) > SIG_MAX * scale \
            or frac > SIG_SHARE:
        fail(f"p1_sigma[{cell}]: max err {float(err.max())} (scale "
             f"{scale}), {frac:.4f} beyond {SIG_ATOL}(1+|s|)")
    return float(err.max())


def last_step(torch, F, params, ro, rd, z2, bound, sig_noise):
    """Rays at the last-interval step, from the plain version's samples:
    alpha over the 1e10-long last interval is 0 or 1 as sigma there is <= 0
    or > 0, so where that sigma lies within the kernel's sigma noise of 0
    and light reaches the last sample (transmittance T > 1e-3), the last
    weight may be 0 in one version and T in the other. Returns (mask, T,
    z of the last sample, max |rgb| of the last sample)."""
    from pointnerf_slam_torch.models.decoders import mlp_apply
    from pointnerf_slam_torch.ops.render_math import weights
    n, S = z2.shape
    x = ro[:, None, :] + rd[:, None, :] * z2[..., None]
    with torch.no_grad():
        raw = mlp_apply(params, x.reshape(-1, 3), bf16=True).reshape(n, S, 4)
    sig = torch.where(F._inside(x, bound), raw[..., 3],
                      torch.full_like(raw[..., 3], 100.0))
    w = weights(sig, z2, torch.linalg.norm(rd, dim=1, keepdim=True))
    T = (1.0 - w[:, :-1].sum(1)).clamp(min=0.0)
    mask = (sig[:, -1].abs() <= sig_noise) & (T > 1e-3)
    return mask, T, z2[:, -1], raw[:, -1, :3].abs().amax(1)


def check_rays(torch, name, outs_k, outs_p, params, ro, rd, z2, bound,
               sig_noise):
    """Per-ray depth and colour of a kernel against its plain version at
    the same samples z2: within 1e-3 on >= 95% of rays, within 2e-2 on
    every ray off the last-interval step, and at the step within the last
    weight's jump + 2e-2. Returns (step mask, max error off the step)."""
    from pointnerf_slam_torch.ops import fused_vg as F
    step, T, z_last, c_last = last_step(torch, F, params, ro, rd, z2, bound,
                                        sig_noise)
    worst = 0.0
    for a, b, nm, jump in ((outs_k[0], outs_p[0], "depth", T * z_last),
                           (outs_k[1], outs_p[1], "color", T * c_last)):
        d = (a - b).abs().reshape(a.shape[0], -1).amax(1)
        beyond = d > OUT_ATOL
        frac = float(beyond.float().mean())
        off = d[~step]
        off_max = float(off.max()) if off.numel() else 0.0
        worst = max(worst, off_max)
        over = d[step] - jump[step]
        step_over = float(over.max()) if over.numel() else 0.0
        print(f"kernels: {name}: {nm} {frac:.4f} of rays beyond "
              f"{OUT_ATOL} (max {float(d.max()):.3e}); {int(step.sum())} "
              f"rays at the last step ({int((beyond & step).sum())} of them "
              f"beyond); max off the step {off_max:.3e}; at the step, max "
              f"err - jump {step_over:.3e}", flush=True)
        if frac > OUT_SHARE or off_max > OUT_MAX or step_over > OUT_MAX:
            fail(f"{name}: {nm}: {frac:.4f} of rays beyond {OUT_ATOL}, max "
                 f"off the last step {off_max}, at the step err - jump "
                 f"{step_over}")
    return step, worst


def check_vg(name, out_k, out_p, spec, inputs, params, sig_noise):
    """Kernel vs plain version of fused_vg, tolerances as at the top of
    the file. Returns the largest abs error of the gradients the variant
    produces (parameter gradients, else ray gradients off the kinks)."""
    import torch
    from pointnerf_slam_torch.ops import fused_vg as F
    ro, rd, gt_d, gt_c, ray_w, t_reg, z2, bound = inputs
    lk, gk, ok, dk, ak = out_k
    lp, gp, op, dp, ap = out_p
    errs = []
    if abs(float(lk) - float(lp)) > LOSS_RTOL * abs(float(lp)):
        fail(f"{name}: loss {float(lk)} vs {float(lp)}")
    step = check_rays(torch, name, (ak[0], ak[2]), (ap[0], ap[2]), params,
                      ro, rd, z2, bound, sig_noise)[0]
    # A ray at a kink of its loss (an L1 residual whose sign differs
    # between the two versions, or the last-interval step) has a gradient
    # that the noise decides; the gradients are judged on the other rays
    # (for the tracker's ray gradients also on those with var >= 1e-4
    # alone: var ~ 0 weighs 1/sqrt(1e-10) = 1e5 and would set the sum).
    kink = step | ((torch.sign(gt_d - ak[0]) != torch.sign(gt_d - ap[0]))
                   & (gt_d > 0))
    if spec.with_color:
        kink |= (torch.sign(gt_c - ak[2]) != torch.sign(gt_c - ap[2])).any(1)
    # the kinks may hold at most OUT_SHARE of the rays, whichever gradients
    # are judged off them: a kernel whose depth or colour is biased flips
    # many residual signs and fails here
    kink_share = float(kink.float().mean())
    if kink_share > OUT_SHARE:
        fail(f"{name}: {kink_share:.4f} of rays at a kink")
    if spec.param_grads:
        # parameter gradients sum over every ray: read on all rays, then
        # judged with the kink rays' weight 0 in both versions
        def rel_errs(gk, gp):
            return {k: float((gk[k].float() - gp[k].float()).abs().max())
                    / (float(gp[k].float().abs().max()) + 1e-30) for k in gp}
        every = rel_errs(gk, gp)
        w_all = max(every, key=every.get)
        tag = "all rays"
        if bool(kink.any()):
            rw = ray_w.masked_fill(kink, 0.0)
            off = (ro, rd, gt_d, gt_c, rw, t_reg, z2, bound)
            gp = F.fused_vg_reference(spec, params, *off)[1]
            gk = (F._fused_vg_cuda(spec, params, *off)[1] if ro.is_cuda
                  else gp)
            tag = f"off {int(kink.sum())} rays at a kink"
        worst = (0.0, "")
        for k in gp:
            a, b = gk[k].float(), gp[k].float()
            err = float((a - b).abs().max())
            errs.append(err)
            worst = max(worst, (err / (float(b.abs().max()) + 1e-30), k))
            if err > GRAD_ATOL * float(b.abs().max()) + 1e-8:
                fail(f"{name}: grad {k} [{tag}] max err {err} vs scale "
                     f"{float(b.abs().max())}")
        print(f"kernels: {name}: parameter gradients [{tag}] within "
              f"{GRAD_ATOL} max|g|, largest {worst[0]:.3e} ({worst[1]}); "
              f"[all rays, read] largest {every[w_all]:.3e} ({w_all})",
              flush=True)
    if spec.mode == "tracker":
        low = float((ap[1] < VAR_ORDINARY).float().mean())
        print(f"kernels: {name}: {low:.4f} of rays with var < "
              f"{VAR_ORDINARY}, loss {float(lp):.6g}", flush=True)
    if spec.with_ray_grads:
        sets = [("all", torch.ones_like(kink), False), ("off kinks", ~kink,
                                                        True)]
        if spec.mode == "tracker":
            sets.append((f"off kinks, var>={VAR_ORDINARY:g}",
                         ~kink & (ap[1] >= VAR_ORDINARY), True))
        for tag, m, judged in sets:
            n_m = int(m.sum())
            if judged and n_m < m.numel() // 2:
                fail(f"{name}: only {n_m} rays {tag}")
            for a, b, nm in ((ok, op, "rays_o"), (dk, dp, "rays_d")):
                a, b = a[m].reshape(-1).double(), b[m].reshape(-1).double()
                cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
                ratio = float(a.norm() / (b.norm() + 1e-30))
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                print(f"kernels: {name}: {nm}[{tag}, {n_m} rays] cos "
                      f"{cos:.6f} ratio {ratio:.5f} max err {err:.3e} = "
                      f"{err / (scale + 1e-30):.3e} max|g|", flush=True)
                if not judged:
                    continue
                if not spec.param_grads:
                    errs.append(err)
                if not (cos > RAY_COS and RAY_RATIO[0] <= ratio
                        <= RAY_RATIO[1]):
                    fail(f"{name}: {nm}[{tag}] cos {cos} ratio {ratio}")
    return max(errs, default=0.0)


# (counter name, mode, options, on the main path): the main path runs the
# mapper without ray grads (no BA) and the tracker; the with-ray-grads
# mapper (bundle adjustment) is checked only
VG_VARIANTS = [
    ("fused_vg_mapper", "mapper",
     dict(w_color=0.05, w_reg=0.0005, with_color=True, w_beyond=1.0,
          with_ray_grads=False), True),
    ("fused_vg_mapper", "mapper",
     dict(w_color=0.05, w_reg=0.0005, with_color=True, w_beyond=1.0,
          with_ray_grads=True), False),
    ("fused_vg_tracker", "tracker",
     dict(w_color=0.5, with_color=True, param_grads=False), True),
]


def run_vg(torch, cell, dec, name, mode, kw, inputs, sig_noise):
    """One fused_vg variant on `inputs` (rays, gt, ray_w, t_reg, bound):
    prepare z2, then the kernel against the plain version. Returns
    (main, full inputs, max abs err)."""
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.render.renderer import RenderConfig
    ro, rd, gt_d, gt_c, ray_w, t_reg, bound = inputs
    prep, main = F.make_fused_vg_split(RenderConfig(), mode, **kw)
    z2 = prep(dec, ro, rd, gt_d, bound)
    args = (ro, rd, gt_d, gt_c, ray_w, t_reg, z2, bound)
    params = F.params_of(dec)
    out_k = main(dec, *args)
    out_p = F.fused_vg_reference(main.spec, params, *args)
    torch.cuda.synchronize()
    tag = f"{name}{'' if kw.get('with_ray_grads', True) else '_noray'}"
    err = check_vg(f"{tag}[{cell}]", out_k, out_p, main.spec, args, params,
                   sig_noise)
    print(f"kernels[{cell}]: {tag} ok, loss {float(out_k[0]):.6g} vs "
          f"{float(out_p[0]):.6g}, max err {err:.3e}", flush=True)
    return main, args, err


def phase_kernels(torch, report):
    """Each kernel against its plain version at the main path's shapes, on
    a random decoder, and timed.

    Tolerances (top of the file): the JAX reference's own for the loss
    (rtol 1e-3), parameter gradients (atol 2e-2 * max|g|) and ray
    gradients (cosine > 0.999, norm ratio in [0.98, 1.02]). Outputs per
    point or ray carry bf16 tie noise: the kernel and the plain version
    sum their float32 products in different orders, and where a
    pre-activation lands within that difference of a bf16 rounding tie,
    one hidden value rounds the other way (~1.5e-5 of values, so ~1.5% of
    points with 1024 hidden values each) and that point's output moves by
    up to ~0.5%; the kernel also rounds the backward cotangents of the dh
    chain to bf16, as the TPU kernel does. So p1 sigma: within
    2e-2 * max|s| everywhere and within 1e-3 * (1 + |s|) on >= 95% of
    values. Depth and colour: within 1e-3 on >= 95% of rays and within
    2e-2 on every ray, except at the last-interval step (`last_step`),
    where the error may exceed the jump of the last weight (T * z,
    T * |rgb|) by no more than 2e-2. Ray gradients: judged off the loss
    kinks, where an L1 residual has the same sign in both versions (the
    kinks may hold at most 5% of rays); per element they are read, not
    judged (bf16 cotangents move single rays by up to ~10% of max|g|).
    Parameter gradients are judged the same way: off the kink rays (both
    versions run again with those rays' weight 0) when there are any,
    under the same 5% cap, with the all-rays errors printed beside them; a
    single ray whose depth residual flips sign can move the B and b0
    gradients past 2e-2 max|g|, in the WMMA and the Hopper K1 alike
    (PERF.md, Findings)."""
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.ops import fused_vg as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    bound = torch.tensor([[-3.5, 3.5]] * 3, device=dev)
    cams = torch.tensor([[1.0, 0, 0, 0, 0, 0, 2.5]] * 6, device=dev)
    cams[:, 4] = torch.linspace(-0.3, 0.3, 6, device=dev)
    n_map, n_trk = 5000 // 6 * 6, 5000
    params = F.params_of(dec)
    pw = F.pack_weights(params)
    nw = sum(t.numel() * t.element_size() for t in [pw.Bp, *pw.Ws, *pw.bs])

    # K2: p1 sigma
    ro, rd, gt_d, gt_c = rays_batch(torch, gen, n_map, cams)
    rays = F._pack_rays(ro, rd, gt_d, bound)
    p1_err = check_p1(torch, F, pw, rays, bound, "random")
    P = n_map * 32
    ms = timed(lambda: F.p1_sigma(pw, rays, bound, 32))
    pms = timed(lambda: F.p1_sigma_reference(pw, rays, bound, 32), 3)
    bms, by = bound_ms(P * FLOP_FWD, rays.numel() * 4 + nw + P * 4)
    report["p1_sigma"] = dict(
        route="cuda", source="pointnerf_slam_torch/ops/csrc/p1_sigma.cu",
        replaces="pointnerf_slam_tpu/ops/fused_vg.py:284",
        max_abs_err=p1_err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=None, bound_share=bms / ms)
    print(f"kernels: p1_sigma {ms:.3f} ms (plain {pms:.3f} ms, bound "
          f"{bms:.4f} ms by {by}, {100 * bms / ms:.1f}% of it)", flush=True)

    # K1: mapper and tracker variants at one z2 each
    for name, mode, kw, on_path in VG_VARIANTS:
        n = n_map if mode == "mapper" else n_trk
        ro, rd, gt_d, gt_c = rays_batch(torch, gen, n, cams)
        ray_w = torch.ones(n, device=dev)
        ray_w[1::5] = 1.2
        t_reg = torch.rand(n, 32, generator=gen, device=dev)
        main, args, err = run_vg(torch, "random", dec, name, mode, kw,
                                 (ro, rd, gt_d, gt_c, ray_w, t_reg, bound),
                                 2 * p1_err)
        ms = timed(lambda: main(dec, *args))
        pms = timed(lambda: F.fused_vg_reference(main.spec, params, *args),
                    3)
        spec = main.spec
        Pn = n * (44 + (32 if spec.with_reg else 0))
        mult = 1 + 1 + (1 if spec.param_grads else 0)
        in_bytes = (n * (8 + 4 + 44 + (32 if spec.with_reg else 0)) * 4
                    + nw)
        out_bytes = n * 16 * 4 + (nw * 2 if spec.param_grads else 0)
        bms, by = bound_ms(Pn * FLOP_FWD * mult, in_bytes + out_bytes)
        if on_path:
            report[name] = dict(
                route="cuda", source="pointnerf_slam_torch/ops/csrc/"
                "fused_vg.cu", replaces="pointnerf_slam_tpu/ops/"
                "fused_vg.py:304", max_abs_err=err, ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, library_ms=None,
                bound_share=bms / ms)
        print(f"kernels: {name} {ms:.3f} ms (plain {pms:.3f} ms, bound "
              f"{bms:.4f} ms by {by}, {100 * bms / ms:.1f}% of it)",
              flush=True)

    # K3/K4
    phase_kernels_mk(torch, report, dec, "random",
                     lambda n: rays_batch(torch, gen, n, cams)[:3], bound,
                     2 * p1_err)
    # K5/K6
    phase_kernels_mlp(torch, report, dec, "random",
                      lambda n: rays_batch(torch, gen, n, cams), bound,
                      timing=True)


def cos_ratio(a, b):
    a, b = a.reshape(-1).double(), b.reshape(-1).double()
    return (float(a @ b / (a.norm() * b.norm() + 1e-30)),
            float(a.norm() / (b.norm() + 1e-30)))


def middle_candidates(torch, s1, rays, S1, SI):
    """The plain middle (weights, inverse CDF with w + 1e-5 and the denom
    switch, as core.sampling.sample_pdf) on the given pass-1 sigma, with
    every alternative that float32 rounding of the CDF allows: where a u
    lies within MID_ETA of a CDF value the count of cdf <= u may differ by
    one, and where a denom lies within 2 MID_ETA of 1e-5 the switch may
    flip (at u = 1 the last CDF value is 1 up to rounding, so a ray whose
    last interior bin is empty has two answers there). Returns z1 (N, S1),
    and per importance sample the candidates z (N, SI, C), their
    tolerances (N, SI, C) and which are allowed (N, SI, C)."""
    from pointnerf_slam_torch.ops.render_math import weights, z_pass1
    z1 = z_pass1(rays[:, 6:7], rays[:, 7:8], S1)
    dn = torch.sqrt(torch.sum(rays[:, 3:6] * rays[:, 3:6], 1, keepdim=True))
    w = weights(s1, z1, dn)[:, 1:-1] + 1e-5
    cdf = torch.cat([torch.zeros_like(w[:, :1]),
                     torch.cumsum(w / w.sum(1, keepdim=True), 1)], 1)
    bins = 0.5 * (z1[:, 1:] + z1[:, :-1])
    M = cdf.shape[1]
    u = torch.linspace(0.0, 1.0, SI, device=s1.device).expand(
        s1.shape[0], SI).contiguous()
    i0 = torch.searchsorted(cdf, u, right=True)
    zs, tols, oks = [], [], []
    for di in (-1, 0, 1):
        inds = (i0 + di).clamp(1, M)
        if di == -1:        # cdf[i0 - 1] <= u, within rounding of u
            ok_i = (i0 >= 2) & (cdf.gather(1, (i0 - 1).clamp(0, M - 1))
                                >= u - MID_ETA)
        elif di == 1:       # cdf[i0] > u, within rounding of u
            ok_i = (i0 < M) & (cdf.gather(1, i0.clamp(max=M - 1))
                               <= u + MID_ETA)
        else:
            ok_i = torch.ones_like(u, dtype=torch.bool)
        below, above = inds - 1, inds.clamp(max=M - 1)
        cb, ca = cdf.gather(1, below), cdf.gather(1, above)
        bb, ba = bins.gather(1, below), bins.gather(1, above)
        denom = ca - cb
        switch = denom < 1e-5
        edge = (denom - 1e-5).abs() <= 2 * MID_ETA
        for flip in (False, True):
            sw = switch ^ flip
            d = torch.where(sw, torch.ones_like(denom), denom)
            pos = d > 0             # a flip to a zero denom is no candidate
            d = torch.where(pos, d, torch.ones_like(d))
            z = bb + (u - cb) / d * (ba - bb)
            zs.append(z)
            tols.append((ba - bb).abs() * 3 * MID_ETA / d
                        + 4 * 1.2e-7 * z.abs())
            oks.append(ok_i & pos & (edge if flip else torch.ones_like(edge)))
    return z1, torch.stack(zs, 2), torch.stack(tols, 2), torch.stack(oks, 2)


def check_middle(torch, tag, z2, s1, rays, S1, SI):
    """K3's middle against the plain one on the same pass-1 sigma (K2's
    output: the device code K3 runs for pass 1): z2 must hold z1 and, in
    order, SI importance samples each within its tolerance (the CDF's
    rounding, MID_ETA, through 1 / denom, plus 4 ulp) of an allowed plain
    candidate, on every sample of every ray. Returns (largest CDF error
    the samples imply, share of samples that took a non-primary
    candidate)."""
    n, S2 = z2.shape
    z1, cz, ct, cok = middle_candidates(torch, s1, rays, S1, SI)
    if not bool((z2[:, 1:] >= z2[:, :-1]).all()):
        fail(f"{tag}: z2 not sorted")
    # take out the S1 pass-1 depths, each the nearest entry not yet taken
    # (z1 may hold near-equal values where far is close to near)
    taken = torch.zeros_like(z2, dtype=torch.bool)
    far_off = torch.zeros(n, device=z2.device)
    for s in range(S1):
        d = (z2 - z1[:, s:s + 1]).abs().masked_fill(taken, float("inf"))
        dmin, j = d.min(1)
        taken[torch.arange(n, device=z2.device), j] = True
        far_off = torch.maximum(far_off, dmin / (2.4e-7 * z1[:, s].abs()
                                                 + 1e-30))
    if not bool((far_off <= 1.0).all()):
        fail(f"{tag}: z2 does not hold the {S1} pass-1 depths (ray "
             f"{int(far_off.argmax())})")
    zk = z2[~taken].reshape(n, SI)
    # the samples in ascending order of the primary candidate (the
    # inverse CDF runs backwards on rays whose far lies below near)
    order = cz[..., 2].argsort(dim=1, stable=True)[..., None].expand_as(cz)
    cz, ct, cok = cz.gather(1, order), ct.gather(1, order), cok.gather(
        1, order)
    dz = (zk[..., None] - cz).abs()
    within = (dz <= ct) & cok
    good = within.any(2)
    # the CDF error each deviation implies: dz = |ba - bb| / d * err
    ulp = 4 * 1.2e-7 * cz.abs()
    slope = (ct - ulp) / (3 * MID_ETA)
    implied = torch.where(dz <= ulp, torch.zeros_like(dz),
                          (dz - ulp) / slope.clamp(min=1e-30))
    implied = torch.where(cok, implied, torch.full_like(dz, float("inf")))
    worst = float(implied.amin(2).max())
    alt = float((good & ~within[..., 2]).float().mean())   # 2: primary
    print(f"kernels: {tag}: middle on K2's sigma: {int((~good).sum())} of "
          f"{good.numel()} importance samples off every plain candidate; "
          f"largest implied CDF error {worst:.3e} (bound "
          f"{3 * MID_ETA:.1e}); {alt:.5f} of samples on a rounding "
          f"alternative", flush=True)
    if not bool(good.all()):
        r = int((~good).any(1).nonzero()[0, 0])
        fail(f"{tag}: middle: ray {r} samples {zk[r].tolist()} vs plain "
             f"{cz[r, :, 2].tolist()}")
    return worst, alt


def check_render(torch, cell, dec, ro, rd, gt_d, t_reg, bound, with_reg,
                 sig_noise, timing=False, S1=32, SI=12):
    """K3 and K4 against fused_render_reference's pieces on the same
    inputs. K3's middle against the plain middle on K3's own pass-1 sigma
    (check_middle: every sample of every ray); K3's importance samples z2
    against the plain version's end to end (<= 5% of rays moved by > 1% of
    their pass-1 spacing: the inverse CDF follows the noisy pass-1 sigma
    of either version); K3's
    depth and colour against the plain pass 2 at K3's own z2 with
    check_rays' bounds, var within 1e-3 (1 + var) on >= 95% of rays,
    sigma_reg as p1 sigma; K4's gradients of a loss linear in the outputs
    with fixed random cotangents (the same for both) against autograd of
    the plain pass 2 at the same z2: ray gradients (off the last step) and
    weight gradients by cosine and norm ratio, the ray gradients once with
    and once without weight gradients (the tracker's launch), which must
    agree. Returns ({name: report} with the timings, max output error, max
    gradient error)."""
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.ops import megakernel as MK
    from pointnerf_slam_torch.render.renderer import RenderConfig
    n = ro.shape[0]
    tag = f"megakernel[{cell}, {n} rays, {S1}+{SI}, reg {with_reg}]"
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    pw = F.pack_weights(params)
    dep, var, col, sr, z2, saved = MK.k3_forward(pw, ro, rd, gt_d, t_reg,
                                                 bound, S1, SI, with_reg)
    check_middle(torch, tag, z2, F.p1_sigma(pw, saved[0], bound, S1),
                 saved[0], S1, SI)
    z2p = MK.plain_z2(params, ro, rd, gt_d, bound, S1, SI)
    dz = (z2 - z2p).abs().amax(1)
    rays = saved[0]
    rel = dz / ((rays[:, 7] - 0.01 * rays[:, 6]).abs() / (S1 - 1) + 1e-30)
    zshare = float((rel > Z2_REL).float().mean())
    s5, s_abs = (float((rel > 0.05).float().mean()),
                 float((dz > 1e-3).float().mean()))
    print(f"kernels: {tag}: z2 end to end: {zshare:.4f} of rays moved by "
          f"> {Z2_REL} of their pass-1 spacing ({s5:.4f} by > 0.05, "
          f"{s_abs:.4f} by > 1e-3 m; max {float(dz.max()):.3e} = "
          f"{float(rel.max()):.3e} spacings)", flush=True)
    if not torch.isfinite(z2).all() or zshare > Z2_SHARE:
        fail(f"{tag}: z2 of {zshare} of rays off the plain version's")
    with torch.no_grad():
        pd, pv, pc, ps = MK.render_at(params, ro, rd, gt_d, t_reg, bound, z2,
                                      with_reg)
    step, err = check_rays(torch, tag, (dep, col), (pd, pc), params, ro, rd,
                           z2, bound, sig_noise)
    vfrac = float(((var - pv).abs() > OUT_ATOL * (1 + pv.abs()))[~step]
                  .float().mean())
    print(f"kernels: {tag}: var {vfrac:.4f} of rays off the step beyond "
          f"{OUT_ATOL}(1+var)", flush=True)
    if vfrac > OUT_SHARE:
        fail(f"{tag}: var beyond on {vfrac} of rays")
    if with_reg:
        inside = ps != 100.0
        se = (sr - ps).abs()
        scale = float(ps[inside].abs().max())
        sfrac = float((se > SIG_ATOL * (1 + ps.abs())).float().mean())
        print(f"kernels: {tag}: sigma_reg max err {float(se.max()):.3e} "
              f"(max|s| {scale:.3e}), {sfrac:.5f} beyond", flush=True)
        if float(se.max()) > SIG_MAX * scale or sfrac > SIG_SHARE:
            fail(f"{tag}: sigma_reg err {float(se.max())}, {sfrac} beyond")
    else:
        assert float(sr.abs().max()) == 0.0

    gen = torch.Generator(device=ro.device).manual_seed(11)
    cot = [torch.randn(n, generator=gen, device=ro.device),
           torch.randn(n, generator=gen, device=ro.device),
           torch.randn(n, 3, generator=gen, device=ro.device),
           torch.randn(n, t_reg.shape[1], generator=gen, device=ro.device)]
    if not with_reg:
        cot[3] = torch.zeros_like(cot[3])

    def lin(outs):
        return sum((o * c).sum() for o, c in zip(outs, cot))

    render = MK.make_fused_render(RenderConfig(N_samples=S1,
                                               N_importance=SI),
                                  with_reg=with_reg)
    grads = {}
    for pg in (False, True):
        pk = {k: v.clone().requires_grad_(pg) for k, v in params.items()}
        o_, d_ = ro.clone().requires_grad_(True), rd.clone().requires_grad_(
            True)
        outs = render(pk, o_, d_, gt_d, t_reg, bound)
        wrt = [o_, d_] + ([pk[k] for k in F.PARAM_NAMES] if pg else [])
        grads[pg] = torch.autograd.grad(lin(outs), wrt)
    pp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    o_, d_ = ro.clone().requires_grad_(True), rd.clone().requires_grad_(True)
    gp = torch.autograd.grad(
        lin(MK.render_at(pp, o_, d_, gt_d, t_reg, bound, z2, with_reg)),
        [o_, d_] + [pp[k] for k in F.PARAM_NAMES])
    gerr = 0.0
    for i, nm in enumerate(("rays_o", "rays_d")):
        a, a0, b = grads[True][i], grads[False][i], gp[i]
        same = float((a - a0).abs().max()) <= 1e-6 * float(a.abs().max())
        cos, ratio = cos_ratio(a[~step], b[~step])
        e = float((a - b)[~step].abs().max())
        gerr = max(gerr, e)
        print(f"kernels: {tag}: {nm} off the step cos {cos:.6f} ratio "
              f"{ratio:.5f} max err {e:.3e} = "
              f"{e / (float(b.abs().max()) + 1e-30):.3e} max|g|; without "
              f"weight gradients the same: {same}", flush=True)
        if not (same and cos > MK_RAY_COS
                and MK_RAY_RATIO[0] < ratio < MK_RAY_RATIO[1]):
            fail(f"{tag}: {nm} cos {cos} ratio {ratio} same {same}")
    for k, a, b in zip(F.PARAM_NAMES, grads[True][2:], gp[2:]):
        cos, ratio = cos_ratio(a, b)
        if not (cos > MK_W_COS and MK_W_RATIO[0] < ratio < MK_W_RATIO[1]):
            fail(f"{tag}: grad {k} cos {cos} ratio {ratio}")
    print(f"kernels: {tag}: weight gradients within cos {MK_W_COS}, ratio "
          f"{MK_W_RATIO}", flush=True)
    if not timing:
        return {}, err, gerr
    rays, treg, b6, SRk = saved
    S2 = S1 + SI
    ms3 = timed(lambda: MK.k3_forward(pw, ro, rd, gt_d, t_reg, bound, S1,
                                      SI, with_reg))
    with torch.no_grad():
        pms3 = timed(lambda: MK.fused_render_reference(
            params, ro, rd, gt_d, t_reg, bound, S1, SI, with_reg), 3)
    ms4 = timed(lambda: MK.k4_backward(pw, rays, treg, z2, b6, *cot, S1,
                                       SRk, False))
    o_, d_ = ro.clone().requires_grad_(True), rd.clone().requires_grad_(True)
    loss_p = lin(MK.render_at(params, o_, d_, gt_d, t_reg, bound, z2,
                              with_reg))
    pms4 = timed(lambda: torch.autograd.grad(loss_p, [o_, d_],
                                             retain_graph=True), 3)
    nw = sum(t.numel() * t.element_size() for t in [pw.Bp, *pw.Ws, *pw.bs])
    SR = 32 if with_reg else 0
    b3, by3 = bound_ms(n * (S1 + S2 + SR) * FLOP_FWD,
                       n * (8 + SR) * 4 + nw + n * (5 + SR + S2) * 4)
    # the tracker's launch: recompute forward and dh chain, no weight grads
    b4, by4 = bound_ms(n * (S2 + SR) * FLOP_FWD * 2,
                       n * (8 + S2 + 8 + SR) * 4 + nw + n * 8 * 4)
    print(f"kernels: {tag}: K3 {ms3:.3f} ms (plain {pms3:.3f} ms, bound "
          f"{b3:.4f} ms by {by3}, {100 * b3 / ms3:.1f}% of it); K4 "
          f"{ms4:.3f} ms (plain backward {pms4:.3f} ms, bound {b4:.4f} ms "
          f"by {by4}, {100 * b4 / ms4:.1f}% of it)", flush=True)
    src = "pointnerf_slam_torch/ops/csrc/megakernel.cu"
    return {"megakernel_fwd": dict(
        route="cuda", source=src,
        replaces="pointnerf_slam_tpu/ops/megakernel.py:393",
        max_abs_err=err, ms=ms3, plain_ms=pms3, bound_ms=b3, bound_by=by3,
        library_ms=None, bound_share=b3 / ms3), "megakernel_bwd": dict(
        route="cuda", source=src,
        replaces="pointnerf_slam_tpu/ops/megakernel.py:480",
        max_abs_err=gerr, ms=ms4, plain_ms=pms4, bound_ms=b4, bound_by=by4,
        library_ms=None, bound_share=b4 / ms4)}, err, gerr


def phase_kernels_mk(torch, report, dec, cell, rays_of, bound, sig_noise):
    """K3/K4 at the tracker shape (5000 rays, no regulation; timed on the
    random cell) and the mapper shape (4998 rays, with regulation).
    rays_of(n) -> (rays_o, rays_d, gt_d) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for n, with_reg in ((5000, False), (4998, True)):
        ro, rd, gt_d = rays_of(n)
        t_reg = torch.rand(n, 32, generator=gen, device="cuda")
        rep, err, gerr = check_render(
            torch, cell, dec, ro, rd, gt_d, t_reg, bound, with_reg,
            sig_noise, timing=(cell == "random" and not with_reg))
        report.update(rep)
        for k, e in (("megakernel_fwd", err), ("megakernel_bwd", gerr)):
            report[k]["max_abs_err"] = max(report[k]["max_abs_err"], e)


def check_mlp(torch, tag, params, x, g=None):
    """K5 (and, given a cotangent g, K6) against the plain versions on the
    same inputs, tolerances MLP_* at the top of the file. K6's launches
    without weight gradients (the tracker's) and without dx (the mapper's
    without BA) must give the full launch's dx and weight gradients bit for
    bit. Returns (forward max abs err, gradient max abs err or None)."""
    from pointnerf_slam_torch.ops import fused_mlp as M
    from pointnerf_slam_torch.ops.fused_vg import PARAM_NAMES
    n = x.shape[0]
    out_k = M.k5_forward(params, x)
    with torch.no_grad():
        out_p = M.mlp_forward_reference(params, x)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs()
    scale = float(out_p.abs().max())
    share = float((err > MLP_ATOL * (1 + out_p.abs())).float().mean())
    print(f"kernels: K5[{tag}, {n} points]: max err {float(err.max()):.3e} "
          f"(max|raw| {scale:.3e}), {share:.5f} of values beyond "
          f"{MLP_ATOL}(1+|raw|)", flush=True)
    if not bool(torch.isfinite(out_k).all()) or share > MLP_SHARE \
            or float(err.max()) > MLP_MAX * scale:
        fail(f"K5[{tag}]: max err {float(err.max())} (scale {scale}), "
             f"{share} beyond")
    if g is None:
        return float(err.max()), None
    dx_k, gk = M.k6_backward(params, x, g, True, True)
    dx_only, _ = M.k6_backward(params, x, g, False, True)
    _, g_only = M.k6_backward(params, x, g, True, False)
    dx_p, gp = M.mlp_backward_reference(params, x, g)
    torch.cuda.synchronize()
    if not torch.equal(dx_k, dx_only) or not all(
            torch.equal(gk[k], g_only[k]) for k in PARAM_NAMES):
        fail(f"K6[{tag}]: the partial launches differ from the full one")
    gerr, worst = 0.0, (1.0, 1.0, "")
    for nm, a, b in [("x", dx_k, dx_p)] + [(k, gk[k], gp[k])
                                           for k in PARAM_NAMES]:
        cos, ratio = cos_ratio(a, b)
        gerr = max(gerr, float((a - b).abs().max()))
        worst = min(worst, (cos, ratio, nm))
        if not (bool(torch.isfinite(a).all()) and cos >= MLP_COS
                and abs(ratio - 1) <= MLP_RATIO):
            fail(f"K6[{tag}]: grad {nm} cos {cos} ratio {ratio}")
    print(f"kernels: K6[{tag}, {n} points]: dx and {len(PARAM_NAMES)} "
          f"parameter gradients within cos {MLP_COS}, ratio 1 +- "
          f"{MLP_RATIO}; lowest cos {worst[0]:.7f} ({worst[2]}, ratio "
          f"{worst[1]:.6f}); max abs err {gerr:.3e}; partial launches "
          f"equal", flush=True)
    return float(err.max()), gerr


def mesh_chunk(torch, dev):
    """The mesher's middle chunk (N_MESH_CHUNK points) of room_bench's
    257^3 grid over its marching_cubes_bound [-2.02, 2.02]^3."""
    ax = torch.arange(-2.02, 2.02 + 1e-6, 4.04 / 256, dtype=torch.float32,
                      device=dev)
    n = ax.numel()
    flat = torch.arange(N_MESH_CHUNK, device=dev) + (n ** 3 // 2
                                                     - N_MESH_CHUNK // 2)
    return torch.stack([ax[flat // (n * n)], ax[(flat // n) % n],
                        ax[flat % n]], 1)


def plain_mapper_points(torch, params, ro, rd, gt_d, gt_c, ray_w, t_reg,
                        bound, w_beyond=1.0):
    """The decoder calls of one plain-path mapper iteration (pass 1, pass
    2, regulation; the mapper's loss with w_color 0.05, w_beyond, 0.0005
    sigma_reg) on the plain decoder: returns (every call's points, the
    points of the calls the loss reaches (pass 2 and regulation), their
    cotangents d loss / d raw)."""
    from pointnerf_slam_torch.models.decoders import mlp_apply
    from pointnerf_slam_torch.ops.fused_vg import _BEYOND_HI, _BEYOND_LO
    from pointnerf_slam_torch.render.renderer import (RenderConfig,
                                                      regulation, render_rays)
    calls = []
    p = {k: v.detach() for k, v in params.items()}

    def field(x):
        out = mlp_apply(p, x.detach()).requires_grad_(True)
        calls.append((x.detach(), out))
        return out

    rc = RenderConfig()
    dep, _, col, w, z, _ = render_rays(field, rc, ro, rd, bound, gt_d,
                                       with_zvals=True)
    m = (gt_d > 0).float() * ray_w
    band = ((z > gt_d[:, None] - _BEYOND_LO)
            & (z < gt_d[:, None] + _BEYOND_HI)).float()
    sig = regulation(field, rc, ro, rd, gt_d, bound, t_reg)
    loss = ((gt_d - dep).abs() * m).sum() \
        + w_beyond * ((1 - (w * band).sum(-1)) * m).sum() \
        + 0.05 * ((gt_c - col).abs().sum(-1) * ray_w).sum() \
        + 0.0005 * (sig.reshape(ro.shape[0], -1).abs() * ray_w[:, None]).sum()
    outs = [o for _, o in calls]
    grads = torch.autograd.grad(loss, outs, allow_unused=True)
    x_all = torch.cat([x for x, _ in calls])
    live = [(x, gr) for (x, _), gr in zip(calls, grads) if gr is not None]
    return (x_all, torch.cat([x for x, _ in live]),
            torch.cat([gr for _, gr in live]).contiguous())


def phase_kernels_mlp(torch, report, dec, cell, rays_of, bound,
                      timing=False):
    """K5 at a mesh chunk (N_MESH_CHUNK grid points) and at the mapper's
    plain-path shape (4998 rays x (32 + 44 + 32) points); K6 at the points
    the mapper's loss reaches (4998 x (44 + 32)), with a random cotangent
    and with the mapper loss's own. rays_of(n) -> (rays_o, rays_d, gt_d,
    gt_c) on the card. With timing, the kernels, their plain versions and
    the decoder as five bf16 torch.matmul calls are timed."""
    from pointnerf_slam_torch.ops import fused_mlp as M
    from pointnerf_slam_torch.ops import fused_vg as F
    dev = torch.device("cuda")
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    gen = torch.Generator(device=dev).manual_seed(13)
    grid = mesh_chunk(torch, dev)
    e5a, _ = check_mlp(torch, f"{cell}, mesh chunk", params, grid)
    ro, rd, gt_d, gt_c = rays_of(4998)
    ray_w = torch.ones(4998, device=dev)
    t_reg = torch.rand(4998, 32, generator=gen, device=dev)
    x_all, x_live, g_loss = plain_mapper_points(
        torch, params, ro, rd, gt_d, gt_c, ray_w, t_reg, bound)
    e5b, _ = check_mlp(torch, f"{cell}, mapper plain path", params, x_all)
    g_rand = torch.randn(x_live.shape[0], 4, generator=gen, device=dev)
    _, e6a = check_mlp(torch, f"{cell}, random cotangent", params, x_live,
                       g_rand)
    _, e6b = check_mlp(torch, f"{cell}, mapper loss cotangent", params,
                       x_live, g_loss)
    rows = report.setdefault("fused_mlp_fwd", dict(max_abs_err=0.0)), \
        report.setdefault("fused_mlp_bwd", dict(max_abs_err=0.0))
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], e5a, e5b)
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], e6a, e6b)
    if not timing:
        return
    pw = F.pack_weights(params)
    nw = sum(t.numel() * t.element_size() for t in [pw.Bp, *pw.Ws, *pw.bs])
    n5, n6 = grid.shape[0], x_live.shape[0]
    ms5 = timed(lambda: M.k5_forward(params, grid))
    with torch.no_grad():
        pms5 = timed(lambda: M.mlp_forward_reference(params, grid), 3)
    ms5m = timed(lambda: M.k5_forward(params, x_all))
    ms6 = timed(lambda: M.k6_backward(params, x_live, g_rand, True, False))
    ms6t = timed(lambda: M.k6_backward(params, x_live, g_rand, False, True))
    pms6 = timed(lambda: M.mlp_backward_reference(params, x_live, g_rand,
                                                  True, False), 3)
    ws = [torch.randn(k, m, generator=gen, device=dev).to(torch.bfloat16)
          for k, m in ((93, 256), (256, 256), (256, 256), (256, 256),
                       (256, 4))]
    a0 = torch.randn(n5, 93, generator=gen, device=dev).to(torch.bfloat16)

    def five_matmuls():
        h = a0
        for w in ws:
            h = torch.matmul(h, w)
        return h

    mm = timed(five_matmuls)
    b5, by5 = bound_ms(n5 * FLOP_FWD, n5 * 28 + nw)
    b6, by6 = bound_ms(n6 * FLOP_FWD * 3, n6 * 40 + nw + F.GRAD_LEN * 4)
    print(f"kernels: K5 {ms5:.3f} ms at {n5} points (plain {pms5:.3f} ms, "
          f"bound {b5:.4f} ms by {by5}; five bf16 torch.matmul calls at "
          f"the same shapes {mm:.3f} ms), {ms5m:.3f} ms at the mapper's "
          f"{x_all.shape[0]}; K6 {ms6:.3f} ms at {n6} points with weight "
          f"gradients (plain {pms6:.3f} ms, bound {b6:.4f} ms by {by6}), "
          f"{ms6t:.3f} ms dx only", flush=True)
    src = "pointnerf_slam_torch/ops/csrc/fused_mlp.cu"
    rows[0].update(route="cuda", source=src,
                   replaces="pointnerf_slam_tpu/ops/fused_mlp.py:104",
                   ms=ms5, plain_ms=pms5, bound_ms=b5, bound_by=by5,
                   library_ms=None, bound_share=b5 / ms5)
    rows[1].update(route="cuda", source=src,
                   replaces="pointnerf_slam_tpu/ops/fused_mlp.py:116",
                   ms=ms6, plain_ms=pms6, bound_ms=b6, bound_by=by6,
                   library_ms=None, bound_share=b6 / ms6)



def bench_data(torch):
    """The bench workload's inputs on the card: a random 680x1200 frame,
    its 6-slot window (3 outers), cameras, masks and the AABB."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    color = torch.rand(H, W, 3, generator=g, device=dev)
    depth = 0.5 + 2.5 * torch.rand(H, W, generator=g, device=dev)
    color_u8 = (color * 255).to(torch.uint8)
    Fn = 6
    return dict(
        color=color, depth=depth, colors=color_u8.expand(3, Fn, H, W, 3),
        depths=depth.expand(3, Fn, H, W),
        cams=torch.tensor([1.0, 0, 0, 0, 0, 0, 2.5], device=dev).expand(
            3, Fn, 7).contiguous(),
        valid=torch.ones(3, Fn, dtype=torch.bool, device=dev),
        ba=torch.zeros(3, Fn, dtype=torch.bool, device=dev),
        bound=torch.tensor([[-3.5, 3.5]] * 3, device=dev))


def bench_ecfg(**over):
    from pointnerf_slam_torch.engine.state import EngineConfig
    kw = dict(H=H, W=W, fx=FX, fy=FX, cx=CX, cy=CY, tracking_pixels=5000,
              num_cam_iters=50, cam_lr=1e-3, mapping_pixels=5000,
              mapping_window_size=5, weak_depth=False,
              depth_supervision=True, no_ba_fast=True, w_beyond_loss=1.0,
              map_resample_every=4, track_resample_every=5)
    kw.update(over)
    return EngineConfig(**kw)


def bench_engine(torch, dec, tracker_iters=50, map_inner=100, mcfg=None,
                 megakernel="auto", **over):
    """The bench workload through the port's tracker and mapper (with
    bench_ecfg's options `over`; map_inner 0: the tracker alone). Returns
    (ms per tracker iteration, ms per mapper iteration, tracker losses,
    mapper losses, {"tracker": launches, "mapper": launches}; None for
    the mapper's numbers without it)."""
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.engine.tracker import make_tracking_step
    from pointnerf_slam_torch.models.decoders import MLPConfig
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dev = torch.device("cuda")
    ecfg = bench_ecfg(num_cam_iters=tracker_iters, megakernel=megakernel,
                      **over)
    mcfg, rcfg = mcfg or MLPConfig(), RenderConfig()
    d = bench_data(torch)
    draws = Draws(torch.Generator(device=dev).manual_seed(2))
    track = make_tracking_step(mcfg, rcfg, ecfg)
    mapper = (make_mapper_step(mcfg, rcfg, ecfg, 6, outer_fused=True)
              if map_inner else None)
    cam0 = torch.tensor([1.0, 0, 0, 0, 0.02, 0, 2.5], device=dev)
    torch.cuda.synchronize()
    l0 = dict(F.launches)
    t0 = time.time()
    _, _, _, tl = track(dec, cam0, d["color"], d["depth"], d["bound"],
                        draws)
    torch.cuda.synchronize()
    t1 = time.time()
    l1 = dict(F.launches)
    m_ms = ml = None
    if map_inner:
        _, ml = mapper(dec, d["colors"], d["depths"], d["cams"], d["valid"],
                       d["ba"], d["bound"], draws, map_inner)
        torch.cuda.synchronize()
        m_ms = (time.time() - t1) * 1e3 / (3 * map_inner)
    l2 = dict(F.launches)
    delta = lambda a, b: {k: b[k] - a[k] for k in a if b[k] != a[k]}
    return ((t1 - t0) * 1e3 / tracker_iters, m_ms, tl, ml,
            {"tracker": delta(l0, l1), "mapper": delta(l1, l2)})


def falls(ls, k: int) -> bool:
    """Finite, and the mean of the last k below the mean of the first k."""
    import torch
    ls = ls.float().cpu()
    return bool(torch.isfinite(ls).all()) \
        and float(ls[-k:].mean()) < float(ls[:k].mean())


def phase_engine(torch):
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(
        "cuda")
    bench_engine(torch, dec, 5, 4)            # warm-up (allocator)
    t_ms, m_ms, tl, ml, _ = bench_engine(torch, dec)
    for nm, ls in (("tracker", tl), ("mapper", ml)):
        if not falls(ls, 5):
            fail(f"engine: {nm} loss not finite or did not fall: "
                 f"{ls[:5].tolist()} -> {ls[-5:].tolist()}")
    print(f"engine: tracker {t_ms:.2f} ms/iter (loss {float(tl[0]):.1f} -> "
          f"{float(tl[-1]):.1f}), mapper {m_ms:.2f} ms/iter (loss "
          f"{float(ml[0]):.1f} -> {float(ml[-1]):.1f})", flush=True)


def phase_engine_dynamic(torch):
    """The bench workload's tracker at full width (680x1200 frame, 5000
    rays, 32 + 12 samples, 50 iterations from a 2 cm shift) with
    tracking.handle_dynamic on: the dynamic-pixel median needs the whole
    batch's depth, so the tracker takes the two-kernel path with one pixel
    batch per iteration (engine/tracker.py `per_iter`), one K3 and one K4
    each: exactly 50 of each, and no other kernel. ms per iteration; the
    loss is finite and falls."""
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(
        "cuda")
    bench_engine(torch, dec, 5, 0, handle_dynamic=True)      # warm-up
    t_ms, _, tl, _, got = bench_engine(torch, dec, map_inner=0,
                                       handle_dynamic=True)
    want = {"tracker": {"megakernel_fwd": 50, "megakernel_bwd": 50},
            "mapper": {}}
    print(f"engine dynamic: handle_dynamic tracker {t_ms:.2f} ms/iter (loss "
          f"{float(tl[0]):.6g} -> {float(tl[-1]):.6g}, first 5 mean "
          f"{float(tl[:5].mean()):.6g}, last 5 {float(tl[-5:].mean()):.6g});"
          f" launches {got}", flush=True)
    if got != want:
        fail(f"engine dynamic: launches {got}, want {want}")
    if not falls(tl, 5):
        fail(f"engine dynamic: loss not finite or did not fall: "
             f"{tl[:5].tolist()} -> {tl[-5:].tolist()}")


def phase_engine_plain(torch):
    """The engine's plain branch (`rendering.megakernel: off`) at full
    width: the bench workload once with MLPConfig(fused=True), which must
    launch K5/K6 exactly 900 / 600 times in the mapper (3 x 100 iterations:
    pass 1, pass 2, regulation forward; pass 2 and regulation backward)
    and 100 / 50 in the tracker (50 iterations, no regulation), and once
    with fused=False (plain float32 torch, the JAX reference's default
    numerics), which launches no kernel. Both losses fall; the first
    losses of the two are compared (the same draws: only the decoder's
    numerics differ)."""
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    runs = {}
    for fused in (True, False):
        mcfg = MLPConfig(fused=fused)
        dec = IMAPDecoder(mcfg, torch.Generator().manual_seed(0)).to("cuda")
        bench_engine(torch, dec, 5, 4, mcfg, "off")        # warm-up
        dec = IMAPDecoder(mcfg, torch.Generator().manual_seed(0)).to("cuda")
        t_ms, m_ms, tl, ml, got = bench_engine(torch, dec, mcfg=mcfg,
                                               megakernel="off")
        runs[fused] = (tl, ml)
        for nm, ls in (("tracker", tl), ("mapper", ml)):
            if not falls(ls, 5):
                fail(f"engine plain[fused {fused}]: {nm} loss not finite or "
                     f"did not fall: {ls[:5].tolist()} -> "
                     f"{ls[-5:].tolist()}")
        want = ({"tracker": {"fused_mlp_fwd": 100, "fused_mlp_bwd": 50},
                 "mapper": {"fused_mlp_fwd": 900, "fused_mlp_bwd": 600}}
                if fused else {"tracker": {}, "mapper": {}})
        print(f"engine plain[fused {fused}]: tracker {t_ms:.2f} ms/iter "
              f"(loss {float(tl[0]):.6g} -> {float(tl[-1]):.6g}), mapper "
              f"{m_ms:.2f} ms/iter (loss {float(ml[0]):.6g} -> "
              f"{float(ml[-1]):.6g}); launches {got}", flush=True)
        if got != want:
            fail(f"engine plain[fused {fused}]: launches {got}, want {want}")
    for i, nm in enumerate(("tracker", "mapper")):
        a, b = float(runs[True][i][0]), float(runs[False][i][0])
        rel = abs(a - b) / abs(b)
        print(f"engine plain: first {nm} loss K5/K6 {a:.7g} vs float32 "
              f"{b:.7g}: relative difference {rel:.3e}", flush=True)
        if not rel <= PLAIN_FIRST_RTOL[nm]:
            fail(f"engine plain: first {nm} losses differ by {rel}")


def phase_mapper_mk(torch):
    """The mapper's two-kernel branch: 40 + 24 samples (104 points per ray
    with regulation, past fused value-and-grad's cover of 100) with
    w_beyond_loss 0 take K3 forward and K4 backward with weight gradients,
    20 iterations on the bench window; the loss falls."""
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dev = torch.device("cuda")
    d = bench_data(torch)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    mapper = make_mapper_step(MLPConfig(), RenderConfig(N_samples=40,
                                                        N_importance=24),
                              bench_ecfg(w_beyond_loss=0.0), 6)
    draws = Draws(torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    t0 = time.time()
    _, ml = mapper(dec, d["colors"][0], d["depths"][0], d["cams"][0],
                   d["valid"][0], d["ba"][0], d["bound"], draws, 20)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / 20
    print(f"mapper two-kernel: 40 + 24 samples, 20 iterations, {ms:.2f} "
          f"ms/iter, loss {float(ml[0]):.6g} -> {float(ml[-1]):.6g}",
          flush=True)
    if not falls(ml, 5):
        fail(f"mapper two-kernel: loss did not fall: {ml.tolist()}")


def mesh_distance(a, b):
    """Symmetric mean nearest-vertex distance of two vertex sets."""
    from scipy.spatial import cKDTree
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


def phase_mesh(torch, slam):
    """The sensor phase's meshes (built by the system's maybe_mesh at the
    last frame with the float32 decoder: final_mesh.ply and
    final_mesh_eval_rec.ply) read back with the port's read_ply; then the
    same mesh from a MeshSnapshot whose decoder is fused (K5: one launch
    per 500,000-point grid chunk, two per 65,536-vertex colour chunk),
    held against final_mesh.ply: vertex and triangle counts within
    MESH_COUNT_REL, symmetric mean nearest-vertex distance under half a
    voxel. Prints each build's seconds by stage."""
    import dataclasses

    import numpy as np
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.outputs.mesher import MeshSnapshot, read_ply
    mesher = slam.mesher
    mdir = os.path.join(slam.output, "mesh")
    meshes = {}
    for name in ("final_mesh.ply", "final_mesh_eval_rec.ply"):
        v, t, c = read_ply(os.path.join(mdir, name))
        if not (len(v) and len(t) and c is not None
                and np.isfinite(v).all()):
            fail(f"mesh: {name} empty or not finite ({len(v)} verts)")
        meshes[name] = (v, t)
    snap = MeshSnapshot(slam, dataclasses.replace(slam.model_cfg,
                                                  fused=True))
    k0 = F.launches["fused_mlp_fwd"]
    t0 = time.time()
    out = mesher.get_mesh(snap, os.path.join(mdir, "final_mesh_k5.ply"),
                          cur_idx=slam.n_img - 1)
    torch.cuda.synchronize()
    secs = time.time() - t0
    if out is None:
        fail("mesh: the K5 build extracted nothing")
    k5 = F.launches["fused_mlp_fwd"] - k0
    n_grid = int(np.prod([len(a) for a in mesher.get_grid_uniform()]))
    want = (-(-n_grid // mesher.points_batch_size)
            + 2 * -(-len(out[0]) // 65536))
    for b in mesher.builds:
        print(f"mesh: {os.path.basename(b['file'])}: "
              + ", ".join(f"{k} {v:.2f} s" for k, v in b["seconds"].items()),
              flush=True)
    v0, t0_ = meshes["final_mesh.ply"]
    dv = abs(len(out[0]) - len(v0)) / len(v0)
    dt = abs(len(out[1]) - len(t0_)) / len(t0_)
    dist = mesh_distance(out[0], v0)
    voxel = float(mesher.get_grid_uniform()[0][1]
                  - mesher.get_grid_uniform()[0][0])
    print(f"mesh: resolution {mesher.resolution} ({n_grid} grid points); "
          f"float32 decoder {len(v0)} verts / {len(t0_)} tris, K5 "
          f"{len(out[0])} / {len(out[1])} in {secs:.2f} s with {k5} K5 "
          f"launches (want {want}); counts differ by {dv:.2e} / {dt:.2e}; "
          f"mean nearest-vertex distance {dist:.3e} m (voxel {voxel:.4f} "
          f"m); eval mesh {len(meshes['final_mesh_eval_rec.ply'][0])} "
          f"verts", flush=True)
    if k5 != want or dv > MESH_COUNT_REL or dt > MESH_COUNT_REL \
            or not dist < 0.5 * voxel:
        fail(f"mesh: K5 launches {k5} (want {want}), counts {dv} / {dt}, "
             f"distance {dist}")


def phase_system(torch):
    """Frames 0..5 of room_bench; returns the system for the checks that
    follow."""
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.io.config import load_config
    cfg = load_config(os.path.join(HERE, "configs/Synthetic/room_bench.yaml"))
    cfg["mapping"].update(fused_outer=True, resample_every=4,
                          color_refine=False)
    cfg["tracking"]["resample_every"] = 5
    cfg["data"]["frame_cache_dir"] = ""
    print(f"system: room_bench 680x1200, frames 0..5, iters_first "
          f"{cfg['mapping']['iters_first']}, colour refine off (cut); "
          f"widths uncut", flush=True)
    from pointnerf_slam_torch.outputs import attach_outputs
    slam = PointNeRFSLAM(cfg, n_frames_cap=6, device="cuda",
                         output=os.path.join(HERE, "output", "chip_smoke",
                                             "room_bench"))
    attach_outputs(slam)
    t0 = time.time()
    slam.run(on_frame=lambda s, idx: print(
        "system: " + frame_line(s.frame_log[-1]), flush=True))
    torch.cuda.synchronize()
    secs = time.time() - t0
    first = best = 0.0
    for rec in slam.frame_log:
        idx = rec["idx"]
        if "map_losses" in rec and not falls(rec["map_losses"], 10):
            fail(f"system: mapping loss of frame {idx} not finite or did "
                 f"not fall")
        if "t_err_m" in rec:
            first += float(rec["track_first"])
            best += float(rec["track_best"])
            t_err = float(rec["t_err_m"])
            if not t_err <= CAM_T_MAX:
                fail(f"system: frame {idx} translation error {t_err} m")
    if not best < first:
        fail(f"system: tracking did not lower the summed loss ({first} -> "
             f"{best})")
    print(f"system: {slam.n_img} frames in {secs:.1f} s; summed tracking "
          f"loss {first:.2f} -> {best:.2f}", flush=True)
    return slam


def pseudo_errors(slam):
    """{frame: (pixels, median relative error)} of every pseudo-depth
    against the sensor depth the weak run never reads."""
    import numpy as np
    out = {}
    for i in sorted(slam.pseudo_depths):
        p = slam.pseudo_depths[i].cpu().numpy()
        _, _, d, _ = slam.frame_reader[i]
        m = p > 0.01
        if m.sum():
            out[i] = (int(m.sum()),
                      float(np.median(np.abs(p[m] - d[m]) / d[m])))
    return out


def run_system(torch, cfg, label, n_frames=None):
    """Run the system; print each logged frame. Returns (slam, seconds,
    {frame: launch counts after it})."""
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.ops import fused_vg as F
    slam = PointNeRFSLAM(cfg, n_frames_cap=n_frames, device="cuda")
    after = {}

    def on_frame(s, idx):
        if s.frame_log and s.frame_log[-1]["idx"] == idx:
            print(f"{label}: " + frame_line(s.frame_log[-1]), flush=True)
        after[idx] = dict(F.launches)

    t0 = time.time()
    slam.run(on_frame=on_frame)
    torch.cuda.synchronize()
    return slam, time.time() - t0, after


def check_poses(slam, label, t_max, tracked_only):
    import numpy as np
    from pointnerf_slam_torch.run import trajectory_errors
    est, gt = slam.estimate_c2w_list, slam.gt_c2w_list
    if not np.isfinite(est).all():
        fail(f"{label}: a pose is not finite")
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    idx = [r["idx"] for r in slam.frame_log if "t_err_m" in r] \
        if tracked_only else list(range(len(err)))
    worst = max(float(err[i]) for i in idx)
    te = trajectory_errors(est, gt)
    print(f"{label}: translation error max {worst * 1000:.2f} mm over "
          f"{'tracked' if tracked_only else 'all'} frames (bound "
          f"{t_max * 1000:.0f} mm); over all frames RMSE "
          f"{te['rmse'] * 1000:.2f} mm, Horn-aligned (ATE) RMSE "
          f"{te['ate_rmse'] * 1000:.2f} mm, max {te['ate_max'] * 1000:.2f} "
          f"mm", flush=True)
    if not worst <= t_max:
        fail(f"{label}: translation error {worst} m")


def phase_weak(torch):
    """The flagship weak-depth config, frames 0..20 as configured."""
    from pointnerf_slam_torch.io.config import load_config
    cfg = load_config(os.path.join(HERE,
                                   "configs/Synthetic/room_bench_weak.yaml"))
    cfg["data"]["frame_cache_dir"] = ""
    print(f"weak: room_bench_weak 680x1200, frames 0..{WEAK_FRAMES - 1}, "
          f"iters_first {cfg['mapping']['iters_first']}, colour refine on "
          f"the last frame; widths uncut", flush=True)
    slam, secs, _ = run_system(torch, cfg, "weak", WEAK_FRAMES)
    b = getattr(slam, "bootstrap_idx", None)
    if b is None or b > WEAK_BOOT_BY:
        fail(f"weak: no bootstrap by frame {WEAK_BOOT_BY} (at {b})")
    cont = [r["idx"] for r in slam.frame_log
            if "track_best" in r and r["idx"] > b]
    if not cont:
        fail("weak: no continuous tracked frame after the bootstrap")
    errs = pseudo_errors(slam)
    print(f"weak: bootstrap at frame {b}; continuous tracked frames {cont}; "
          f"pseudo-depth (pixels, median rel err) {errs}", flush=True)
    for i, (n, r) in errs.items():
        if not r < PSEUDO_REL:
            fail(f"weak: pseudo-depth of frame {i} median rel err {r}")
    for rec in slam.frame_log:
        if "map_losses" in rec and not falls(rec["map_losses"], 10):
            fail(f"weak: mapping loss of frame {rec['idx']} did not fall")
    check_poses(slam, "weak", WEAK_T_MAX, tracked_only=True)
    t = slam.timings
    print(f"weak: {slam.n_img} frames in {secs:.1f} s: front-end "
          f"{t['frontend']:.1f} s, tracking {t['tracking']:.1f} s, mapping "
          f"{t['mapping']:.1f} s", flush=True)


def phase_dynamic(torch):
    """box_ba_dynamic, all 40 frames: handle_dynamic tracking on K3/K4 and
    bundle adjustment (K1 with ray gradients) once > 4 keyframes. Counts
    the K1 mapper launches of the frames the system logged as bundle-
    adjusting (frame_log "ba"). Returns the system."""
    from pointnerf_slam_torch.io.config import load_config
    cfg = load_config(os.path.join(
        HERE, "configs/Synthetic/ablations/box_ba_dynamic.yaml"))
    cfg["data"]["frame_cache_dir"] = ""
    slam, secs, after = run_system(torch, cfg, "dynamic")
    ba, prev = 0, 0
    logged = {r["idx"]: r for r in slam.frame_log}
    for idx in sorted(after):
        now = after[idx]["fused_vg_mapper"]
        if logged.get(idx, {}).get("ba", False):
            ba += now - prev
        prev = now
    first = sum(float(r["track_first"]) for r in slam.frame_log
                if "track_first" in r)
    best = sum(float(r["track_best"]) for r in slam.frame_log
               if "track_best" in r)
    print(f"dynamic: {slam.n_img} frames in {secs:.1f} s; bundle-adjusting "
          f"mapper launches {ba} (frames "
          f"{[i for i, r in logged.items() if r.get('ba')]}); summed "
          f"tracking loss {first:.2f} -> {best:.2f}", flush=True)
    if ba <= 0:
        fail("dynamic: the mapper never ran with ray gradients (BA)")
    if not best < first:
        fail("dynamic: tracking did not lower the summed loss")
    check_poses(slam, "dynamic", DYN_T_MAX, tracked_only=False)
    return slam


def frame_line(rec) -> str:
    """One frame's record: host seconds per phase (card seconds between
    the phase's events beside them), tracking, camera and mapping."""
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    line = [f"frame {rec['idx']}"]
    dev = PointNeRFSLAM.device_seconds(rec)
    secs = [f"{k} {rec[k + '_s']:.2f} s (card {dev[k]:.2f} s)" for k in
            ("frontend", "tracking", "mapping") if k + "_s" in rec]
    if secs:
        line.append(", ".join(secs))
    if "t_err_m" in rec:
        line.append(f"track {float(rec['track_first']):.2f} -> "
                    f"{float(rec['track_best']):.2f}, cam err "
                    f"{float(rec['cam_err']):.5f}, t err "
                    f"{float(rec['t_err_m']) * 1000:.2f} mm")
    if "map_losses" in rec:
        ls = rec["map_losses"]
        line.append(f"map {ls.numel()} iterations, first 10 "
                    f"{float(ls[:10].mean()):.2f} -> last 10 "
                    f"{float(ls[-10:].mean()):.2f}")
    return ", ".join(line)


def phase_track_check(torch, slam):
    """The tracker on frame 0 of the map, started 2 cm off along +y, must
    come back within 2 mm (a tracker that does nothing stays 20 mm off)."""
    import numpy as np
    from pointnerf_slam_torch.engine.state import Draws
    _, color, depth, gt0 = slam.frame_reader[0]
    c, d, _ = slam._upload_frame(0, color, depth)
    start = np.asarray(gt0, np.float64).copy()
    start[1, 3] += SHIFT_M
    draws = Draws(torch.Generator(device=slam.device).manual_seed(7))
    best, bl, fl, _ = slam.tracking_step(slam.decoder, slam._cam7(start), c,
                                         d, slam.bound, draws)
    err = float(torch.linalg.norm(best[4:] - slam._cam7(gt0)[4:]))
    print(f"track check: frame 0 from +{SHIFT_M * 100:.0f} cm: loss "
          f"{float(fl):.2f} -> {float(bl):.2f}, t err {SHIFT_M * 1000:.1f} "
          f"-> {err * 1000:.3f} mm", flush=True)
    if not err <= SHIFT_BACK_M:
        fail(f"track check: t err {err} m after tracking from a "
             f"{SHIFT_M} m shift")


def frame_rays(torch, slam, idx, n, gen):
    """n pixels of frame idx, drawn as the tracker draws them (in weak
    mode among the pixels of the supervising pseudo-depth > 0.01, which is
    then gt_d), and their rays at the frame's estimated pose."""
    from pointnerf_slam_torch.core.rays import (gather_pixels, rays_from_uv,
                                                sample_uv_uniform,
                                                sample_uv_valid)
    from pointnerf_slam_torch.core.se3 import camera_from_tensor
    e = slam.ecfg
    _, color, depth, _ = slam.frame_reader[idx]
    c, d, _ = slam._upload_frame(idx, color, depth)
    if e.weak_depth:
        d = slam._supervising_depth(idx, d)
        flat = sample_uv_valid(gen, d > 0.01, n)[0]
    else:
        flat = sample_uv_uniform(gen, e.W, e.ignore_edge_H,
                                 e.H - e.ignore_edge_H, e.ignore_edge_W,
                                 e.W - e.ignore_edge_W, n)
    i, j, gt_d, gt_c = gather_pixels(flat, e.W, d, c)
    cam = slam._cam7(slam.estimate_c2w_list[idx])
    ro, rd = rays_from_uv(i, j, camera_from_tensor(cam), e.fx, e.fy, e.cx,
                          e.cy)
    return ro.contiguous(), rd.contiguous(), gt_d, gt_c


def phase_kernels_map(torch, slam, report):
    """The kernels against their plain versions on the decoder the system
    phase mapped, with rays of the run's frames: the tracker's 5000 of the
    last frame at its estimated pose, the mapper's 4998 from frames 0 and
    5 (its window there) with ray_w 3 (6 slots / 2 valid frames). Same
    tolerances as the random cell; here the tracker's loss has its real
    scale (no decoder-wide var ~ 0)."""
    from pointnerf_slam_torch.ops import fused_vg as F
    dev = slam.device
    gen = torch.Generator(device=dev).manual_seed(3)
    dec, bound = slam.decoder, slam.bound
    last = slam.n_img - 1
    pw = F.pack_weights(F.params_of(dec))
    ro, rd, gt_d, _ = frame_rays(torch, slam, last, 4998, gen)
    p1_err = check_p1(torch, F, pw, F._pack_rays(ro, rd, gt_d, bound), bound,
                      "map")
    report["p1_sigma"]["max_abs_err"] = max(
        report["p1_sigma"]["max_abs_err"], p1_err)
    for name, mode, kw, on_path in VG_VARIANTS:
        if mode == "tracker":
            ro, rd, gt_d, gt_c = frame_rays(torch, slam, last, 5000, gen)
            ray_w = torch.ones_like(gt_d)
        else:
            parts = [frame_rays(torch, slam, f, 2499, gen) for f in (0, last)]
            ro, rd, gt_d, gt_c = (torch.cat(t) for t in zip(*parts))
            ray_w = torch.full_like(gt_d, 3.0)
        t_reg = torch.rand(gt_d.shape[0], 32, generator=gen, device=dev)
        _, _, err = run_vg(torch, "map", dec, name, mode, kw,
                           (ro, rd, gt_d, gt_c, ray_w, t_reg, bound),
                           2 * p1_err)
        if on_path:
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              err)

    def rays_of(n):
        return frame_rays(torch, slam, last, n, gen)[:3]

    phase_kernels_mk(torch, report, dec, "map", rays_of, bound, 2 * p1_err)
    phase_kernels_mlp(torch, report, dec, "map",
                      lambda n: frame_rays(torch, slam, last, n, gen), bound)


def phase_kernels_dynamic(torch, slam, report):
    """K2, K3 and K4 against their plain versions on the decoder the
    dynamic phase mapped, at its tracker's shape: tracking.pixels (1500)
    rays of its last tracked frame as the tracker draws them (pseudo-depth
    pixels, estimated pose), N_samples + N_importance (24 + 8), no
    regulation; same tolerances as the other cells."""
    from pointnerf_slam_torch.ops import fused_vg as F
    e, r = slam.ecfg, slam.rcfg
    gen = torch.Generator(device=slam.device).manual_seed(9)
    last = max(rec["idx"] for rec in slam.frame_log if "track_best" in rec)
    ro, rd, gt_d, _ = frame_rays(torch, slam, last, e.tracking_pixels, gen)
    pw = F.pack_weights(F.params_of(slam.decoder))
    p1_err = check_p1(torch, F, pw, F._pack_rays(ro, rd, gt_d, slam.bound),
                      slam.bound, "dynamic", r.N_samples)
    report["p1_sigma"]["max_abs_err"] = max(
        report["p1_sigma"]["max_abs_err"], p1_err)
    _, err, gerr = check_render(
        torch, "dynamic", slam.decoder, ro, rd, gt_d,
        torch.zeros(ro.shape[0], r.N_samples, device=slam.device),
        slam.bound, False, 2 * p1_err, S1=r.N_samples, SI=r.N_importance)
    for k, v in (("megakernel_fwd", err), ("megakernel_bwd", gerr)):
        report[k]["max_abs_err"] = max(report[k]["max_abs_err"], v)


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pointnerf_slam_torch")):
        print("chip_smoke: pointnerf_slam_torch/ not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pointnerf_slam_torch.ops import build
    from pointnerf_slam_torch.ops import fused_vg as F
    t0 = time.time()
    logs = build.build_all(force=True)
    secs = time.time() - t0
    print(f"build: {len(logs)} kernels in {secs:.1f} s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"build: {name}: {ln.strip()}")
    sass = sass_summary(build, logs)
    print(f"build: HGMMA instructions per library (cuobjdump -sass): "
          f"{ {k: v[0] for k, v in sass.items()} }", flush=True)
    for name in ("fused_vg", "p1_sigma", "megakernel"):
        if not sass[name][0]:
            fail(f"build: {name} has no HGMMA (wgmma) instruction")
    for name in ("fused_vg", "megakernel"):
        wmma = [f for f in sass[name][1] if any(k in f for k in WMMA_KERNELS)]
        print(f"build: {name}: {len(sass[name][1])} kernels, WMMA kernels "
              f"among them: {wmma}", flush=True)
        if wmma:
            fail(f"build: {name} holds WMMA kernels {wmma}")
    spills = {k: spilled(v) for k, v in logs.items() if spilled(v)}
    if spills:
        fail(f"build: ptxas reports spilled bytes: {spills}")
    report = {}
    phase_kernels(torch, report)
    # each path from counts of 0, read right after it; the kernels each
    # path must launch
    counts = {k: 0 for k in F.launches}
    by_path = {k: {} for k in F.launches}
    k1 = ("p1_sigma", "fused_vg_mapper", "fused_vg_tracker")
    mk = ("megakernel_fwd", "megakernel_bwd")
    paths = (("sensor", lambda: (phase_engine(torch), phase_system(torch))[1],
              k1),
             ("dynamic tracker", lambda: phase_engine_dynamic(torch), mk),
             ("mesh", lambda: phase_mesh(torch, slam), ("fused_mlp_fwd",)),
             ("plain", lambda: phase_engine_plain(torch),
              ("fused_mlp_fwd", "fused_mlp_bwd")),
             ("mapper two-kernel", lambda: phase_mapper_mk(torch), mk),
             ("weak", lambda: phase_weak(torch), k1),
             ("dynamic", lambda: phase_dynamic(torch),
              ("p1_sigma", "fused_vg_mapper") + mk))
    for label, run, must in paths:
        F.reset_launches()
        out = run()
        got = dict(F.launches)
        print(f"launches on the {label} path: {got}", flush=True)
        for k in must:
            if got[k] <= 0:
                fail(f"kernel {k} never launched on the {label} path")
        for k in counts:
            counts[k] += got[k]
            if got[k]:
                by_path[k][label] = got[k]
        if label == "sensor":
            slam = out
        elif label == "dynamic":
            dyn = out
    print(f"launches on the main paths: {counts}")
    for k, c in counts.items():
        if c <= 0:
            fail(f"kernel {k} never launched on the main path")
    phase_track_check(torch, slam)
    phase_kernels_map(torch, slam, report)
    phase_kernels_dynamic(torch, dyn, report)
    print(json.dumps({"kernels": [dict(name=k, launches=counts[k],
                                       launches_by_path=by_path[k], **v)
                                  for k, v in report.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
