#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: needs CUDA; prints `nvidia-smi --query-gpu=name,power.limit`
  2. build: compiles every kernel from pointnerf_slam_torch/ops/csrc with
     nvcc for sm_90a, one process per source, all started together;
     prints the seconds, ptxas' register and spill lines, each library's
     kernels and its counts of HGMMA (wgmma) and HMMA (mma.sync, what WMMA
     compiles to) instructions (cuobjdump -sass); fails if a library has
     no HGMMA, if ptxas reports a spilled byte in any kernel of the four
     libraries, if a library holds a WMMA kernel (HMMA instructions, or
     one of the retired WMMA tile's kernels: vg_forward, vg_chain,
     vg_wgrad, p1_kernel, mlp_points), or if p1_sigma holds the
     backward's wgrad_kernel (K2 builds the forward tile alone)
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
                         and the loss's own cotangent); yardsticks timed
                         beside them: the decoder as five bf16
                         torch.matmul calls (K5), and K6's eight products
                         (the chain's four, the weight gradients' four)
  4. engine: the bench workload (680x1200, 6-frame window) through the
     port's tracker (50 iterations, K=5) and fused-outer mapper (3 x 100,
     K=4, no BA); ms per iteration; losses finite and falling
  4b. bench: `python3 bench_torch.py` (bench.py's workload and line) as a
     subprocess: its last line holds exactly bench.py's keys, its metric
     name and unit, a finite value > 0 and vs_baseline = round(value /
     BASELINE_FPS, 2); then the workload in this process from the initial
     decoder, 3 cycles synced between the tracker and the mapper (ms per
     iteration of each) and 3 as the bench times them: the cycle's wall
     against 50 t_track + 300 t_map and the unsplit remainder; every
     cycle launches K2 85 times (10 tracker + 75 mapper pixel batches), K1
     mapper 300 and K1 tracker 50
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
     last frame), with outputs.attach_outputs (checkpoints, meshes and,
     at vis_freq 5 for this run only, the five writers' folders under
     output/chip_smoke/room_bench_weak): the sparse front-end
     bootstraps by frame 15 (its 2 deg parallax gate needs ~15 frames of
     this orbit), continuous tracked frames follow, pseudo-depth agrees
     with the sensor depth the run never sees, mapping losses fall, poses
     stay finite and near gt
  9b. resume: a fresh card system restored (outputs/logger.resume_slam)
     from the weak run's pre-bank checkpoint 00019.npz (written before
     frame 20's mapping): logged again at 19 it gives the file's arrays
     bit for bit; it runs frame 20 (tracked, mapped with the colour
     refine: K1 mapper and tracker, K2, counted from 0) within WEAK_T_MAX
     of gt, and prints its distance from the uninterrupted frame-20 pose
 10. system, dynamic: configs/Synthetic/ablations/box_ba_dynamic.yaml, all
     40 frames (weak depth, handle_dynamic, BA): the tracker runs K3/K4,
     the mapper K1 with ray gradients (BA); tracking lowers the summed loss
 10b. superpoint: the distilled checkpoint
     (pretrained/superpoint_synthetic.npz) in the SuperPoint extractor on
     the card against its float32 run on the CPU on frame 0 of the
     flagship (heatmap, descriptors, keypoints on the same pixel, angles;
     ms per frame, CUDA-event median of 10); then room_bench_weak.yaml's
     bootstrap decisions with superpoint_weights naming it, frames 5, 10,
     15 and 20 against frame 0 (refused and why, or bootstrapped and the
     pose's t err): with the RANSAC hypotheses drawn from the CPU test's
     generator they equal SP_DECISIONS, the CPU test's pin for both
     packages; with the card's own generator at each of SP_SEEDS every
     bootstrap lands within SP_BOOT_T_MAX of gt (the share that
     bootstraps is printed); then the 21 frames through the system with
     the card's own generator (seed 7, a user's run): it bootstraps where
     the probe's seed 7 did, and after a bootstrap the pose
     (SP_BOOT_T_MAX), the tracked frames (WEAK_T_MAX) and the mapping
     losses are held, and K1/K2 must launch (without one, none may)
 10c. readers: frames 0-5 of the synthetic room rendered at
     configs/TUM_RGBD/tum_imap.yaml's camera (480x640) and written in the
     TUM layout with cv2; the port's TUM reader gives them back to their
     u8 / u16 quantisation with frame 0's pose the identity (through the
     y/z flip); then tum_imap.yaml's published budgets on them through
     the system (only data.input_folder, data.output and the room bound
     rebased into the reader's frame overridden): t err of frames 1-5
     within CAM_T_MAX, then the tracker pulls frame 0 back from a 2 cm
     shift on the map they built (as phase 12 does on room_bench's), K1/K2
     launches exactly tum_schedule's, ms per tracker and mapper iteration
 10d. outputs: the weak run's mapping_vis, tracking_vis, matches_vis,
     traj_vis and loss_vis folders hold files that decode; render_img at
     680x1200 on its map at frame 20's pose, with the sensor depth as the
     prior (as the panels render), within RENDER_REL of the sensor depth
     on the median ray, and without a prior the same in chunks of 16384
     and 65536 rays; ms per full-frame render. No kernel launches.
 10e. NICE: room_bench.yaml with configs/nice_slam.yaml's keys overlaid
     in code, full width (32-wide decoders, c_dim 32, grids up to 28^3 x
     32), frames 0..10 with the outputs attached: the middle, fine and
     colour grids move, losses finite, tracked frames within CAM_T_MAX,
     the final mesh has faces, the NICE tracker (20 calls of its 200 rays
     x 10 iterations) from frame 0 shifted 2 cm closes half the gap
     between the start's and gt's loss (its own loss, on a fixed pixel
     batch); then a static-camera variant (gt
     poses, no BA, frames 0..5): cells outside frame 0's frustum bit for
     bit unmoved; ms per tracker and per mapper iteration by stage. No
     kernel launches (the reference keeps NICE off the kernels).
 10f. parallel (engine/mapper.py `group`, parallel/): rank processes
     (`python -c "import chip_smoke; chip_smoke.parallel_rank()"`,
     joined through a file:// store, logs and JSON results under
     output/chip_smoke/parallel, all stopped on a failure or after
     PAR_TIMEOUT): (1) a one-rank NCCL group runs the weak flagship's
     full-width mapper (680x1200 pseudo-depth window of 6 frames, 5000
     pixels, 3 outers at K=4) bit for bit as no group does, and one NCCL
     all_reduce leaves its tensor unchanged; (2) two gloo ranks on the
     one card (NCCL refuses two ranks on one card), 2496 rays each: one
     iteration's summed K1 gradients within PAR_GRAD x max|g| of one
     process's K1 on the union of their pixels (every rank's draw holds
     the window's deepest pixel: the far clip reads each rank's own max
     depth, as the reference's shard_map does), the decoders bit-equal
     after it and after 3 x 100 iterations, whose losses fall; (3) both
     ranks run room_bench.yaml frames 0..5 through PointNeRFSLAM, each
     with outputs.attach_outputs into its own directory (writers at
     OUT_VIS_FREQ): rank 0 alone writes checkpoints, the mesh and the
     panels, decoders, trajectories and keyframe cameras stay
     bit-equal, tracked frames
     within CAM_T_MAX, mapping losses fall, K1/K2 launched in both ranks
     in (2) and in (3); (4) ms per mapper iteration at 1 rank and at 2
     ranks sharing the card (the collective's cost, not scaling). The
     ranks' launch counts of the runs through a group ((1)'s group run
     and timed run, (2)'s 3 x 100, (3)) come back in their JSON and are
     summed into the path's row; the comparisons against no group are
     not counted.
 11. the launch counts of phases 4-10f, each path counted from 0 (every
     kernel must have launched on the main paths; K1/K2 on the sensor,
     bench, weak, resume, readers and parallel paths; K3/K4 on the
     handle_dynamic tracker, mapper two-kernel and dynamic paths)
 11a. run.py: python -m pointnerf_slam_torch.run on the readers phase's
     TUM fixture (a generated config inheriting tum_imap.yaml with its
     bound, 15 mapping and 10 tracking iterations) with --input_folder,
     --n_frames 3 and --profile: exit 0, a Chrome trace and the
     program's spans written (its kernel launches are the subprocess's,
     not counted)
 11b. tools: the port's eval_ate on the weak run's last checkpoint (its
     Horn RMSE equals run.trajectory_errors' of the run's poses to 1e-9
     m), and cull_mesh and eval_recon's 3D metrics of phase 5's final
     mesh against a resolution-128 ground-truth mesh (printed, no bound)
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
import shutil
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
WEAK_OUT = os.path.join(HERE, "output", "chip_smoke", "room_bench_weak")
# resume: the weak run's pre-bank checkpoint before its last mapped frame
# (mapping every 5th frame, bootstrap at 15)
RESUME_FROM = WEAK_FRAMES - 2
ATE_TOL = 1e-9              # tools: eval_ate vs trajectory_errors, metres
GT_RES = 128                # tools: ground-truth mesh resolution
DYN_T_MAX = 1.0             # dynamic: max translation error, any frame
SP_NPZ = os.path.join(HERE, "pretrained", "superpoint_synthetic.npz")
# superpoint: the flagship's front-end decision at each tracked frame
# before a bootstrap with the distilled checkpoint, as the CPU test pins
# for both packages (tests/test_torch_superpoint.py)
SP_DECISIONS = {5: "refused", 10: "refused", 15: "refused", 20: "refused"}
SP_HEAT = 1e-4              # superpoint: card vs CPU heatmap max abs
SP_DESC = 1e-4              # superpoint: coarse descriptors max abs
SP_SHARE = 0.98             # superpoint: keypoints on the same pixel, angles
SP_ANGLE = 1e-4             # superpoint: angle agreement, radians
# superpoint: seeds of the card's own RANSAC generator whose bootstrap
# decisions are probed (7, the front-end's default, first), and the bound
# on a bootstrap's translation error: the reference's own SuperPoint
# bootstraps read up to 64 mm over 40 seeds (PERF.md, PR 8), and the
# camera has moved 127 mm by frame 15, so a bootstrap that leaves it at
# frame 0 fails
SP_SEEDS = (7, 0, 1, 2, 3, 4)
SP_BOOT_T_MAX = 0.10
TUM_CFG = "configs/TUM_RGBD/tum_imap.yaml"
TUM_FRAMES = 6              # readers: frames of the TUM fixture
OUT_VIS_FREQ = 5            # outputs: the weak run's writer cadence
OUT_DIRS = ("mapping_vis", "tracking_vis", "matches_vis", "traj_vis",
            "loss_vis")
RENDER_REL = 0.15           # outputs: median rel. error of render_img depth
CHUNK_SHARE, CHUNK_ABS = 0.99, 1e-2   # outputs: chunk invariance
NICE_FRAMES = 11            # nice: frames 0..10 at full width
NICE_STATIC_FRAMES = 6      # nice: static-camera variant (maps 0 and 5)
NICE_ITERS = 10             # nice: iterations per timed stage
RUNPY_FRAMES = 3            # run.py: --n_frames
RUNPY_TIMEOUT = 300         # run.py: seconds for the subprocess
PAR_RANKS = 2               # parallel: gloo ranks on the one card
PAR_GRAD = 1e-4             # parallel: summed K1 gradients vs the union's,
#                             x max|g| per tensor (float32 sum order)
PAR_CHECK_ITERS = 20        # parallel: iterations per outer of the NCCL
#                             bit-equality check (3 outers)
PAR_ITERS = 100             # parallel: iterations per outer, 3 outers
PAR_FRAMES = 6              # parallel: room_bench frames 0..5
PAR_TIMEOUT = 300           # parallel: seconds for a phase's ranks
SHIFTED_CAM0 = (1.0, 0.0, 0.0, 0.0, 0.02, 0.0, 2.5)   # engine: tracker start
BENCH_TIMEOUT = 300         # bench: seconds for python3 bench_torch.py
# bench: launches per cycle from the schedule: K2 once per pixel batch
# (50 / 5 tracker + 3 x 100 / 4 mapper), K1 once per iteration
BENCH_LAUNCHES = {"p1_sigma": 85, "fused_vg_mapper": 300,
                  "fused_vg_tracker": 50}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


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


# kernels of the retired WMMA tile, which no library may hold
WMMA_KERNELS = ("vg_forward", "vg_chain", "vg_wgrad", "p1_kernel",
                "mlp_points")


def sass_summary(build, names) -> dict:
    """{library: (count of HGMMA (wgmma) instructions in its SASS, count of
    HMMA (mma.sync, what WMMA compiles to) instructions, names of its
    kernels)} from cuobjdump -sass."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", build._lib_path(name)],
                              capture_output=True, text=True,
                              timeout=300).stdout.splitlines()
        out[name] = (sum("HGMMA" in ln for ln in sass),
                     sum(bool(re.search(r"\bHMMA\b", ln)) for ln in sass),
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
    two yardsticks are timed: the decoder as five bf16 torch.matmul calls
    at K5's shapes, and bf16 torch.matmul calls at K6's product shapes
    (the chain's three N x 256 x 256 and one N x 256 x 93, the weight
    gradients' four: N-deep 93 x 256 and three 256 x 256), alone and
    after the five of the forward K6 recomputes. No single PyTorch call
    computes either function, so library_ms stays null and the yardsticks
    go under yardstick_ms."""
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
    d6 = torch.randn(n6, 256, generator=gen, device=dev).to(torch.bfloat16)

    def five_matmuls(a):
        h = a
        for w in ws:
            h = torch.matmul(h, w)
        return h

    def eight_matmuls():
        for w in ws[3:0:-1]:
            torch.matmul(d6, w.t())
        torch.matmul(d6, ws[0].t())
        torch.matmul(a0[:n6].t(), d6)
        for _ in range(3):
            torch.matmul(d6.t(), d6)

    mm = timed(lambda: five_matmuls(a0))
    mm6 = timed(eight_matmuls)
    mm6f = timed(lambda: (five_matmuls(a0[:n6]), eight_matmuls()))
    b5, by5 = bound_ms(n5 * FLOP_FWD, n5 * 28 + nw)
    b6, by6 = bound_ms(n6 * FLOP_FWD * 3, n6 * 40 + nw + F.GRAD_LEN * 4)
    print(f"kernels: K5 {ms5:.3f} ms at {n5} points (plain {pms5:.3f} ms, "
          f"bound {b5:.4f} ms by {by5}; five bf16 torch.matmul calls at "
          f"the same shapes {mm:.3f} ms), {ms5m:.3f} ms at the mapper's "
          f"{x_all.shape[0]}; K6 {ms6:.3f} ms at {n6} points with weight "
          f"gradients (plain {pms6:.3f} ms, bound {b6:.4f} ms by {by6}; "
          f"its eight bf16 torch.matmul products {mm6:.3f} ms, "
          f"{mm6f:.3f} ms after the forward's five), {ms6t:.3f} ms dx only",
          flush=True)
    src = "pointnerf_slam_torch/ops/csrc/fused_mlp.cu"
    rows[0].update(route="cuda", source=src,
                   replaces="pointnerf_slam_tpu/ops/fused_mlp.py:104",
                   ms=ms5, plain_ms=pms5, bound_ms=b5, bound_by=by5,
                   library_ms=None, yardstick_ms=mm, bound_share=b5 / ms5)
    rows[1].update(route="cuda", source=src,
                   replaces="pointnerf_slam_tpu/ops/fused_mlp.py:116",
                   ms=ms6, plain_ms=pms6, bound_ms=b6, bound_by=by6,
                   library_ms=None, yardstick_ms=mm6, bound_share=b6 / ms6)



def bench_data(torch):
    """The bench workload's inputs on the card (bench_torch.make_inputs):
    a random 680x1200 frame, its 6-slot window (3 outers), cameras, masks
    and the AABB, with the tracker starting SHIFTED_CAM0, 2 cm off the
    window's camera (the smoke's "loss falls" checks need a gap to close;
    bench_torch.py, as bench.py, starts the tracker on that camera)."""
    import bench_torch
    return bench_torch.make_inputs(torch.device("cuda"), cam0=SHIFTED_CAM0)


def bench_ecfg(**over):
    """bench_torch's EngineConfig with the smoke's w_beyond_loss 1.0 (the
    flagship's; bench_torch.py keeps bench.py's 0.0), then `over`."""
    import bench_torch
    return bench_torch.engine_config(**{"w_beyond_loss": 1.0, **over})


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
    torch.cuda.synchronize()
    l0 = dict(F.launches)
    t0 = time.time()
    _, _, _, tl = track(dec, d["cam0"], d["color"], d["depth"], d["bound"],
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


def phase_bench(torch):
    """bench_torch.py, the port's bench.py: run as a user runs it (a
    subprocess), its last line parsed and checked; then its workload in
    this process, cycle by cycle from the initial decoder: 3 cycles with a
    sync between the tracker and the mapper (ms per iteration of each), 3
    cycles as the bench times them (wall, ending in the host read of the
    last loss), so the wall stands against 50 t_track + 300 t_map and the
    unsplit remainder (all after one warm-up cycle, as the bench's); the
    kernels' launches of every cycle equal BENCH_LAUNCHES. Returns the
    numbers printed."""
    import math
    import bench_torch as B
    from pointnerf_slam_torch.models.decoders import IMAPDecoder
    from pointnerf_slam_torch.ops import fused_vg as F
    t0 = time.time()
    res = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "bench_torch.py")],
                         cwd=HERE, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    sub_s = time.time() - t0
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        fail(f"bench: bench_torch.py exited {res.returncode}: "
             f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    try:
        line = json.loads(lines[-1])
    except json.JSONDecodeError:
        fail(f"bench: last line is not JSON: {lines[-1]!r}")
    value = line.get("value")
    ok = (set(line) == {"metric", "value", "unit", "vs_baseline"}
          and line["metric"] == B.METRIC and line["unit"] == "frames/s"
          and isinstance(value, (int, float)) and math.isfinite(value)
          and value > 0
          and line["vs_baseline"] == round(value / B.BASELINE_FPS, 2))
    print(f"bench: python3 bench_torch.py in {sub_s:.1f} s: {lines[-1]} "
          f"(BASELINE_FPS {B.BASELINE_FPS:.6f})", flush=True)
    if not ok:
        fail(f"bench: bad result line {lines[-1]!r}")

    dev = torch.device("cuda")
    mcfg = B.model_config()
    track, mapper = B.make_steps(mcfg, B.render_config(), B.engine_config())
    d = B.make_inputs(dev)
    dec = IMAPDecoder(mcfg, torch.Generator().manual_seed(0)).to(dev)
    initial = {k: v.clone() for k, v in dec.state_dict().items()}
    n_map = B.N_OUTER * B.MAP_INNER
    split, walls, per_cycle = [], [], []

    def launched(l0):
        return {k: F.launches[k] - l0[k] for k in l0
                if F.launches[k] != l0[k]}

    l0 = dict(F.launches)
    float(B.one_cycle(track, mapper, dec, d, B.draws_for(dev, 2))[2][-1])
    per_cycle.append(launched(l0))                      # the warm-up
    for mode in ("split", "whole"):
        dec.load_state_dict(initial)
        for i in range(B.N_CYCLES):
            draws = B.draws_for(dev, 3 + i)
            torch.cuda.synchronize()
            l0 = dict(F.launches)
            t0 = time.perf_counter()
            if mode == "split":
                _, _, _, tl = track(dec, d["cam0"], d["color"], d["depth"],
                                    d["bound"], draws)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, ml = mapper(dec, d["colors"], d["depths"], d["cams"],
                               d["valid"], d["ba"], d["bound"], draws,
                               B.MAP_INNER)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                split.append(((t1 - t0) * 1e3 / B.TRACK_ITERS,
                              (t2 - t1) * 1e3 / n_map))
            else:
                _, tl, ml = B.one_cycle(track, mapper, dec, d, draws)
                float(ml[-1])                   # the bench's sync point
                walls.append((time.perf_counter() - t0) * 1e3)
            if not (bool(torch.isfinite(tl).all())
                    and bool(torch.isfinite(ml).all())):
                fail(f"bench: {mode} cycle {i}: losses not finite")
            per_cycle.append(launched(l0))
    bad = [c for c in per_cycle if c != BENCH_LAUNCHES]
    if bad:
        fail(f"bench: launches per cycle {bad}, the schedule gives "
             f"{BENCH_LAUNCHES}")
    t_track = sum(t for t, _ in split) / len(split)
    t_map = sum(m for _, m in split) / len(split)
    wall = sum(walls) / len(walls)
    parts = B.TRACK_ITERS * t_track + n_map * t_map
    split_ms = [tuple(round(x, 4) for x in c) for c in split]
    walls_ms = [round(w, 2) for w in walls]
    print(f"bench: in process, {B.N_CYCLES} cycles each way: tracker "
          f"{t_track:.4f} ms/iter, mapper {t_map:.4f} ms/iter (cycles "
          f"synced between the two: {split_ms}); cycle wall {wall:.2f} ms "
          f"({walls_ms}, "
          f"{B.FRAMES_PER_CYCLE * 1e3 / wall:.4f} frames/s) against "
          f"{B.TRACK_ITERS} t_track + {n_map} t_map = {parts:.2f} ms, "
          f"unsplit remainder {wall - parts:.2f} ms "
          f"({100 * (wall - parts) / wall:.2f}%); launches per cycle "
          f"{per_cycle[0]} (all {len(per_cycle)} cycles, the warm-up's "
          f"too, equal the schedule)",
          flush=True)
    return {"value": value, "t_track": t_track, "t_map": t_map,
            "wall": wall, "remainder": wall - parts}


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
    from pointnerf_slam_torch.run import frame_line
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


def run_system(torch, cfg, label, n_frames=None, output=None,
               grids0=None):
    """Run the system (with outputs.attach_outputs into `output` when
    given); print each logged frame. With a dict `grids0`, fill it with
    copies of a NICE system's grids as the run starts. Returns (slam,
    seconds, {frame: launch counts after it})."""
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.run import frame_line
    slam = PointNeRFSLAM(cfg, n_frames_cap=n_frames, device="cuda",
                         output=output)
    if grids0 is not None:
        grids0.update({k: v.clone() for k, v in slam.c_grid.items()})
    if output is not None:
        from pointnerf_slam_torch.outputs import attach_outputs
        shutil.rmtree(output, ignore_errors=True)
        attach_outputs(slam)
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


def weak_config():
    from pointnerf_slam_torch.io.config import load_config
    cfg = load_config(os.path.join(HERE,
                                   "configs/Synthetic/room_bench_weak.yaml"))
    cfg["data"]["frame_cache_dir"] = ""
    return cfg


def phase_weak(torch):
    """The flagship weak-depth config, frames 0..20 as configured, with
    the run's outputs attached (checkpoints, meshes). Returns the
    system."""
    cfg = weak_config()
    # the writers' cadence for this run only: phase_outputs reads their
    # files (the panels render after the step and change no state)
    cfg["mapping"]["vis_freq"] = cfg["tracking"]["vis_freq"] = OUT_VIS_FREQ
    print(f"weak: room_bench_weak 680x1200, frames 0..{WEAK_FRAMES - 1}, "
          f"iters_first {cfg['mapping']['iters_first']}, colour refine on "
          f"the last frame, checkpoints every {cfg['mapping']['ckpt_freq']} "
          f"mapped frames, writers every {OUT_VIS_FREQ} frames; widths "
          f"uncut", flush=True)
    slam, secs, _ = run_system(torch, cfg, "weak", WEAK_FRAMES,
                               output=WEAK_OUT)
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
          f"{t['mapping']:.1f} s; checkpoints "
          f"{sorted(os.listdir(os.path.join(WEAK_OUT, 'ckpts')))}",
          flush=True)
    return slam


def npz_differences(a: str, b: str) -> list:
    """Keys whose arrays differ (dtype, shape or any bit) between two
    checkpoints, and keys only one of them holds."""
    import numpy as np
    za, zb = np.load(a), np.load(b)
    diff = sorted(set(za.files) ^ set(zb.files))
    for k in sorted(set(za.files) & set(zb.files)):
        x, y = za[k], zb[k]
        if x.dtype != y.dtype or x.shape != y.shape \
                or x.tobytes() != y.tobytes():
            diff.append(k)
    return diff


def phase_resume(torch, weak):
    """A fresh card system resumed from the weak run's pre-bank checkpoint
    of frame RESUME_FROM (written before frame RESUME_FROM + 1's mapping,
    after the bootstrap): logging it again gives the file bit for bit;
    it then runs the last frame (tracked, mapped with the colour refine),
    which must land within WEAK_T_MAX of gt. Returns the system."""
    import numpy as np
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.outputs import attach_outputs
    from pointnerf_slam_torch.outputs.logger import Logger, resume_slam
    from pointnerf_slam_torch.run import frame_line
    ckpt = os.path.join(WEAK_OUT, "ckpts", f"{RESUME_FROM:05d}.npz")
    if not os.path.exists(ckpt):
        fail(f"resume: the weak run wrote no {ckpt}")
    out = os.path.join(HERE, "output", "chip_smoke", "room_bench_weak_resumed")
    shutil.rmtree(out, ignore_errors=True)
    slam = PointNeRFSLAM(weak_config(), n_frames_cap=WEAK_FRAMES,
                         device="cuda", output=out)
    attach_outputs(slam)
    t0 = time.time()
    start = resume_slam(slam, ckpt)
    t_resume = time.time() - t0
    relog = Logger(os.path.join(out, "relog"), 1, slam.n_img)
    relog.log(slam, RESUME_FROM)
    diff = npz_differences(ckpt, os.path.join(out, "relog", "ckpts",
                                              f"{RESUME_FROM:05d}.npz"))
    n_keys = len(np.load(ckpt).files)
    print(f"resume: {ckpt} restored in {t_resume:.1f} s (keyframes "
          f"{slam.keyframes.frame_idx}, {len(slam.frontend.map.points)} map "
          f"points, reference frame {slam.frontend.prev['frame_idx']}, depth "
          f"scale {slam.frontend.depth_scale:.6f}); logged again at "
          f"{RESUME_FROM}: {n_keys - len(diff)} of {n_keys} arrays equal bit "
          f"for bit, differing {diff}", flush=True)
    if start != RESUME_FROM + 1 or diff:
        fail(f"resume: start {start}, arrays that differ {diff}")
    t0 = time.time()
    slam.run(start, on_frame=lambda s, idx: print(
        "resume: " + frame_line(s.frame_log[-1]), flush=True))
    torch.cuda.synchronize()
    last = WEAK_FRAMES - 1
    rec = {r["idx"]: r for r in slam.frame_log}.get(last, {})
    if "t_err_m" not in rec or "map_losses" not in rec:
        fail(f"resume: frame {last} was not tracked and mapped")
    t_err = float(rec["t_err_m"])
    gap = float(np.linalg.norm(slam.estimate_c2w_list[last][:3, 3]
                               - weak.estimate_c2w_list[last][:3, 3]))
    print(f"resume: frame {last} in {time.time() - t0:.1f} s, t err "
          f"{t_err * 1000:.2f} mm (bound {WEAK_T_MAX * 1000:.0f} mm); "
          f"{gap * 1000:.3f} mm from the uninterrupted run's frame-{last} "
          f"pose", flush=True)
    if not t_err <= WEAK_T_MAX:
        fail(f"resume: frame {last} translation error {t_err} m")
    return slam


def phase_tools(sensor, weak):
    """The port's evaluation tools on this run's outputs: eval_ate on the
    weak run's last checkpoint (its Horn RMSE equals trajectory_errors' of
    the run's own poses to ATE_TOL), and cull_mesh and the 3D metrics of
    the sensor phase's final mesh against a resolution-GT_RES ground-truth
    mesh (printed; no bound on a 6-frame map)."""
    import numpy as np
    from pointnerf_slam_torch.outputs.mesher import write_ply
    from pointnerf_slam_torch.run import trajectory_errors
    from pointnerf_slam_torch.tools.cull_mesh import (REPLICA_INTRINSICS,
                                                      cull_mesh)
    from pointnerf_slam_torch.tools.eval_ate import (evaluate_ate,
                                                     latest_checkpoint)
    from pointnerf_slam_torch.tools.eval_recon import calc_3d_metric
    from pointnerf_slam_torch.tools.make_synthetic_gt_mesh import \
        make_gt_mesh
    t0 = time.time()
    ckpt = latest_checkpoint(WEAK_OUT)
    z = np.load(ckpt)
    ate = evaluate_ate(z["gt_c2w_list"], z["estimate_c2w_list"])
    te = trajectory_errors(weak.estimate_c2w_list, weak.gt_c2w_list)
    d = abs(ate["absolute_translational_error.rmse"] - te["ate_rmse"])
    print(f"tools: eval_ate on {os.path.basename(ckpt)}: RMSE "
          f"{ate['absolute_translational_error.rmse'] * 1000:.4f} mm over "
          f"{ate['compared_pose_pairs']} poses; trajectory_errors "
          f"{te['ate_rmse'] * 1000:.4f} mm (difference {d:.3e} m)",
          flush=True)
    if not d <= ATE_TOL:
        fail(f"tools: eval_ate and trajectory_errors differ by {d} m")
    mesh_dir = os.path.join(sensor.output, "mesh")
    rec = os.path.join(mesh_dir, "final_mesh_eval_rec.ply")
    rec = rec if os.path.exists(rec) else os.path.join(mesh_dir,
                                                       "final_mesh.ply")
    verts, tris, _ = make_gt_mesh(GT_RES)
    v, t = cull_mesh(verts, tris, sensor.gt_c2w_list, **REPLICA_INTRINSICS)
    gt_path = os.path.join(sensor.output, "room_gt_mesh_culled.ply")
    write_ply(gt_path, v, t)
    m3 = calc_3d_metric(rec, gt_path)
    print(f"tools: resolution-{GT_RES} gt mesh {len(verts)} vertices, "
          f"culled to the sensor run's {sensor.n_img} frustums {len(v)}; "
          f"3D metrics of {os.path.basename(rec)}: accuracy "
          f"{m3['accuracy']:.2f} cm, completion {m3['completion']:.2f} cm, "
          f"completion ratio {m3['completion ratio']:.2f} %; "
          f"{time.time() - t0:.1f} s", flush=True)
    if not all(np.isfinite(list(m3.values()))):
        fail(f"tools: 3D metrics not finite: {m3}")


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


def phase_track_check(torch, slam, label="track check"):
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
                                         d, slam.bound, draws, slam.c_grid)
    err = float(torch.linalg.norm(best[4:] - slam._cam7(gt0)[4:]))
    print(f"{label}: frame 0 from +{SHIFT_M * 100:.0f} cm: loss "
          f"{float(fl):.2f} -> {float(bl):.2f}, t err {SHIFT_M * 1000:.1f} "
          f"-> {err * 1000:.3f} mm", flush=True)
    if not err <= SHIFT_BACK_M:
        fail(f"{label}: t err {err} m after tracking from a {SHIFT_M} m "
             f"shift")


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


# -- SuperPoint and the real-dataset readers ----------------------------------

def check_superpoint(torch, gray_np, max_kps=1000):
    """The SuperPoint extractor on the card against its plain float32 run
    on the CPU on one gray frame: heatmap and coarse descriptors, the
    share of valid keypoints on the same pixel, and on those the angles.
    Returns the readings; fails past SP_HEAT / SP_DESC / SP_SHARE."""
    import numpy as np
    from pointnerf_slam_torch.frontend.features import (SuperPointExtractor,
                                                        superpoint_forward)
    out = {}
    ex = {d: SuperPointExtractor(SP_NPZ, max_kps=max_kps, device=d)
          for d in ("cuda", "cpu")}
    res = {}
    for d, e in ex.items():
        g = torch.as_tensor(gray_np, device=d)
        with torch.no_grad():
            heat, desc = superpoint_forward(e.net, g)
        res[d] = [x.cpu().numpy() for x in (heat, desc) + tuple(
            e.extract(g))]
    hc, dc, kc, _, vc, ac = res["cuda"]
    hp, dp, kp, _, vp, ap = res["cpu"]
    out["heat_max_abs"] = float(np.abs(hc - hp).max())
    out["desc_max_abs"] = float(np.abs(dc - dp).max())
    pc = {tuple(k): i for i, k in enumerate(np.round(kc).astype(int))
          if vc[i]}
    pp = {tuple(k): i for i, k in enumerate(np.round(kp).astype(int))
          if vp[i]}
    shared = sorted(set(pc) & set(pp))
    out["keypoints"] = (len(pc), len(pp))
    out["keypoint_share"] = len(shared) / max(len(pc), len(pp), 1)
    da = np.abs(ac[[pc[k] for k in shared]] - ap[[pp[k] for k in shared]])
    out["angle_max_abs"] = float(da.max()) if len(da) else 0.0
    out["angle_share"] = float((da <= SP_ANGLE).mean()) if len(da) else 0.0
    g = torch.as_tensor(gray_np, device="cuda")
    out["ms"] = timed(lambda: ex["cuda"].extract(g))
    if not (out["heat_max_abs"] <= SP_HEAT and out["desc_max_abs"] <= SP_DESC
            and out["keypoint_share"] >= SP_SHARE
            and out["angle_share"] >= SP_SHARE and len(pc) > 20):
        fail(f"superpoint: card against CPU {out}")
    return out


class SpMemo:
    """An extractor that extracts each distinct image once (a torch tensor
    or, in the CPU tests and scripts/twoview_draws_probe.py, a JAX
    array)."""

    def __init__(self, ex, seen):
        self.ex, self.seen = ex, seen

    def extract(self, gray):
        import numpy as np
        key = np.asarray(gray.cpu() if hasattr(gray, "cpu") else gray
                         ).tobytes()
        if key not in self.seen:
            self.seen[key] = self.ex.extract(gray)
        return self.seen[key]


def sp_decisions(fe, frames):
    """One front-end tries the bootstrap against frame 0 at each frame of
    SP_DECISIONS in turn, as the system does, and stops at the first that
    passes: ({frame: "refused" | "bootstrapped"}, {frame: the refusal, or
    the pose's translation error against gt in m})."""
    import numpy as np
    got, why = {}, {}
    for idx in SP_DECISIONS:
        try:
            est = fe.bootstrap(frames, 0, idx, frames[0][3])[0]
        except RuntimeError as err:
            got[idx], why[idx] = "refused", str(err)
            continue
        got[idx] = "bootstrapped"
        why[idx] = float(np.linalg.norm(np.asarray(est)[:3, 3]
                                        - frames[idx][3][:3, 3]))
        break
    return got, why


def phase_superpoint(torch):
    """The distilled checkpoint on the card against the CPU on frame 0 of
    the flagship. Then the front-end's bootstrap decisions on frames 5,
    10, 15 and 20 of room_bench_weak.yaml with superpoint_weights naming
    it: with the RANSAC hypotheses drawn from a CPU generator seeded as
    the front-end's (the CPU test's draws, moved to the card, as
    scripts/twoview_draws_probe.py --cpu_draws does) they must be
    SP_DECISIONS, the CPU test's; with the card's own generator at each of
    SP_SEEDS every bootstrap's translation error must stay within
    SP_BOOT_T_MAX. Last, the 21 frames through the system as a user runs
    it (the card's own generator, seed 7): it bootstraps where the
    probe's seed 7 did, and after a bootstrap the pose stays within
    SP_BOOT_T_MAX, its tracked frames within WEAK_T_MAX and its mapping
    losses fall. Returns (the system, whether it bootstrapped)."""
    import numpy as np
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.frontend import fused_twoview as TV
    from pointnerf_slam_torch.frontend.features import SuperPointExtractor
    from pointnerf_slam_torch.frontend.frontend import SparseFrontend
    from pointnerf_slam_torch.io.datasets import get_dataset
    cfg = weak_config()
    reader = get_dataset(cfg)
    frames = {i: reader[i] for i in (0,) + tuple(SP_DECISIONS)}
    r = check_superpoint(torch, np.asarray(frames[0][1], np.float32).mean(-1))
    print(f"superpoint: 680x1200 frame 0, card against CPU float32: heatmap "
          f"max abs {r['heat_max_abs']:.3e} (bound {SP_HEAT}), descriptors "
          f"{r['desc_max_abs']:.3e} (bound {SP_DESC}), valid keypoints "
          f"{r['keypoints']} with {r['keypoint_share']:.4f} on the same "
          f"pixel, angles max abs {r['angle_max_abs']:.3e} "
          f"({r['angle_share']:.4f} within {SP_ANGLE}); "
          f"{r['ms']:.3f} ms per frame on the card (extract, CUDA-event "
          f"median of 10)", flush=True)
    cfg["superpoint_weights"] = SP_NPZ
    c, seen = cfg["cam"], {}

    def frontend(gen):
        fe = SparseFrontend(cfg, c["H"], c["W"], c["fx"], c["fy"], c["cx"],
                            c["cy"], device="cuda", draws=Draws(gen))
        if not isinstance(fe.extractor, SuperPointExtractor):
            fail(f"superpoint: the front-end took {type(fe.extractor)}")
        fe.extractor = SpMemo(fe.extractor, seen)
        return fe

    def said(got, why):
        return "; ".join(
            f"{i} {d} ({why[i]})" if d == "refused" else
            f"{i} {d} ({why[i] * 1000:.2f} mm off gt)"
            for i, d in got.items())

    draw = TV.draw_hypotheses
    TV.draw_hypotheses = lambda g, mv: draw(g, mv.cpu()).to(mv.device)
    try:
        got, why = sp_decisions(frontend(
            torch.Generator(device="cpu").manual_seed(7)), frames)
    finally:
        TV.draw_hypotheses = draw
    print(f"superpoint: CPU draws, seed 7: {said(got, why)}", flush=True)
    if got != SP_DECISIONS:
        fail(f"superpoint: decisions {got}, the CPU test pins "
             f"{SP_DECISIONS}")
    boots = {}
    for seed in SP_SEEDS:
        got, why = sp_decisions(frontend(
            torch.Generator(device="cuda").manual_seed(seed)), frames)
        print(f"superpoint: card draws, seed {seed}: {said(got, why)}",
              flush=True)
        for i, d in got.items():
            if d == "bootstrapped":
                boots[seed] = (i, why[i])
                if not why[i] <= SP_BOOT_T_MAX:
                    fail(f"superpoint: seed {seed} bootstrapped at frame "
                         f"{i} {why[i]} m off gt")
    print(f"superpoint: {len(boots)} of {len(SP_SEEDS)} seeds of the card's "
          f"generator bootstrap by frame {max(SP_DECISIONS)}: "
          f"{ {s: b[0] for s, b in boots.items()} }", flush=True)
    slam, secs, _ = run_system(torch, cfg, "superpoint", WEAK_FRAMES)
    b = getattr(slam, "bootstrap_idx", None)
    want = boots.get(7, (None,))[0]
    print(f"superpoint: {slam.n_img} frames in {secs:.1f} s with the card's "
          f"generator (seed 7): bootstrap at {b} (the probe's seed 7: "
          f"{want})", flush=True)
    if b != want:
        fail(f"superpoint: the system bootstrapped at {b}, its front-end "
             f"alone at {want}")
    if b is not None:
        t = float(np.linalg.norm(slam.estimate_c2w_list[b][:3, 3]
                                 - slam.gt_c2w_list[b][:3, 3]))
        print(f"superpoint: bootstrap pose {t * 1000:.2f} mm off gt",
              flush=True)
        if not t <= SP_BOOT_T_MAX:
            fail(f"superpoint: bootstrap pose {t} m off gt")
        for rec in slam.frame_log:
            if "map_losses" in rec and not falls(rec["map_losses"], 10):
                fail(f"superpoint: mapping loss of frame {rec['idx']} did "
                     f"not fall")
        if any("t_err_m" in rec for rec in slam.frame_log):
            check_poses(slam, "superpoint", WEAK_T_MAX, tracked_only=True)
    return slam, b is not None


def tum_camera():
    from pointnerf_slam_torch.io.config import load_config
    return load_config(os.path.join(HERE, TUM_CFG))


def write_tum_fixture(root, n=TUM_FRAMES):
    """Frames 0..n-1 of the synthetic room (room_bench's orbit) rendered at
    tum_imap.yaml's camera, written in the TUM layout: rgb/ and depth/
    PNGs (8-bit colour, 16-bit depth at png_depth_scale) written with
    cv2, rgb.txt, depth.txt and groundtruth.txt (30
    Hz, quaternions; raw poses are the NeRF c2w seen through the reader's
    y/z flip). Returns (colour (n, H, W, 3), depth (n, H, W), c2w (n, 4,
    4)) as rendered, and the room bound rebased into the reader's frame
    (frame 0's flipped pose inverted: the reader's poses are relative to
    frame 0)."""
    import cv2
    import numpy as np
    from scipy.spatial.transform import Rotation
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.io.synthetic import SyntheticDataset
    tum = tum_camera()
    room = load_config(os.path.join(HERE, "configs/Synthetic/room_bench.yaml"))
    ds = SyntheticDataset({"cam": tum["cam"], "data": dict(
        room["data"], frame_cache_dir="")})
    scale = float(tum["cam"]["png_depth_scale"])
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    F = np.diag([1.0, -1.0, -1.0, 1.0])
    t0 = 1305031102.175304
    rgb, dep, gt = [], [], []
    colors, depths, c2ws = [], [], []
    for i in range(n):
        _, c, d, c2w = ds[i]
        t = t0 + i / 30.0
        name = f"{t:.6f}.png"
        cv2.imwrite(os.path.join(root, "rgb", name), np.round(
            np.clip(c, 0, 1) * 255).astype(np.uint8)[..., ::-1])
        cv2.imwrite(os.path.join(root, "depth", name), np.round(
            d * scale).astype(np.uint16))
        rgb.append(f"{t:.6f} rgb/{name}")
        dep.append(f"{t:.6f} depth/{name}")
        raw = c2w.astype(np.float64) @ F
        q = Rotation.from_matrix(raw[:3, :3]).as_quat()
        gt.append(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in
                                          [*raw[:3, 3], *q]))
        colors.append(c)
        depths.append(d)
        c2ws.append(c2w)
    head = "# timestamp filename\n"
    for fn, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                      ("groundtruth.txt", gt)):
        with open(os.path.join(root, fn), "w") as fh:
            fh.write(head + "\n".join(lines) + "\n")
    M = F @ np.linalg.inv(c2ws[0].astype(np.float64))
    lo, hi = np.array(room["mapping"]["bound"], np.float64).T
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    cw = corners @ M[:3, :3].T + M[:3, 3]
    bound = [[float(np.floor(a * 100) / 100), float(np.ceil(b * 100) / 100)]
             for a, b in zip(cw.min(0), cw.max(0))]
    return (np.stack(colors), np.stack(depths), np.stack(c2ws)), M, bound


def check_tum_reader(root, fixture, M, n=TUM_FRAMES):
    """The port's TUM reader on the fixture: colour and depth equal the
    rendered frames to the files' u8 / u16 quantisation, frame 0's pose is
    the identity seen through the y/z flip, and every pose is the rendered
    c2w in the rebased frame (M @ c2w). Returns the largest errors."""
    import numpy as np
    from pointnerf_slam_torch.io.datasets import get_dataset
    cfg = tum_camera()
    cfg["data"]["input_folder"] = root
    ds = get_dataset(cfg)
    if len(ds) != n:
        fail(f"readers: the TUM reader found {len(ds)} frames, not {n}")
    colors, depths, c2ws = fixture
    scale = float(cfg["cam"]["png_depth_scale"])
    err = {"color": 0.0, "depth": 0.0, "pose": 0.0}
    for i in range(n):
        idx, c, d, pose = ds[i]
        err["color"] = max(err["color"], float(np.abs(c - colors[i]).max()))
        err["depth"] = max(err["depth"], float(np.abs(d - depths[i]).max()))
        want = M @ c2ws[i].astype(np.float64)
        err["pose"] = max(err["pose"], float(np.abs(pose - want).max()))
    pose0 = ds[0][3]
    if not (err["color"] <= 0.5 / 255 + 1e-6
            and err["depth"] <= 0.5 / scale + 1e-6 and err["pose"] <= 1e-5
            and np.array_equal(pose0, np.diag([1, -1, -1, 1]).astype(
                np.float32))):
        fail(f"readers: TUM frames or poses off the fixture: {err}, frame "
             f"0's pose {pose0.tolist()}")
    return err


def tum_schedule(cfg, n, track_checks=0):
    """K1 / K2 launches the sensor-depth schedule gives n frames: frame 0
    mapped with iters_first, frames 1..n-1 tracked (tracking.iters) and
    mapped every mapping.every_frame (3 outers of iters/3; the last frame
    the colour refine, 5 outers of iters); one K2 per resampled batch of
    either; `track_checks` more tracking calls (phase_track_check)."""
    m, t = cfg["mapping"], cfg["tracking"]
    km = max(int(m.get("resample_every", 1)), 1)
    kt = max(int(t.get("resample_every", 1)), 1)
    tracker = (n - 1 + track_checks) * t["iters"]
    mapped = [i for i in range(1, n)
              if i % m["every_frame"] == 0 or i == n - 1]
    per = [5 * m["iters"] if i == n - 1 and m["color_refine"]
           else 3 * max(m["iters"] // 3, 1) for i in mapped]
    mapper = m["iters_first"] + sum(per)
    p1 = tracker // kt + m["iters_first"] // km + sum(p // km for p in per)
    return {"fused_vg_tracker": tracker, "fused_vg_mapper": mapper,
            "p1_sigma": p1}


def phase_readers(torch):
    """Frames 0..TUM_FRAMES-1 of the synthetic room written in the TUM
    layout at tum_imap.yaml's camera, read back by the port's reader, then
    run through the system with tum_imap.yaml's published budgets (only
    data.input_folder, data.output and the rebased bound overridden): the
    translation error of frames 1.. stays within CAM_T_MAX, and on the map
    they built the tracker pulls frame 0 back from a 2 cm shift
    (phase_track_check). Returns the system; the caller holds its K1/K2
    launches, the track check's included, to tum_schedule."""
    root = os.path.join(HERE, "output", "chip_smoke", "tum_fixture")
    t0 = time.time()
    fixture, M, bound = write_tum_fixture(root)
    err = check_tum_reader(root, fixture, M)
    print(f"readers: TUM fixture of {TUM_FRAMES} frames at 480x640 (fx "
          f"517.3, png_depth_scale 5000) written and read back in "
          f"{time.time() - t0:.1f} s; largest colour error "
          f"{err['color']:.3e} (u8 step {1 / 255:.3e}), depth "
          f"{err['depth']:.3e} m (u16 step {1 / 5000:.1e}), pose "
          f"{err['pose']:.2e}; rebased bound {bound}", flush=True)
    cfg = tum_camera()
    cfg["data"]["input_folder"] = root
    cfg["data"]["output"] = os.path.join(HERE, "output", "chip_smoke", "tum")
    cfg["mapping"]["bound"] = bound
    m, t = cfg["mapping"], cfg["tracking"]
    print(f"readers: {TUM_CFG}: tracking {t['iters']} iterations, every "
          f"frame mapped with {m['iters']}, iters_first {m['iters_first']}, "
          f"{m['pixels']} pixels, {cfg['rendering']['N_samples']}+"
          f"{cfg['rendering']['N_importance']} samples; widths uncut",
          flush=True)
    slam, secs, _ = run_system(torch, cfg, "readers", TUM_FRAMES)
    check_poses(slam, "readers", CAM_T_MAX, tracked_only=True)
    phase_track_check(torch, slam, "readers: track check")
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    tr = mp = 0.0
    for rec in slam.frame_log:
        dev = PointNeRFSLAM.device_seconds(rec)
        tr += dev.get("tracking", 0.0)
        mp += dev.get("mapping", 0.0)
    want = tum_schedule(cfg, TUM_FRAMES)
    print(f"readers: {slam.n_img} frames in {secs:.1f} s; card "
          f"{tr / want['fused_vg_tracker'] * 1e3:.3f} ms per tracker "
          f"iteration, {mp / want['fused_vg_mapper'] * 1e3:.3f} ms per "
          f"mapper iteration (phase CUDA events over the schedule's "
          f"iterations)", flush=True)
    return slam


def phase_outputs(torch, weak):
    """The weak run's writers (its vis_freq OUT_VIS_FREQ): the five folders
    hold their files and each decodes to an image. render_img at 680x1200
    on that map at frame WEAK_FRAMES-1's estimated pose: with the sensor
    depth as the prior (as the panels render) its median relative depth
    error against the sensor depth stays within RENDER_REL; without a
    prior it is the same in chunks of 16384 and 65536 rays (CHUNK_SHARE of
    the pixels within 1e-4, all within CHUNK_ABS); ms per full-frame
    render (CUDA events, median of 3)."""
    import cv2
    import numpy as np
    from pointnerf_slam_torch.render.renderer import render_img
    got = {}
    for sub in OUT_DIRS:
        d = os.path.join(WEAK_OUT, sub)
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        for f in files:
            img = cv2.imread(os.path.join(d, f))
            if img is None or img.size == 0:
                fail(f"outputs: {sub}/{f} does not decode")
        got[sub] = files
        if not files:
            fail(f"outputs: {sub} is empty")
    print(f"outputs: {WEAK_OUT}: {got}", flush=True)
    idx = weak.n_img - 1
    _, color, depth, _ = weak.frame_reader[idx]
    c2w = weak.estimate_c2w_list[idx]
    args = (weak.decoder, weak.rcfg, weak.H, weak.W, weak.fx, weak.fy,
            weak.cx, weak.cy, c2w, weak.bound)
    ms = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        dep, _, col = render_img(*args, gt_depth=depth)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    dep = dep.cpu().numpy()
    m = depth > 0
    rel = float(np.median(np.abs(dep[m] - depth[m]) / depth[m]))
    finite = bool(np.isfinite(dep).all() and torch.isfinite(col).all())
    d1, _, c1 = render_img(*args, chunk=16384)
    d2, _, c2 = render_img(*args, chunk=65536)
    err = torch.maximum((d1 - d2).abs(), (c1 - c2).abs().amax(-1))
    share = float((err <= 1e-4).float().mean())
    print(f"outputs: ({card()}) render_img {weak.H}x{weak.W} at frame "
          f"{idx}'s pose: "
          f"{float(np.median(ms)):.3f} ms per frame (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in ms)}); depth against the sensor "
          f"depth, median relative error {rel:.4f} (bound {RENDER_REL}); "
          f"chunks 16384 against 65536: {share:.5f} of pixels within 1e-4, "
          f"largest difference {float(err.max()):.3e}", flush=True)
    if not finite:
        fail("outputs: render_img gave a non-finite value")
    if not rel <= RENDER_REL:
        fail(f"outputs: render_img depth median relative error {rel}")
    if not (share >= CHUNK_SHARE and float(err.max()) <= CHUNK_ABS):
        fail(f"outputs: render_img depends on the chunk ({share}, "
             f"{float(err.max())})")
    return float(np.median(ms))


def nice_config():
    """room_bench.yaml with configs/nice_slam.yaml's keys overlaid (the
    overlay tests/test_nice_mode.py makes on its tiny config): NICE grids
    and decoders (32 wide, c_dim 32; grid_len coarse 2 enlarged x2,
    middle 0.32, fine 0.16, colour 0.16), occupancy, 32 + 16 surface
    samples, tracking 200 pixels x 10 iterations every frame with
    handle_dynamic, mapping 1000 pixels x 60 iterations every 5th frame
    (iters_first 1500), BA, overlap windows, frustum feature selection;
    the last frame's colour refine cut."""
    import yaml
    from pointnerf_slam_torch.io.config import load_config, update_recursive
    cfg = load_config(os.path.join(HERE, "configs/Synthetic/room_bench.yaml"))
    with open(os.path.join(HERE, "configs/nice_slam.yaml")) as fh:
        update_recursive(cfg, yaml.safe_load(fh))
    cfg["data"]["frame_cache_dir"] = ""
    # cut: no end-of-run colour refine (5 outers of the window, ~10 s)
    cfg["mapping"]["color_refine"] = False
    return cfg


def nice_timings(torch, slam):
    """ms per mapper iteration by stage (the last frame's window, each
    stage's step NICE_ITERS times after one warm-up call) and per tracker
    iteration (the last frame), CUDA events."""
    import numpy as np
    from pointnerf_slam_torch.engine.state import Draws
    idx = slam.n_img - 1
    _, color, depth, _ = slam.frame_reader[idx]
    c, d, u8 = slam._upload_frame(idx, color, depth)
    slots = slam._select_window(False, d, slam.estimate_c2w_list[idx])
    win = slam._window(slots, slam.max_window, u8, d,
                       slam._cam7(slam.estimate_c2w_list[idx]))
    valid = win[3]
    draws = Draws(torch.Generator(device=slam.device).manual_seed(3))
    masks = slam._frustum_masks(idx, d)
    grids = {k: v.clone() for k, v in slam.c_grid.items()}
    state = {k: v.clone() for k, v in slam.decoder.state_dict().items()}
    out = {}
    for stage in ("coarse", "middle", "fine", "color"):
        fn = slam._get_mapper_step(slam.max_window, False, stage)
        ba = torch.zeros_like(valid)
        for n in (1, NICE_ITERS):
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            fn(slam.decoder, *win[:3], valid, ba, slam.bound, draws, n,
               slam.c_grid, masks)
            b.record()
            b.synchronize()
        out[f"mapper {stage}"] = a.elapsed_time(b) / NICE_ITERS
    slam.c_grid = grids                    # the timing changed nothing
    slam.decoder.load_state_dict(state)
    cam = slam._cam7(slam.estimate_c2w_list[idx])
    for n in (1, 2):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        slam.tracking_step(slam.decoder, cam, c, d, slam.bound, draws,
                           slam.c_grid)
        b.record()
        b.synchronize()
    out["tracker"] = a.elapsed_time(b) / slam.ecfg.num_cam_iters
    return {k: float(np.round(v, 4)) for k, v in out.items()}


def phase_nice(torch):
    """NICE at full width (nice_config) for frames 0..NICE_FRAMES-1 with
    the outputs attached: mapping losses finite, the middle, fine and
    colour grids moved, tracked frames within CAM_T_MAX, the final mesh
    written with faces; the tracker pulls frame 0 back from a 2 cm shift
    on that map; then a static-camera variant (orbit 0, gt poses, no BA,
    no coarse level, frames 0..NICE_STATIC_FRAMES-1, iters_first cut to
    100): cells outside frame 0's frustum bit for bit unmoved, in-frustum
    cells moved. Prints ms per tracker and mapper iteration by stage.
    Returns the timings."""
    import numpy as np
    from pointnerf_slam_torch.outputs.mesher import read_ply
    cfg = nice_config()
    out = os.path.join(HERE, "output", "chip_smoke", "nice")
    m, t, r = cfg["mapping"], cfg["tracking"], cfg["rendering"]
    print(f"nice: room_bench 680x1200 with nice_slam.yaml, frames "
          f"0..{NICE_FRAMES - 1}: c_dim {cfg['model']['c_dim']}, grid_len "
          f"{cfg['grid_len']}, tracking {t['pixels']} x {t['iters']} "
          f"(handle_dynamic {t['handle_dynamic']}), mapping {m['pixels']} x "
          f"{m['iters']} every {m['every_frame']} (iters_first "
          f"{m['iters_first']}), BA {m['BA']}, {m['keyframe_selection_method']}"
          f", frustum {m['frustum_feature_selection']}, {r['N_samples']} + "
          f"{r['N_surface']} samples, occupancy {cfg['occupancy']}; widths "
          f"uncut", flush=True)
    g0 = {}
    slam, secs, _ = run_system(torch, cfg, "nice", NICE_FRAMES, output=out,
                               grids0=g0)
    shapes = {k: tuple(v.shape) for k, v in slam.c_grid.items()}
    moved = {k: float((slam.c_grid[k] - g0[k]).abs().max()) for k in g0}
    print(f"nice: {slam.n_img} frames in {secs:.1f} s; grids {shapes}; "
          f"largest move {moved}", flush=True)
    for k in ("grid_middle", "grid_fine", "grid_color"):
        if not moved[k] > 0:
            fail(f"nice: {k} did not move")
    for rec in slam.frame_log:
        if "map_losses" in rec and not torch.isfinite(
                rec["map_losses"]).all():
            fail(f"nice: mapping loss of frame {rec['idx']} not finite")
    check_poses(slam, "nice", CAM_T_MAX, tracked_only=True)
    mesh = os.path.join(out, "mesh", "final_mesh.ply")
    if not os.path.exists(mesh):
        fail(f"nice: no {mesh}")
    verts, faces, _ = read_ply(mesh)
    print(f"nice: {mesh}: {len(verts)} vertices, {len(faces)} faces",
          flush=True)
    if not len(faces):
        fail("nice: the final mesh has no face")
    nice_track_check(torch, slam)
    ms = nice_timings(torch, slam)
    print(f"nice: ms per iteration (CUDA events; {card()}): {ms}",
          flush=True)

    cfg = nice_config()
    cfg["data"]["orbit"] = 0.0
    cfg["coarse"] = False
    cfg["mapping"].update(BA=False, iters_first=100)
    cfg["tracking"]["gt_camera"] = True
    g0 = {}
    slam, secs, _ = run_system(torch, cfg, "nice static",
                               NICE_STATIC_FRAMES, grids0=g0)
    _, _, depth, _ = slam.frame_reader[0]
    masks = slam._frustum_masks(0, torch.as_tensor(depth, device=slam.device))
    for k in ("grid_middle", "grid_fine", "grid_color"):
        mk = masks[k][..., 0] > 0
        delta = (slam.c_grid[k] - g0[k]).abs().amax(-1)
        out_moved = float(delta[~mk].max()) if (~mk).any() else 0.0
        in_moved = float(delta[mk].max()) if mk.any() else 0.0
        print(f"nice static: {k}: {int(mk.sum())} of {mk.numel()} cells in "
              f"frame 0's frustum; largest move outside {out_moved:.3e}, "
              f"inside {in_moved:.3e}", flush=True)
        if not (mk.any() and (~mk).any()):
            fail(f"nice static: {k}'s mask is trivial")
        if out_moved != 0.0:
            fail(f"nice static: {k} moved outside the frustum")
        if not in_moved > 0:
            fail(f"nice static: {k} did not move inside the frustum")
    return ms


def nice_frame_loss(torch, slam, cam7, color, depth, stride=8) -> float:
    """The NICE tracker's own loss of camera cam7 on every stride-th pixel
    of the frame's tracked crop: the first loss of a one-iteration
    tracking step built from the system's configs, its pixel draw
    replayed with that fixed batch, so two cameras compare without the
    tracker's per-iteration pixel draws."""
    import dataclasses
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.engine.tracker import make_tracking_step
    e = slam.ecfg
    step = make_tracking_step(slam.model_cfg, slam.rcfg,
                              dataclasses.replace(e, num_cam_iters=1))
    jj, ii = torch.meshgrid(
        torch.arange(e.ignore_edge_H, slam.H - e.ignore_edge_H, stride,
                     device=slam.device),
        torch.arange(e.ignore_edge_W, slam.W - e.ignore_edge_W, stride,
                     device=slam.device), indexing="ij")
    idx = (jj * slam.W + ii).reshape(-1)
    return float(step(slam.decoder, cam7, color, depth, slam.bound,
                      Draws(replay=[idx]), slam.c_grid)[2])


def nice_track_check(torch, slam, rounds=20):
    """The NICE tracker at its own budget (tracking.pixels rays x
    tracking.iters iterations a call), `rounds` calls from frame 0 shifted
    2 cm along +y, each from the last call's best camera. Judged on the
    tracker's own loss over one fixed batch (every 8th pixel of the
    tracked crop, nice_frame_loss): the tracked camera must close at
    least half the gap between the shifted start's loss and gt's (a
    tracker that does nothing closes none). The translation error is
    printed, not bounded: on this map the reference's NICE tracker does
    not close the shift either (scripts/nice_track_witness.py: from the
    frame-10 checkpoint of this configuration, both packages' trackers on
    the same pixel draws end 20 rounds 12-19 mm off gt at frames 0 and
    10)."""
    import numpy as np
    from pointnerf_slam_torch.engine.state import Draws
    _, color, depth, gt0 = slam.frame_reader[0]
    c, d, _ = slam._upload_frame(0, color, depth)
    d = slam._supervising_depth(0, d)
    start = np.asarray(gt0, np.float64).copy()
    start[1, 3] += SHIFT_M
    draws = Draws(torch.Generator(device=slam.device).manual_seed(7))
    best = slam._cam7(start)
    for _ in range(rounds):
        best = slam.tracking_step(slam.decoder, best, c, d, slam.bound,
                                  draws, slam.c_grid)[0]
    l_gt, l0, l1 = (nice_frame_loss(torch, slam, cam, c, d) for cam in (
        slam._cam7(gt0), slam._cam7(start), best))
    err = float(torch.linalg.norm(best[4:] - slam._cam7(gt0)[4:]))
    bound = l0 - 0.5 * (l0 - l_gt)
    print(f"nice: track check: frame 0 from +{SHIFT_M * 100:.0f} cm, "
          f"{rounds} x {slam.ecfg.num_cam_iters} iterations of "
          f"{slam.ecfg.tracking_pixels} rays: loss on every 8th pixel at gt "
          f"{l_gt:.2f}, start {l0:.2f}, tracked {l1:.2f} (bound "
          f"{bound:.2f}); t err {SHIFT_M * 1000:.1f} -> {err * 1000:.3f} mm",
          flush=True)
    if not (l0 > l_gt and l1 <= bound):
        fail(f"nice: track check: loss {l0} -> {l1} (gt {l_gt})")


def phase_runpy(torch, readers):
    """python -m pointnerf_slam_torch.run on the readers phase's TUM
    fixture: a config that inherits configs/TUM_RGBD/tum_imap.yaml with the
    fixture's bound and cut iterations (15 mapping iterations a frame, 10
    tracking, no colour refine or eval mesh: the profiler records every
    op, ~2 GB of trace at 150 / 50),
    --input_folder naming the fixture, --n_frames RUNPY_FRAMES, --profile:
    the run exits 0, the profiler wrote a trace file and run.py the
    program's spans."""
    import glob
    import yaml
    root = os.path.join(HERE, "output", "chip_smoke", "runpy")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    conf = os.path.join(root, "tum_fixture.yaml")
    with open(conf, "w") as fh:
        yaml.safe_dump({
            "inherit_from": os.path.join(HERE, TUM_CFG),
            "mapping": {"bound": [list(map(float, b)) for b in
                                  readers.cfg["mapping"]["bound"]],
                        "iters_first": 15, "iters": 15,
                        "color_refine": False},
            "tracking": {"iters": 10},
            "meshing": {"eval_rec": False},
            "data": {"output": os.path.join(root, "out")}}, fh)
    trace = os.path.join(root, "trace")
    cmd = [sys.executable, "-m", "pointnerf_slam_torch.run", conf,
           "--input_folder", readers.cfg["data"]["input_folder"],
           "--n_frames", str(RUNPY_FRAMES), "--profile", trace]
    t0 = time.time()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=RUNPY_TIMEOUT)
    secs = time.time() - t0
    tail = "\n".join(res.stdout.splitlines()[-4:])
    traces = glob.glob(os.path.join(trace, "*.pt.trace.json"))
    size = sum(os.path.getsize(f) for f in traces)
    spans = os.path.join(trace, "program_spans.json")
    n_spans = len(json.load(open(spans))["traceEvents"]) \
        if os.path.exists(spans) else 0
    print(f"run.py: {' '.join(cmd[1:])}: exit {res.returncode} in "
          f"{secs:.1f} s; traces {[os.path.basename(f) for f in traces]} "
          f"({size / 1e6:.1f} MB), {n_spans} program spans\n{tail}",
          flush=True)
    if res.returncode:
        fail(f"run.py: exit {res.returncode}: {res.stderr[-2000:]}")
    if not traces or not size:
        fail(f"run.py: no profiler trace in {trace}")
    if not n_spans:
        fail(f"run.py: no program spans in {trace}")
    return secs


def par_ecfg(**over):
    """The weak flagship's mapper at full width: 680x1200 pseudo-depth
    frames, a 6-frame window, 5000 pixels (split over the ranks), 3 outers
    of 100 iterations at K=4, BA off, w_beyond 1."""
    return bench_ecfg(weak_depth=True, **over)


def par_window(torch):
    """Six 680x1200 frames of sparse pseudo-depth (30% of pixels hold a
    depth, as a splatted pseudo-depth holds few), random colours, cameras
    1 cm apart, valid, no BA; stacked for 3 outers."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    colors = (torch.rand(6, H, W, 3, generator=g, device=dev) * 255).to(
        torch.uint8)
    depths = (0.5 + 2.5 * torch.rand(6, H, W, generator=g, device=dev)) * (
        torch.rand(6, H, W, generator=g, device=dev) < 0.3)
    cams = torch.tensor([1.0, 0, 0, 0, 0, 0, 2.5], device=dev).repeat(6, 1)
    cams[:, 4] = 0.01 * torch.arange(6, device=dev)
    valid = torch.ones(6, dtype=torch.bool, device=dev)
    ba = torch.zeros(6, dtype=torch.bool, device=dev)
    bound = torch.tensor([[-3.5, 3.5]] * 3, device=dev)
    one = (colors, depths, cams, valid, ba)
    return one, tuple(t.expand((3,) + t.shape).contiguous() for t in one), \
        bound


def par_digest(tensors) -> str:
    import hashlib
    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()


def par_rank_nccl(torch, dist, rank):
    """(1) and the 1-rank half of (4) in a one-rank NCCL group: the
    mapper schedule with the group and without, bit for bit; one NCCL
    all_reduce over the group; ms per iteration of 3 x 100. "launches":
    the runs through the group (the check's and the timed one), not the
    run without it."""
    import copy
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.parallel import make_mesh
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dev = torch.device("cuda")
    group = make_mesh(device=dev)
    dec0 = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    _, win3, bound = par_window(torch)
    runs = {}
    for tag, g in (("group", group), ("none", None)):
        F.reset_launches()
        dec = copy.deepcopy(dec0)
        step = make_mapper_step(MLPConfig(), RenderConfig(), par_ecfg(), 6,
                                outer_fused=True, group=g)
        _, ls = step(dec, *win3, bound, Draws(torch.Generator(
            device=dev).manual_seed(5)), PAR_CHECK_ITERS)
        runs[tag] = (list(dec.parameters()), ls)
        if tag == "group":
            launches = dict(F.launches)
    bit_equal = torch.equal(runs["group"][1], runs["none"][1]) and all(
        torch.equal(a, b) for a, b in zip(runs["group"][0],
                                          runs["none"][0]))
    flat = torch.cat([p.detach().reshape(-1) for p in runs["group"][0]])
    before = flat.clone()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    torch.cuda.synchronize()
    dec = copy.deepcopy(dec0)
    step = make_mapper_step(MLPConfig(), RenderConfig(), par_ecfg(), 6,
                            outer_fused=True, group=group)
    draws = Draws(torch.Generator(device=dev).manual_seed(1000))
    torch.cuda.synchronize()
    F.reset_launches()
    t0 = time.time()
    _, ls = step(dec, *win3, bound, draws, PAR_ITERS)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / (3 * PAR_ITERS)
    launches = {k: v + launches[k] for k, v in F.launches.items()}
    return {"world": group.world_size, "backend": dist.get_backend(),
            "bit_equal": bool(bit_equal),
            "nccl_all_reduce_equal": bool(torch.equal(flat, before)),
            "ms_per_iter": ms, "falls": falls(ls, 10),
            "loss": [float(ls[:10].mean()), float(ls[-10:].mean())],
            "launches": launches}


def par_rank_gloo(torch, dist, rank):
    """(2), (3) and the 2-rank half of (4) on one of the gloo ranks.
    "launches_mapper": (2b)'s launches, "launches": (3)'s; (2a)'s check
    against one process on the union is not counted."""
    import copy
    import numpy as np
    from pointnerf_slam_torch.core.rays import sample_uv_valid
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.outputs import attach_outputs
    from pointnerf_slam_torch.parallel import make_mesh
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dev = torch.device("cuda")
    group = make_mesh(device=dev)
    world = group.world_size
    res = {"world": world, "backend": dist.get_backend()}
    dec0 = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    win, win3, bound = par_window(torch)
    # (2a) one iteration: each rank's own pixels (rank r's from generator
    # 100 + r), K1's gradients summed over the group; rank 0 also runs K1
    # without a group on the union of every rank's pixels. The far clip
    # reads the max depth of the rays a rank renders (per device, as the
    # reference's shard_map), so every rank's first pixel is the window's
    # deepest: each rank's max then equals the union's
    ppf = 5000 // 6 // world
    deepest = int(win[1].reshape(-1).argmax())
    f_max, px_max = divmod(deepest, H * W)
    draws = []
    for r in range(world):
        g = torch.Generator(device=dev).manual_seed(100 + r)
        idx = torch.stack([sample_uv_valid(g, d > 0.01, ppf)[0]
                           for d in win[1]])
        idx[f_max, 0] = px_max
        draws.append((idx, torch.rand(6 * ppf, 32, generator=g,
                                      device=dev)))
    dec = copy.deepcopy(dec0)
    _, ls = make_mapper_step(MLPConfig(), RenderConfig(), par_ecfg(), 6,
                             group=group)(
        dec, *win, bound, Draws(replay=list(draws[rank])), 1)
    res["rays_per_rank"] = 6 * ppf
    res["after_one"] = par_digest(dec.parameters())
    if rank == 0:
        dec_u = copy.deepcopy(dec0)
        idx_u = torch.cat([d[0] for d in draws], 1)
        t_u = torch.cat([d[1].reshape(6, ppf, -1) for d in draws],
                        1).reshape(6 * ppf * world, -1)
        _, ls_u = make_mapper_step(
            MLPConfig(), RenderConfig(),
            par_ecfg(mapping_pixels=6 * ppf * world), 6)(
            dec_u, *win, bound, Draws(replay=[idx_u, t_u]), 1)
        rel = {n: float((p.grad - q.grad).abs().max() / q.grad.abs().max())
               for (n, p), q in zip(dec.named_parameters(),
                                    dec_u.parameters())}
        res["union_rays"] = int(idx_u.numel())
        res["union_grad_rel"] = rel
        res["union_loss"] = [float(ls[0]), float(ls_u[0])]
    # (2b) the weak flagship's mapper schedule, 3 x 100 at K=4, each rank
    # on its own stream; the summed gradients keep the decoders equal
    F.reset_launches()
    dec = copy.deepcopy(dec0)
    step = make_mapper_step(MLPConfig(), RenderConfig(), par_ecfg(), 6,
                            outer_fused=True, group=group)
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.time()
    _, ls = step(dec, *win3, bound, Draws(gen), PAR_ITERS)
    torch.cuda.synchronize()
    res["ms_per_iter"] = (time.time() - t0) * 1e3 / (3 * PAR_ITERS)
    res["falls"] = falls(ls, 10)
    res["loss"] = [float(ls[:10].mean()), float(ls[-10:].mean())]
    res["after_300"] = par_digest(dec.parameters())
    res["launches_mapper"] = dict(F.launches)
    # (3) room_bench frames 0..5 through the system, as phase_system runs
    # them, on every rank, each with outputs.attach_outputs into its own
    # directory: rank 0 alone writes (checkpoints, the final mesh, the
    # panels at OUT_VIS_FREQ, so frame 5's tracking panel is drawn), and
    # every rank commits its tracked poses alike
    cfg = load_config(os.path.join(HERE, "configs/Synthetic/room_bench.yaml"))
    cfg["mapping"].update(fused_outer=True, resample_every=4,
                          color_refine=False, vis_freq=OUT_VIS_FREQ)
    cfg["tracking"].update(resample_every=5, vis_freq=OUT_VIS_FREQ)
    cfg["meshing"]["eval_rec"] = False
    cfg["data"]["frame_cache_dir"] = ""
    out = os.path.join(HERE, "output", "chip_smoke", "parallel",
                       f"rank{rank}_out")
    shutil.rmtree(out, ignore_errors=True)
    slam = attach_outputs(PointNeRFSLAM(cfg, n_frames_cap=PAR_FRAMES,
                                        device="cuda", output=out))
    if slam.group.world_size != world:
        raise RuntimeError(f"the system sees {slam.group.world_size} ranks")
    F.reset_launches()
    t0 = time.time()
    slam.run()
    torch.cuda.synchronize()
    res["system_s"] = time.time() - t0
    res["launches"] = dict(F.launches)
    res["written"] = sorted(
        os.path.relpath(os.path.join(d, f), out)
        for d, _, files in os.walk(out) for f in files)
    res["system_decoder"] = par_digest(slam.decoder.parameters())
    res["system_poses"] = par_digest([torch.as_tensor(
        np.ascontiguousarray(slam.estimate_c2w_list))])
    res["system_keyframes"] = par_digest([slam.keyframes.est_c2w])
    res["frames"] = {}
    for rec in slam.frame_log:
        r = {}
        if "map_losses" in rec:
            r["map_falls"] = falls(rec["map_losses"], 10)
        if "t_err_m" in rec:
            r["t_err_m"] = float(rec["t_err_m"])
        res["frames"][str(rec["idx"])] = r
    return res


def parallel_rank() -> None:
    """A rank process of phase_parallel (argv: task, store, rank, world,
    output directory): joins the group through the file store, runs its
    task on the card and writes rank<r>_<task>.json."""
    task, store, out = sys.argv[1], sys.argv[2], sys.argv[5]
    rank, world = int(sys.argv[3]), int(sys.argv[4])
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise SystemExit(f"rank {rank}: no CUDA device")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl" if task == "nccl" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        res = (par_rank_nccl if task == "nccl" else par_rank_gloo)(
            torch, dist, rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}_{task}.json"), "w") as fh:
        json.dump(res, fh)


def par_launch(task: str, world: int, out: str) -> list:
    """Start `world` rank processes of task (a file:// store under out),
    wait for them, stop them all on a failure or at PAR_TIMEOUT, and
    return their results; a rank that fails fails the phase."""
    store = os.path.join(out, f"store_{task}")
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
            f"chip_smoke.parallel_rank()")
    logs, procs = [], []
    for r in range(world):
        logs.append(open(os.path.join(out, f"rank{r}_{task}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, task, store, str(r), str(world),
             out], stdout=logs[-1], stderr=subprocess.STDOUT))
    t_end = time.time() + PAR_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > t_end or any(p.poll() not in (None, 0)
                                          for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for fh in logs:
            fh.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(out, f"rank{r}_{task}.log")) as fh:
                print(f"parallel: rank {r} of {task} (rc "
                      f"{procs[r].returncode}), last lines:\n"
                      + "".join(fh.readlines()[-30:]), flush=True)
        fail(f"parallel: {task} rank(s) {bad} failed or timed out")
    outs = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}_{task}.json")) as fh:
            outs.append(json.load(fh))
    return outs


def phase_parallel(torch):
    """Data-parallel mapping on the one card. Returns {"launches": the
    ranks' summed launch counts, "ms": (1 rank, 2 ranks)}."""
    out = os.path.join(HERE, "output", "chip_smoke", "parallel")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.time()
    (one,) = par_launch("nccl", 1, out)
    if not (one["world"] == 1 and one["backend"] == "nccl"):
        fail(f"parallel: the NCCL group is {one['world']} x "
             f"{one['backend']}")
    if not one["bit_equal"]:
        fail("parallel: the mapper under a one-rank NCCL group differs "
             "from no group")
    if not one["nccl_all_reduce_equal"]:
        fail("parallel: a one-rank NCCL all_reduce changed its tensor")
    if not one["falls"]:
        fail(f"parallel: 1-rank mapper loss did not fall: {one['loss']}")
    print(f"parallel: (1) one-rank NCCL group: 3 x {PAR_CHECK_ITERS} mapper "
          f"iterations (4998 rays, weak 680x1200 window) bit for bit "
          f"equal to no group; NCCL all_reduce ok", flush=True)
    ranks = par_launch("gloo", PAR_RANKS, out)
    r0 = ranks[0]
    worst = max(r0["union_grad_rel"].values())
    print(f"parallel: (2) {PAR_RANKS} gloo ranks on one card, "
          f"{r0['rays_per_rank']} rays each: summed K1 gradients against "
          f"one process's K1 on the union ({r0['union_rays']} rays): "
          f"max |diff| / max|g| {worst:.3e} (bound {PAR_GRAD:g}) "
          f"{ {k: f'{v:.2e}' for k, v in r0['union_grad_rel'].items()} }; "
          f"losses {r0['union_loss']}", flush=True)
    if not worst <= PAR_GRAD:
        fail(f"parallel: summed gradients off the union's by {worst}")
    for key in ("after_one", "after_300", "system_decoder", "system_poses",
                "system_keyframes"):
        if len({r[key] for r in ranks}) != 1:
            fail(f"parallel: the ranks' {key} differ")
    print(f"parallel: decoders bit-equal across ranks after 1 and 3 x "
          f"{PAR_ITERS} iterations and after the system run; trajectories "
          f"and keyframe cameras bit-equal", flush=True)
    for r, res in enumerate(ranks):
        if res["world"] != PAR_RANKS or res["backend"] != "gloo":
            fail(f"parallel: rank {r} group {res['world']} x "
                 f"{res['backend']}")
        if not res["falls"]:
            fail(f"parallel: rank {r} mapper loss did not fall: "
                 f"{res['loss']}")
        for k in ("p1_sigma", "fused_vg_mapper"):
            if one["launches"][k] <= 0:
                fail(f"parallel: the NCCL rank did not launch {k}")
            if res["launches"][k] <= 0 or res["launches_mapper"][k] <= 0:
                fail(f"parallel: rank {r} did not launch {k} in both the "
                     f"mapper schedule and the system")
        for idx, fr in res["frames"].items():
            if "map_falls" in fr and not fr["map_falls"]:
                fail(f"parallel: rank {r} frame {idx} mapping loss did not "
                     f"fall")
            if "t_err_m" in fr and not fr["t_err_m"] <= CAM_T_MAX:
                fail(f"parallel: rank {r} frame {idx} t err {fr['t_err_m']}")
    written = [sorted({w.split(os.sep)[0] for w in res["written"]})
               for res in ranks]
    want = ["ckpts", "mapping_vis", "mesh", "tracking_vis"]
    if any(d not in written[0] for d in want) or any(written[1:]):
        fail(f"parallel: outputs written per rank {written}; rank 0 alone "
             f"writes {want}")
    errs = {i: round(f["t_err_m"] * 1000, 2) for i, f in
            r0["frames"].items() if "t_err_m" in f}
    print(f"parallel: (3) room_bench frames 0..{PAR_FRAMES - 1} on "
          f"{PAR_RANKS} ranks with outputs attached on each in "
          f"{r0['system_s']:.1f} s: t err mm {errs} (bound "
          f"{CAM_T_MAX * 1000:.0f}), mapping losses fall; written per rank "
          f"{written}", flush=True)
    ms1 = one["ms_per_iter"]
    ms2 = [res["ms_per_iter"] for res in ranks]
    print(f"parallel: (4) ms per mapper iteration (3 x {PAR_ITERS}, K=4): "
          f"1 rank {ms1:.3f} (4998 rays), {PAR_RANKS} ranks "
          f"{[round(m, 3) for m in ms2]} ({r0['rays_per_rank']} rays each, "
          f"gloo all_reduce of the gradients per iteration); {card()}; "
          f"phase {time.time() - t0:.1f} s", flush=True)
    per_rank = [{k: res["launches"][k] + res["launches_mapper"][k]
                 for k in res["launches"]} for res in ranks]
    total = {k: one["launches"][k] + sum(c[k] for c in per_rank)
             for k in one["launches"]}
    print(f"parallel: launches: one-rank NCCL {one['launches']}, gloo "
          f"ranks {per_rank}", flush=True)
    return {"launches": total, "ms": (ms1, ms2)}


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
    print(card())
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
    print(f"build: HGMMA / HMMA instructions per library (cuobjdump "
          f"-sass): { {k: v[:2] for k, v in sass.items()} }", flush=True)
    for name in build.SOURCES:
        hgmma, hmma, kernels = sass[name]
        wmma = [f for f in kernels if any(k in f for k in WMMA_KERNELS)]
        print(f"build: {name}: {len(kernels)} kernels: {kernels}; WMMA "
              f"kernels among them: {wmma}", flush=True)
        if not hgmma:
            fail(f"build: {name} has no HGMMA (wgmma) instruction")
        if hmma or wmma:
            fail(f"build: {name} holds WMMA kernels {wmma} ({hmma} HMMA "
                 f"instructions)")
    if any("wgrad_kernel" in f for f in sass["p1_sigma"][2]):
        fail("build: p1_sigma holds the backward's wgrad_kernel")
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
             ("bench", lambda: phase_bench(torch), k1),
             ("dynamic tracker", lambda: phase_engine_dynamic(torch), mk),
             ("mesh", lambda: phase_mesh(torch, slam), ("fused_mlp_fwd",)),
             ("plain", lambda: phase_engine_plain(torch),
              ("fused_mlp_fwd", "fused_mlp_bwd")),
             ("mapper two-kernel", lambda: phase_mapper_mk(torch), mk),
             ("weak", lambda: phase_weak(torch), k1),
             ("resume", lambda: phase_resume(torch, weak), k1),
             ("dynamic", lambda: phase_dynamic(torch),
              ("p1_sigma", "fused_vg_mapper") + mk),
             ("outputs", lambda: phase_outputs(torch, weak), ()),
             ("superpoint", lambda: phase_superpoint(torch), ()),
             ("readers", lambda: phase_readers(torch), k1),
             ("nice", lambda: phase_nice(torch), ()),
             ("parallel", lambda: phase_parallel(torch),
              ("p1_sigma", "fused_vg_mapper")))
    # the paths the reference keeps off every kernel (render_img, NICE)
    none = ("outputs", "nice")
    for label, run, must in paths:
        F.reset_launches()
        out = run()
        got = dict(F.launches)
        if label == "parallel":
            # the ranks' processes launch; their counts come back summed
            got = {k: v + out["launches"].get(k, 0) for k, v in got.items()}
        print(f"launches on the {label} path: {got}", flush=True)
        for k in must:
            if got[k] <= 0:
                fail(f"kernel {k} never launched on the {label} path")
        if label in none:
            if any(got.values()):
                fail(f"the {label} path launched kernels: {got}")
            for k in by_path:
                by_path[k][label] = 0
        for k in counts:
            counts[k] += got[k]
            if got[k]:
                by_path[k][label] = got[k]
        if label == "sensor":
            slam = out
        elif label == "weak":
            weak = out
        elif label == "dynamic":
            dyn = out
        elif label == "superpoint":
            # after a bootstrap the mapper and the tracker run K1/K2;
            # without one no frame is mapped or tracked
            if out[1] and not all(got[k] for k in k1):
                fail(f"superpoint: K1/K2 not launched after the bootstrap: "
                     f"{got}")
            if not out[1] and any(got[k] for k in k1):
                fail(f"superpoint: K1/K2 launched without a bootstrap: "
                     f"{got}")
        elif label == "outputs":
            render_ms = out
        elif label == "nice":
            nice_ms = out
        elif label == "parallel":
            par_ms = out["ms"]
        elif label == "readers":
            readers = out
            want = tum_schedule(out.cfg, TUM_FRAMES, track_checks=1)
            if any(got[k] != v for k, v in want.items()):
                fail(f"readers: K1/K2 launches {got}, the schedule gives "
                     f"{want}")
            print(f"readers: K1/K2 launches equal the schedule {want}",
                  flush=True)
    print(f"launches on the main paths: {counts}")
    for k, c in counts.items():
        if c <= 0:
            fail(f"kernel {k} never launched on the main path")
    runpy_s = phase_runpy(torch, readers)
    print(f"new phases: render_img {render_ms:.3f} ms per 680x1200 frame; "
          f"NICE ms per iteration {nice_ms}; parallel mapper ms per "
          f"iteration (1 rank, 2 ranks) {par_ms}; run.py {runpy_s:.1f} s "
          f"(launches of the run.py phase are its subprocess's, not "
          f"counted here)", flush=True)
    phase_tools(slam, weak)
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
