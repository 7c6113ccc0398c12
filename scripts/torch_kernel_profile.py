#!/usr/bin/env python3
"""Per-CUDA-kernel time of one fused value-and-grad iteration of the port,
of one render megakernel pair (K3 forward, K4 backward) and of the
decoder pair (K5 forward, K6 backward).

  python3 scripts/torch_kernel_profile.py [--reps 20]

At the main path's shapes (mapper: 4998 rays x (44 + 32) points, colour,
w_beyond 1, with ray gradients as the benchmark's cells run it and
without; tracker: 5000 rays x 44 points, ray gradients only; p1: 4998
rays x 32 points; K3/K4: the handle_dynamic
tracker's 5000 rays x (32 + 12), K4 without weight gradients, and the
mapper shape 4998 x (32 + 12 + 32) with them; K5 at a 500,000-point
chunk of room_bench's mesh grid, K6 at the 379,848 points the plain-path
mapper's loss reaches, with weight gradients only, dx only and both) it
runs each call under
torch.profiler and prints the CUDA time per kernel name (ms per call,
averaged over --reps calls) and the device-busy share of the window;
beside the dh chain and the weight-gradient GEMM it prints their byte and
product floors (`floors`, the reckoning of csrc/hopper_bwd.cuh) and the
share of the floor the kernel reaches. Needs one NVIDIA card; prints the
card's name and power limit first.

The sub-kernels (csrc/hopper_mlp.cuh, csrc/fused_vg.cu,
csrc/megakernel.cu): `prepare` runs `hop::fwd_kernel<0>` (K2, pass-1
sigma) and the torch middle; `main` runs `hop::fwd_kernel<2>` (forward
with the bf16 spill; `<1>` without, when no weight gradients are asked
for), `vg_composite`, `hop::chain_kernel<PG, DRAY>` (dh chain; PG:
weight-gradient sums and dh spill, DRAY: per-point dx),
`hop::wgrad_kernel` (weight-gradient GEMM), `reduce_rows` and `vg_dray`.
K3 runs `hop::fwd_kernel<0>`, `mk_middle`, `hop::fwd_kernel<1>` and
`mk_composite`; K4 K1's sequence with `mk_composite_bwd` in place of
`vg_composite`. K5 is `hop::fwd_kernel<3>` (csrc/fused_mlp.cu); K6 the
same sequence with a copy of the cotangent in place of the composite
(`fwd_kernel<2|1>`, `chain_kernel<PG, DX>`, `wgrad_kernel`, `reduce_rows`,
then a copy of dx).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12     # H100 SXM data sheet
NSPLIT_W, NSPLIT_O = 17, 13                 # csrc/hopper_bwd.cuh


def floors(points: int, pg: bool, dx: bool) -> dict:
    """{kernel: (floor ms, "bytes" | "operations")} of the dh chain and,
    with weight gradients, the weight-gradient GEMM, for `points` points
    (padded to 1024 as the kernels pad them). Per point the chain reads
    the 4 layers' ReLU bit masks (128 B), x4 and dhead (32 B) and writes,
    with weight gradients, dh0..dh3 in bf16 (2048 B) and the bf16(dhead)
    image (16 B), with dx its f32 dx (12 B); its products are 2 x (3 x
    256 x 256 + 256 x 128) FLOP. The GEMM reads emb, h0..h3 and dh0..dh3
    in bf16 and the image (4368 B), writes its split-K partials, and
    computes 2 x (128 x 256 + 3 x 256 x 256 + 256 x 4) FLOP a point."""
    ppad = (points + 1023) // 1024 * 1024

    def one(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES, flops / PEAK_BF16
        return (1e3 * max(tb, tf), "bytes" if tb >= tf else "operations")

    out = {"chain_kernel": one(
        ppad * (128 + 32 + (2048 + 16 if pg else 0) + (12 if dx else 0)),
        ppad * 2 * (3 * 256 * 256 + 256 * 128))}
    if pg:
        out["wgrad_kernel"] = one(
            ppad * 4368 + (NSPLIT_W * (3 * 256 * 256 + 128 * 256)
                           + NSPLIT_O * 256 * 4) * 4,
            ppad * 2 * (128 * 256 + 3 * 256 * 256 + 256 * 4))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    from chip_smoke import rays_batch
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    bound = torch.tensor([[-3.5, 3.5]] * 3, device=dev)
    cams = torch.tensor([[1.0, 0, 0, 0, 0, 0, 2.5]] * 6, device=dev)
    cams[:, 4] = torch.linspace(-0.3, 0.3, 6, device=dev)
    from pointnerf_slam_torch.ops import megakernel as MK

    def show(label, fn, floor=None):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(args.reps):
                fn()
            b.record()
            torch.cuda.synchronize()
        wall = a.elapsed_time(b) / args.reps
        rows = []
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if t > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
                rows.append((t / 1e3 / args.reps, ev.count // args.reps,
                             ev.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"\n{label}: {wall:.3f} ms per call (CUDA events), kernels "
              f"{busy:.3f} ms, device busy {100 * busy / wall:.1f}%")
        for ms, cnt, key in rows[:14]:
            note = ""
            for name, (fms, by) in (floor or {}).items():
                if name in key:
                    note = (f"  [floor {fms:.3f} ms by {by}, "
                            f"{100 * fms / ms:.1f}% of it]")
            print(f"  {ms:8.3f} ms  x{cnt:<3d} {key[:90]}{note}")

    variants = [
        ("mapper", 4998, dict(w_color=0.05, w_reg=0.0005, w_beyond=1.0,
                              with_ray_grads=True)),
        ("mapper", 4998, dict(w_color=0.05, w_reg=0.0005, w_beyond=1.0,
                              with_ray_grads=False)),
        ("tracker", 5000, dict(w_color=0.5, param_grads=False)),
    ]
    for mode, n, kw in variants:
        ro, rd, gt_d, gt_c = rays_batch(torch, gen, n, cams)
        ray_w = torch.ones(n, device=dev)
        t_reg = torch.rand(n, 32, generator=gen, device=dev)
        prep, main = F.make_fused_vg_split(RenderConfig(), mode, **kw)
        z2 = prep(dec, ro, rd, gt_d, bound)
        show(f"{mode} prepare (p1_sigma + torch middle)",
             lambda: prep(dec, ro, rd, gt_d, bound))
        pg = kw.get("param_grads", True)
        dx = kw.get("with_ray_grads", True)
        show(f"{mode} main (fused_vg, weight grads {pg}, ray grads {dx})",
             lambda: main(dec, ro, rd, gt_d, gt_c, ray_w, t_reg, z2, bound),
             floors(n * (44 + (32 if mode == "mapper" else 0)), pg, dx))
    pw = F.pack_weights({k: v.detach() for k, v in F.params_of(dec).items()})
    for n, with_reg, pg in ((5000, False, False), (4998, True, True)):
        ro, rd, gt_d, _ = rays_batch(torch, gen, n, cams)
        t_reg = torch.rand(n, 32, generator=gen, device=dev)
        shape = f"{n} x (32 + 12{' + 32' if with_reg else ''})"
        out = MK.k3_forward(pw, ro, rd, gt_d, t_reg, bound, 32, 12, with_reg)
        rays8, treg, b6, SRk = out[5]
        cot = (torch.randn(n, generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev),
               torch.randn(n, 3, generator=gen, device=dev),
               torch.randn(n, 32, generator=gen, device=dev))
        show(f"K3 ({shape})", lambda: MK.k3_forward(
            pw, ro, rd, gt_d, t_reg, bound, 32, 12, with_reg))
        show(f"K4 ({shape}, weight grads {pg})", lambda: MK.k4_backward(
            pw, rays8, treg, out[4], b6, *cot, 32, SRk, pg),
            floors(n * (44 + (32 if with_reg else 0)), pg, True))
    from chip_smoke import mesh_chunk, plain_mapper_points
    from pointnerf_slam_torch.ops import fused_mlp as M
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    grid = mesh_chunk(torch, dev)
    show("K5 (500,000 mesh-grid points)", lambda: M.k5_forward(params, grid))
    ro, rd, gt_d, gt_c = rays_batch(torch, gen, 4998, cams)
    _, x, _ = plain_mapper_points(
        torch, params, ro, rd, gt_d, gt_c, torch.ones(4998, device=dev),
        torch.rand(4998, 32, generator=gen, device=dev), bound)
    g = torch.randn(x.shape[0], 4, generator=gen, device=dev)
    for pg, xg in ((True, False), (False, True), (True, True)):
        show(f"K6 ({x.shape[0]} points, weight grads {pg}, dx {xg})",
             lambda: M.k6_backward(params, x, g, pg, xg),
             floors(x.shape[0], pg, xg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
