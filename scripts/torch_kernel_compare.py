#!/usr/bin/env python3
"""K1 (fused_vg), K2 (p1_sigma), K3/K4 (megakernel), K5/K6 (fused_mlp)
and the engine iterations of this tree against another version of the
port, timed in turns on one card.

  python3 scripts/torch_kernel_compare.py --other DIR [--reps 10]
      [--engine-reps 3]

--engine-reps 0 leaves the engine iterations out.

DIR is the root of another checkout of the repository (e.g. `git archive
<commit> | tar -x -C DIR` under a git-ignored directory).

Kernels: the other version's `pointnerf_slam_torch/ops/csrc/fused_vg.cu`,
`p1_sigma.cu`, `megakernel.cu` and `fused_mlp.cu` (with the headers they
include) are built with this tree's nvcc flags (`ops/build.py`) into
`build/torch_kernels_other/` and called through this tree's launch
helpers (`ops/fused_vg.py` `vg_launch`, `p1_launch`, `ops/megakernel.py`
`k3_launch`, `k4_launch`, `ops/fused_mlp.py` `k5_launch`, `k6_launch`),
so they must keep the C interface of `fused_vg` /
`fused_vg_workspace_bytes` / `p1_sigma` / `mk_forward` / `mk_backward` /
`mlp_fwd` / `mlp_bwd` / `mlp_bwd_workspace_bytes` and their workspace
sizes (a version that reads fewer weight pointers, as the retired WMMA
K5/K6, ignores the trailing ones). At the main path's shapes
(random decoder, seed 0, rays of six cameras at 680x1200 as in
chip_smoke.py): mapper 4998 rays x (44 + 32) points, colour, w_beyond 1,
without and with ray gradients; tracker 5000 x 44, ray gradients only;
p1 4998 x 32; K3 and K4 at the tracker shape (5000 rays, 32 + 12, no
regulation, K4 without weight gradients, as the handle_dynamic tracker
launches them) and the mapper shape (4998 rays, 32 + 12 + 32 regulation
samples, K4 with weight gradients; K4 of both versions at this tree's K3
samples z2 and one set of random cotangents); K5 at a 500,000-point
chunk of room_bench's mesh grid and at the mapper's plain-path points
(4998 rays x (32 + 44 + 32) = 539,784), K6 at the 379,848 its loss
reaches with a random cotangent, with weight gradients only, dx only and
both. Each launch is timed alone (its buffers prepared before each of
the four timings and freed after it, so the wrapper's host work is not in
it and both versions read the same addresses: the caching allocator hands
back the blocks just freed) with CUDA events, median of --reps calls, in
the order other, this, this, other.

Engine: in a process of its own per tree, in the order other, this, this,
other, with the tree's own modules: `chip_smoke.bench_engine` (tracker 50
iterations at K=5, fused-outer mapper 3 x 100 at K=4), the bench tracker
with tracking.handle_dynamic on (50 iterations of K3/K4), the mapper's
two-kernel branch (40 + 24 samples, w_beyond_loss 0, 20 iterations of
K3/K4 with weight gradients) and the bench workload on the plain branch
(`rendering.megakernel: off`) with MLPConfig(fused=True) (K5/K6: 2 / 1
launches per tracker iteration, 3 / 2 per mapper iteration), each as host
wall time with a sync at the
end, as chip_smoke's engine phases read them; each process warms up once,
runs --engine-reps times and then the bench workload once more under
cProfile, whose top host functions (by own time) it prints.

Small batches: at 1 and 7 rays (24 + 8 and 32 + 12 + 32 samples), K4's ray
gradients of a loss linear in K3's outputs (fixed random cotangents, K4
of both versions at this tree's z2, no weight gradients) against the plain
version (`render_at` by autograd: float32 cotangents) and against the
plain version with K6's bf16-rounded cotangents (`fused_mlp_reference` as
its decoder), by cosine and norm ratio: what the TPU kernel's numerics do
to a gradient that is summed over a handful of rays.

Prints the card's name and power limit first, then one line per case and
a JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


KERNELS = ("fused_vg", "p1_sigma", "megakernel", "fused_mlp")


def build_other(src_dir: str) -> dict:
    """Compile the other version's KERNELS sources; returns {name: ctypes
    library}."""
    from pointnerf_slam_torch.ops import build
    out = os.path.join(ROOT, "build", "torch_kernels_other")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in KERNELS:
        so = os.path.join(out, f"lib{name}.so")
        cmd = [build._nvcc()] + build.NVCC_FLAGS + [
            "-o", so, os.path.join(src_dir, f"{name}.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu (other) failed:\n{log}")
        libs[name] = ctypes.CDLL(so)
        libs[name].kernel_error_string.restype = ctypes.c_char_p
        libs[name].kernel_error_string.argtypes = [ctypes.c_int]
    return libs


def compare_kernels(torch, other_libs: dict, reps: int) -> list:
    from chip_smoke import (VG_VARIANTS, mesh_chunk, plain_mapper_points,
                            rays_batch, timed)
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.ops import build
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.render.renderer import RenderConfig
    from pointnerf_slam_torch.ops import fused_mlp as M
    from pointnerf_slam_torch.ops import megakernel as MK
    build.build_all(KERNELS)
    libs = {"this": {k: build.load(k) for k in KERNELS},
            "other": other_libs}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    bound = torch.tensor([[-3.5, 3.5]] * 3, device=dev)
    cams = torch.tensor([[1.0, 0, 0, 0, 0, 0, 2.5]] * 6, device=dev)
    cams[:, 4] = torch.linspace(-0.3, 0.3, 6, device=dev)
    # (label, library, make(lib) -> a launch on buffers of its own)
    cases = []
    ro, rd, gt_d, _ = rays_batch(torch, gen, 4998, cams)
    rays = F._pack_rays(ro, rd, gt_d, bound)
    pw = F.pack_weights(params)
    cases.append(("p1_sigma (4998 x 32)", "p1_sigma",
                  lambda lib: F.p1_launch(lib, pw, rays, bound, 32)[0]))
    for name, mode, kw, _ in VG_VARIANTS:
        n = 4998 if mode == "mapper" else 5000
        ro, rd, gt_d, gt_c = rays_batch(torch, gen, n, cams)
        ray_w = torch.ones(n, device=dev)
        t_reg = torch.rand(n, 32, generator=gen, device=dev)
        prep, main_ = F.make_fused_vg_split(RenderConfig(), mode, **kw)
        z2 = prep(dec, ro, rd, gt_d, bound)
        spec = main_.spec
        label = (f"{name} ({n} x {44 + (32 if spec.with_reg else 0)}, ray "
                 f"grads {spec.with_ray_grads}, weight grads "
                 f"{spec.param_grads})")
        args = (spec, params, ro, rd, gt_d, gt_c, ray_w, t_reg, z2, bound)
        cases.append((label, "fused_vg",
                      lambda lib, a=args: F.vg_launch(lib, *a)[0]))
    for n, with_reg, pg in ((5000, False, False), (4998, True, True)):
        ro, rd, gt_d, _ = rays_batch(torch, gen, n, cams)
        t_reg = torch.rand(n, 32, generator=gen, device=dev)
        shape = f"{n} x (32 + 12{' + 32' if with_reg else ''})"
        args = (pw, ro, rd, gt_d, t_reg, bound, 32, 12, with_reg)
        cases.append((f"K3 ({shape})", "megakernel",
                      lambda lib, a=args: MK.k3_launch(lib, *a)[0]))
        launch, (_, _, z2, (rays8, treg, b6, SRk), _) = MK.k3_launch(
            libs["this"]["megakernel"], *args)
        launch()
        cot = (torch.randn(n, generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev),
               torch.randn(n, 3, generator=gen, device=dev),
               torch.randn(n, 32, generator=gen, device=dev))
        args = (pw, rays8, treg, z2, b6, *cot, 32, SRk, pg)
        cases.append((f"K4 ({shape}, weight grads {pg})", "megakernel",
                      lambda lib, a=args: MK.k4_launch(lib, *a)[0]))
    ro, rd, gt_d, gt_c = rays_batch(torch, gen, 4998, cams)
    x_all, x_live, _ = plain_mapper_points(
        torch, params, ro, rd, gt_d, gt_c, torch.ones(4998, device=dev),
        torch.rand(4998, 32, generator=gen, device=dev), bound)
    for label, x in (("K5 (500,000 mesh-grid points)",
                      mesh_chunk(torch, dev)),
                     (f"K5 ({x_all.shape[0]} mapper plain-path points)",
                      x_all)):
        cases.append((label, "fused_mlp",
                      lambda lib, x=x: M.k5_launch(lib, pw, x)[0]))
    g = torch.randn(x_live.shape[0], 4, generator=gen, device=dev)
    for pg, xg, what in ((True, False, "weight grads only"),
                         (False, True, "dx only"), (True, True, "both")):
        cases.append((f"K6 ({x_live.shape[0]} points, {what})", "fused_mlp",
                      lambda lib, f=(pg, xg): M.k6_launch(lib, pw, x_live, g,
                                                          *f)[0]))
    out = []
    for label, name, make in cases:
        ms = {}
        for v in ("other", "this", "this", "other"):
            ms.setdefault(v, []).append(timed(make(libs[v][name]), reps))
        o, t = min(ms["other"]), min(ms["this"])
        print(f"{label}: other {ms['other'][0]:.4f} / {ms['other'][1]:.4f} "
              f"ms, this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms; "
              f"other / this (best of each) {o / t:.2f}x", flush=True)
        out.append(dict(case=label, other_ms=ms["other"], this_ms=ms["this"],
                        speedup=o / t))
    return out


def two_kernel_ms(torch, S) -> tuple:
    """ms per iteration of the tree's two-kernel paths (its own modules and
    chip_smoke.bench_data / bench_ecfg): the bench tracker with
    handle_dynamic on (50 iterations) and the mapper at 40 + 24 samples
    with w_beyond_loss 0 (20 iterations)."""
    import time
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.engine.tracker import make_tracking_step
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dev = torch.device("cuda")
    d = S.bench_data(torch)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    track = make_tracking_step(MLPConfig(), RenderConfig(), S.bench_ecfg(
        handle_dynamic=True))
    cam0 = torch.tensor([1.0, 0, 0, 0, 0.02, 0, 2.5], device=dev)
    draws = Draws(torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    t0 = time.time()
    track(dec, cam0, d["color"], d["depth"], d["bound"], draws)
    torch.cuda.synchronize()
    t_ms = (time.time() - t0) * 1e3 / 50
    mapper = make_mapper_step(MLPConfig(), RenderConfig(N_samples=40,
                                                        N_importance=24),
                              S.bench_ecfg(w_beyond_loss=0.0), 6)
    draws = Draws(torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    t0 = time.time()
    mapper(dec, d["colors"][0], d["depths"][0], d["cams"][0], d["valid"][0],
           d["ba"][0], d["bound"], draws, 20)
    torch.cuda.synchronize()
    return t_ms, (time.time() - t0) * 1e3 / 20


def small_n_grads(torch, other_libs: dict) -> list:
    """K4's ray gradients at 1 and 7 rays, this tree's and the other's
    against the plain version with float32 and with bf16 cotangents."""
    from chip_smoke import cos_ratio, rays_batch
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.ops import build
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.ops import megakernel as MK
    from pointnerf_slam_torch.ops.fused_mlp import fused_mlp_reference
    libs = {"this": build.load("megakernel"),
            "other": other_libs["megakernel"]}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    pw = F.pack_weights(params)
    bound = torch.tensor([[-3.5, 3.5]] * 3, device=dev)
    cams = torch.tensor([[1.0, 0, 0, 0, 0, 0, 2.5]] * 6, device=dev)
    out = []
    for n in (1, 7):
        for S1, SI, with_reg in ((24, 8, False), (32, 12, True)):
            ro, rd, gt_d, _ = rays_batch(torch, gen, n, cams)
            t_reg = torch.rand(n, S1, generator=gen, device=dev)
            launch, (_, _, z2, (rays8, treg, b6, SRk), _) = MK.k3_launch(
                libs["this"], pw, ro, rd, gt_d, t_reg, bound, S1, SI,
                with_reg)
            launch()
            cot = [torch.randn(n, generator=gen, device=dev),
                   torch.randn(n, generator=gen, device=dev),
                   torch.randn(n, 3, generator=gen, device=dev),
                   torch.randn(n, S1, generator=gen, device=dev)
                   * float(with_reg)]
            got = {}
            for v, lib in libs.items():
                run, (dray, _) = MK.k4_launch(lib, pw, rays8, treg, z2, b6,
                                              *cot, S1, SRk, False)
                run()
                got[v] = dray[:, :6].clone()
            apply = MK.mlp_apply
            for v, dec_fn in (("plain", apply), ("plain bf16 cot", lambda p, x,
                              bf16=True: fused_mlp_reference(p, x))):
                o_ = ro.clone().requires_grad_(True)
                d_ = rd.clone().requires_grad_(True)
                MK.mlp_apply = dec_fn      # render_at's decoder, this case
                try:
                    outs = MK.render_at(params, o_, d_, gt_d, t_reg, bound,
                                        z2, with_reg)
                finally:
                    MK.mlp_apply = apply
                lin = sum((o * c).sum() for o, c in zip(outs, cot))
                got[v] = torch.cat(torch.autograd.grad(lin, [o_, d_]), 1)
            row = dict(case=f"{n} rays, {S1} + {SI}"
                       f"{f' + {S1}' if with_reg else ''}")
            for v, ref in (("this", "plain"), ("other", "plain"),
                           ("plain bf16 cot", "plain"),
                           ("this", "plain bf16 cot")):
                for k, nm in ((slice(0, 3), "rays_o"), (slice(3, 6),
                                                        "rays_d")):
                    row[f"{v} vs {ref} {nm}"] = cos_ratio(got[v][:, k],
                                                          got[ref][:, k])
            row["this - other max abs"] = float(
                (got["this"] - got["other"]).abs().max())
            print("small batch: " + ", ".join(
                f"{k} {v}" if isinstance(v, str) else
                f"{k} {v:.3e}" if isinstance(v, float) else
                f"{k} cos {v[0]:.7f} ratio {v[1]:.5f}"
                for k, v in row.items()), flush=True)
            out.append(row)
    return out


def plain_ms(torch, S, iters=(50, 100)) -> tuple:
    """ms per tracker and mapper iteration of the tree's plain branch with
    the fused decoder (K5/K6), through its chip_smoke.bench_engine."""
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    mcfg = MLPConfig(fused=True)
    dec = IMAPDecoder(mcfg, torch.Generator().manual_seed(0)).to("cuda")
    return S.bench_engine(torch, dec, *iters, mcfg, "off")[:2]


def engine_child(root: str, reps: int) -> int:
    """One tree's engine iterations: warm-up, `reps` timed runs, one run
    of the bench workload under cProfile. Prints the profile, then a JSON
    line last."""
    import cProfile
    import io
    import pstats
    sys.path.insert(0, root)
    import torch
    import chip_smoke as S
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(
        "cuda")
    S.bench_engine(torch, dec, 5, 4)
    two_kernel_ms(torch, S)
    plain_ms(torch, S, (5, 4))
    runs = [S.bench_engine(torch, dec)[:2] + two_kernel_ms(torch, S)
            + plain_ms(torch, S) for _ in range(reps)]
    prof = cProfile.Profile()
    prof.enable()
    S.bench_engine(torch, dec)
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(18)
    print(buf.getvalue())
    print(json.dumps({"root": root, "tracker_ms": [r[0] for r in runs],
                      "mapper_ms": [r[1] for r in runs],
                      "dynamic_tracker_ms": [r[2] for r in runs],
                      "mapper_two_kernel_ms": [r[3] for r in runs],
                      "plain_tracker_ms": [r[4] for r in runs],
                      "plain_mapper_ms": [r[5] for r in runs]}))
    return 0


def compare_engine(other_root: str, reps: int) -> list:
    roots = {"other": other_root, "this": ROOT}
    ms = {}
    for v in ("other", "this", "this", "other"):
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--engine-child",
             roots[v], "--engine-reps", str(reps)], capture_output=True,
            text=True, timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"engine ({v}) failed:\n{p.stdout}\n"
                               f"{p.stderr}")
        lines = p.stdout.strip().splitlines()
        r = json.loads(lines[-1])
        print(f"engine ({v}): tracker {r['tracker_ms']} ms/iter, mapper "
              f"{r['mapper_ms']} ms/iter, handle_dynamic tracker "
              f"{r['dynamic_tracker_ms']} ms/iter, mapper two-kernel "
              f"{r['mapper_two_kernel_ms']} ms/iter, plain branch on K5/K6 "
              f"tracker {r['plain_tracker_ms']} / mapper "
              f"{r['plain_mapper_ms']} ms/iter; host profile "
              f"(cProfile, one run):", flush=True)
        print("\n".join(lines[:-1]), flush=True)
        ms.setdefault(v, []).append(r)
    out = []
    for key in ("tracker_ms", "mapper_ms", "dynamic_tracker_ms",
                "mapper_two_kernel_ms", "plain_tracker_ms",
                "plain_mapper_ms"):
        o = [x for r in ms["other"] for x in r[key]]
        t = [x for r in ms["this"] for x in r[key]]
        print(f"engine {key[:-3]}: other {sorted(o)} ms/iter, this "
              f"{sorted(t)} ms/iter; other / this (best of each) "
              f"{min(o) / min(t):.2f}x", flush=True)
        out.append(dict(case=f"engine {key[:-3]} ms/iter", other_ms=o,
                        this_ms=t, speedup=min(o) / min(t)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--engine-reps", type=int, default=3)
    ap.add_argument("--engine-child")
    args = ap.parse_args()
    if args.engine_child:
        return engine_child(os.path.abspath(args.engine_child),
                            args.engine_reps)
    if not args.other:
        ap.error("--other DIR is required")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    other = os.path.abspath(args.other)
    other_libs = build_other(os.path.join(other, "pointnerf_slam_torch",
                                          "ops", "csrc"))
    cases = compare_kernels(torch, other_libs, args.reps)
    small = small_n_grads(torch, other_libs)
    if args.engine_reps > 0:
        cases += compare_engine(other, args.engine_reps)
    print(json.dumps({"card": smi, "reps": args.reps, "cases": cases,
                      "small_batches": small}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
