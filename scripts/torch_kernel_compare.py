#!/usr/bin/env python3
"""K1 (fused_vg), K2 (p1_sigma) and the engine iteration of this tree
against another version of the port, timed in turns on one card.

  python3 scripts/torch_kernel_compare.py --other DIR [--reps 10]
      [--engine-reps 3]

DIR is the root of another checkout of the repository (e.g. `git archive
<commit> | tar -x -C DIR` under a git-ignored directory).

Kernels: the other version's `pointnerf_slam_torch/ops/csrc/fused_vg.cu`
and `p1_sigma.cu` are built with this tree's nvcc flags (`ops/build.py`)
into `build/torch_kernels_other/` and called through this tree's launch
helpers (`ops/fused_vg.py` `vg_launch`, `p1_launch`), so they must keep the
C interface of `fused_vg` / `fused_vg_workspace_bytes` / `p1_sigma` (a
version that reads fewer weight pointers ignores the trailing ones). At the
main path's shapes (random decoder, seed 0, rays of six cameras at
680x1200 as in chip_smoke.py): mapper 4998 rays x (44 + 32) points,
colour, w_beyond 1, without and with ray gradients; tracker 5000 x 44, ray
gradients only; p1 4998 x 32. Each launch is timed alone (buffers prepared
once, so the wrapper's host work is not in it) with CUDA events, median of
--reps calls, in the order other, this, this, other.

Engine: each tree's own `chip_smoke.bench_engine` (tracker 50 iterations
at K=5, fused-outer mapper 3 x 100 at K=4; host wall time with a sync at
the end, as chip_smoke's engine phase reads it) in a process of its own,
in the order other, this, this, other; each process warms up once, runs
--engine-reps times and then once more under cProfile, whose top host
functions (by own time) it prints.

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


def build_other(src_dir: str) -> dict:
    """Compile the other version's fused_vg.cu and p1_sigma.cu; returns
    {name: ctypes library}."""
    from pointnerf_slam_torch.ops import build
    out = os.path.join(ROOT, "build", "torch_kernels_other")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in ("fused_vg", "p1_sigma"):
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


def compare_kernels(torch, other_root: str, reps: int) -> list:
    from chip_smoke import VG_VARIANTS, rays_batch, timed
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    from pointnerf_slam_torch.ops import build
    from pointnerf_slam_torch.ops import fused_vg as F
    from pointnerf_slam_torch.render.renderer import RenderConfig
    build.build_all(["p1_sigma", "fused_vg"])
    libs = {"this": {k: build.load(k) for k in ("fused_vg", "p1_sigma")},
            "other": build_other(os.path.join(
                other_root, "pointnerf_slam_torch", "ops", "csrc"))}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0)).to(dev)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    bound = torch.tensor([[-3.5, 3.5]] * 3, device=dev)
    cams = torch.tensor([[1.0, 0, 0, 0, 0, 0, 2.5]] * 6, device=dev)
    cams[:, 4] = torch.linspace(-0.3, 0.3, 6, device=dev)
    cases = []
    ro, rd, gt_d, _ = rays_batch(torch, gen, 4998, cams)
    rays = F._pack_rays(ro, rd, gt_d, bound)
    pw = F.pack_weights(params)
    cases.append(("p1_sigma (4998 x 32)", {
        v: F.p1_launch(libs[v]["p1_sigma"], pw, rays, bound, 32)[0]
        for v in libs}))
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
        cases.append((label, {v: F.vg_launch(
            libs[v]["fused_vg"], spec, params, ro, rd, gt_d, gt_c, ray_w,
            t_reg, z2, bound)[0] for v in libs}))
    out = []
    for label, fns in cases:
        ms = {}
        for v in ("other", "this", "this", "other"):
            ms.setdefault(v, []).append(timed(fns[v], reps))
        o, t = min(ms["other"]), min(ms["this"])
        print(f"{label}: other {ms['other'][0]:.4f} / {ms['other'][1]:.4f} "
              f"ms, this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms; "
              f"other / this (best of each) {o / t:.2f}x", flush=True)
        out.append(dict(case=label, other_ms=ms["other"], this_ms=ms["this"],
                        speedup=o / t))
    return out


def engine_child(root: str, reps: int) -> int:
    """One tree's engine iteration: warm-up, `reps` timed runs, one run
    under cProfile. Prints the profile, then a JSON line last."""
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
    runs = [S.bench_engine(torch, dec)[:2] for _ in range(reps)]
    prof = cProfile.Profile()
    prof.enable()
    S.bench_engine(torch, dec)
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(18)
    print(buf.getvalue())
    print(json.dumps({"root": root, "tracker_ms": [r[0] for r in runs],
                      "mapper_ms": [r[1] for r in runs]}))
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
              f"{r['mapper_ms']} ms/iter; host profile (cProfile, one run):",
              flush=True)
        print("\n".join(lines[:-1]), flush=True)
        ms.setdefault(v, []).append(r)
    out = []
    for key in ("tracker_ms", "mapper_ms"):
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
    cases = compare_kernels(torch, other, args.reps)
    cases += compare_engine(other, args.engine_reps)
    print(json.dumps({"card": smi, "reps": args.reps, "cases": cases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
