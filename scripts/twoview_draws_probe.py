#!/usr/bin/env python3
"""How often a two-view solve of one frame pair degenerates, over RANSAC
seeds, in either package.

  python scripts/twoview_draws_probe.py [--ref 15] [--cur 30] [--seeds 40]
      [--package torch|jax] [--device cuda|cpu] [--cpu_draws]
      [--bootstrap [--superpoint NPZ] [--first_seed S]]

For each seed, a fresh front-end of configs/Synthetic/room_bench_weak.yaml
(the port's on --device, or the JAX reference's on the CPU) extracts the
Harris features of the two frames and runs its continuous two-view solve
(the reference frame's gt pose as Tcw_ref, its RANSAC generator seeded
with the seed: a torch generator for the port, PRNGKey(seed) for the
reference). Prints each solve's matches, inliers, candidates
(triangulations that pass the point checks) and median parallax, and the
count of degenerate solves (fewer than 8 candidates). --cpu_draws draws
the port's hypotheses from a CPU generator on either device, so a card
run and a CPU run solve from the same hypotheses seed by seed.

--bootstrap probes the bootstrap instead: for each seed a fresh front-end
tries it against frame 0 at frames 5, 10, 15 and 20 in turn, as the
system does (chip_smoke.sp_decisions), and stops at the first that
passes; prints each attempt's decision with its solve's matches /
inliers / candidates / median parallax in degrees, the bootstrap pose's
translation error against gt, and how many seeds bootstrap by frame 20.
--superpoint NPZ sets superpoint_weights (the SuperPoint front-end); each
frame is extracted once for all seeds.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def solver(package: str, device: str, cpu_draws: bool = False):
    """(make(seed) -> front-end, nerf_c2w_to_cv_w2c, load_config,
    get_dataset) of one package."""
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from pointnerf_slam_tpu.frontend.frontend import (
            SparseFrontend, nerf_c2w_to_cv_w2c)
        from pointnerf_slam_tpu.io.config import load_config
        from pointnerf_slam_tpu.io.datasets import get_dataset

        def make(cfg, c, seed):
            return SparseFrontend(cfg, c["H"], c["W"], c["fx"], c["fy"],
                                  c["cx"], c["cy"],
                                  key=jax.random.PRNGKey(seed))
    else:
        import torch
        from pointnerf_slam_torch.engine.state import Draws
        from pointnerf_slam_torch.frontend.frontend import (
            SparseFrontend, nerf_c2w_to_cv_w2c)
        from pointnerf_slam_torch.io.config import load_config
        from pointnerf_slam_torch.io.datasets import get_dataset

        if cpu_draws:
            from pointnerf_slam_torch.frontend import fused_twoview as T
            draw = T.draw_hypotheses
            T.draw_hypotheses = lambda g, mv: draw(g, mv.cpu()).to(mv.device)

        def make(cfg, c, seed):
            return SparseFrontend(
                cfg, c["H"], c["W"], c["fx"], c["fy"], c["cx"], c["cy"],
                device=device, draws=Draws(torch.Generator(
                    device="cpu" if cpu_draws else device).manual_seed(seed)))
    return make, nerf_c2w_to_cv_w2c, load_config, get_dataset


def capture_solves(fe, solves):
    """Append every two-view solve's result of `fe` to `solves`."""
    runner_for = fe._runner_for

    def wrapped_runner_for(*a, **k):
        rn = runner_for(*a, **k)
        if not getattr(rn, "captured", False):
            run = rn.run

            def wrapped_run(*a2, **k2):
                solves.append(run(*a2, **k2))
                return solves[-1]
            rn.run, rn.captured = wrapped_run, True
        return rn
    fe._runner_for = wrapped_runner_for


def stats(r) -> str:
    """[matches / inliers / candidates / median parallax deg] of a solve."""
    return (f"[{int(r['n_matches'])} / {int(r['n_inliers'])} / "
            f"{int(r['n_cand'])} / {float(r['parallax']):.3f}]")


def probe_bootstrap(args, make, load_config, get_dataset) -> int:
    import numpy as np
    import chip_smoke as S
    cfg = load_config("configs/Synthetic/room_bench_weak.yaml")
    if args.superpoint:
        cfg["superpoint_weights"] = args.superpoint
    reader = get_dataset(cfg)
    frames = {i: reader[i] for i in (0,) + tuple(S.SP_DECISIONS)}
    seen, rows = {}, []
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        fe = make(cfg, cfg["cam"], seed)
        name = type(fe.extractor).__name__
        fe.extractor = S.SpMemo(fe.extractor, seen)
        solves = []
        capture_solves(fe, solves)
        got, why = S.sp_decisions(fe, frames)
        said = [f"{i} refused ({why[i]}) {stats(r)}" if d == "refused" else
                f"{i} bootstrapped {stats(r)}, t err {why[i] * 1000:.2f} mm"
                for (i, d), r in zip(got.items(), solves)]
        boot = [i for i, d in got.items() if d == "bootstrapped"]
        rows.append((seed, boot[0], why[boot[0]]) if boot else
                    (seed, None, None))
        print(f"seed {seed}: " + "; ".join(said), flush=True)
    ok = [r for r in rows if r[1] is not None]
    errs = [r[2] * 1000 for r in ok]
    dev = "cpu" if args.package == "jax" else args.device
    print(f"{args.package} on {dev}, {name}"
          f"{' (hypotheses from a CPU generator)' if args.cpu_draws else ''}"
          f": {len(ok)} of {len(rows)} seeds bootstrap by frame "
          f"{max(S.SP_DECISIONS)}: {[(r[0], r[1]) for r in ok]}; t err mm "
          + (f"median {np.median(errs):.2f}, max {max(errs):.2f}"
             if errs else "-"))
    return 0


def main() -> int:
    import numpy as np
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", type=int, default=15)
    ap.add_argument("--cur", type=int, default=30)
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--package", default="torch", choices=("torch", "jax"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cpu_draws", action="store_true")
    ap.add_argument("--bootstrap", action="store_true")
    ap.add_argument("--superpoint", default=None)
    ap.add_argument("--first_seed", type=int, default=0)
    args = ap.parse_args()
    make, to_cv, load_config, get_dataset = solver(args.package, args.device,
                                                   args.cpu_draws)
    if args.bootstrap:
        return probe_bootstrap(args, make, load_config, get_dataset)
    cfg = load_config("configs/Synthetic/room_bench_weak.yaml")
    reader = get_dataset(cfg)
    c = cfg["cam"]
    _, color_r, depth_r, gt_r = reader[args.ref]
    _, color_c, _, _ = reader[args.cur]
    z = np.sort(np.asarray(depth_r).reshape(-1))
    rows = []
    for seed in range(args.seeds):
        fe = make(cfg, c, seed)
        fe.median_gt_depth = float(z[(len(z) - 1) // 2])
        r = fe._two_view(fe._extract(color_r), fe._extract(color_c),
                         to_cv(gt_r), set_scale=False, scale_prior=0.1)
        rows.append((seed, int(r["n_matches"]), int(r["n_inliers"]),
                     int(r["n_cand"]), float(r["parallax"])))
        print(f"seed {seed}: matches {rows[-1][1]}, inliers {rows[-1][2]}, "
              f"candidates {rows[-1][3]}, parallax {rows[-1][4]:.3f} deg",
              flush=True)
    bad = [r[0] for r in rows if r[3] < 8]
    dev = "cpu" if args.package == "jax" else args.device
    print(f"{args.package} on {dev}"
          f"{' (hypotheses from a CPU generator)' if args.cpu_draws else ''}"
          f", frames {args.ref} -> {args.cur}: "
          f"{len(bad)} of {len(rows)} solves degenerate (< 8 candidates): "
          f"seeds {bad}; inliers median "
          f"{np.median([r[2] for r in rows]):.0f}, candidates median "
          f"{np.median([r[3] for r in rows]):.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
