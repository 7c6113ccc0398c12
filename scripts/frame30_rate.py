#!/usr/bin/env python3
"""The rate of the degenerate frame-30 solve of the weak flagship over
front-end RANSAC seeds, in the system's own sequence of draws.

  python scripts/frame30_rate.py run --only jax|torch [--device cpu|cuda]
      [--cpu_draws] [--seeds 0-39] [--jobs 4] [--cache DIR] --out DIR
  python scripts/frame30_rate.py summary DIR [DIR ...]

`run` runs scripts/track_compare.py --config
configs/Synthetic/room_bench_weak.yaml --frames 31 --fe_seed S (its cut
budgets: 1000 tracking and mapping pixels, iters_first 300, the plain
renderer) for every seed S, one package per call, `--jobs` seeds at a
time, each on its own share of the host's cores, and writes each seed's
frame records to DIR/seed_S.json. The frames are ray-cast once into
--cache (track_compare --frame_cache; default output/frame_cache), which
every seed and both packages read.

`summary` reads such directories and prints, per seed, the bootstrap
frame and the frame-30 solve (its reference frame, matches, inliers and
candidates; degenerate: fewer than 8 candidates), then per directory the
degenerate rate with its 95% Clopper-Pearson interval, and the two-sided
Fisher exact test between every pair of directories.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/Synthetic/room_bench_weak.yaml"
FRAME = 30


def parse_seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def run(args) -> int:
    os.makedirs(args.out, exist_ok=True)
    cache = os.path.abspath(args.cache)
    cores = sorted(os.sched_getaffinity(0))
    share = max(len(cores) // args.jobs, 1)

    def one(k_seed):
        k, seed = k_seed
        path = os.path.join(args.out, f"seed_{seed}.json")
        if os.path.exists(path):
            return seed, 0, 0.0
        mine = set(cores[(k % args.jobs) * share:
                         (k % args.jobs) * share + share]) or set(cores)
        cmd = [sys.executable, os.path.join(REPO, "scripts",
                                            "track_compare.py"),
               "--config", CONFIG, "--frames", str(FRAME + 1),
               "--fe_seed", str(seed), "--only", args.only,
               "--device", args.device, "--frame_cache", cache,
               "--out", path]
        if args.cpu_draws:
            cmd.append("--cpu_draws")
        env = dict(os.environ, OMP_NUM_THREADS=str(share))
        t0 = time.time()
        res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                             text=True,
                             preexec_fn=lambda: os.sched_setaffinity(0,
                                                                     mine))
        dt = time.time() - t0
        if res.returncode:
            print(f"seed {seed}: exit {res.returncode}\n"
                  f"{res.stderr[-2000:]}", flush=True)
        else:
            print(f"seed {seed}: {dt:.0f} s", flush=True)
        return seed, res.returncode, dt

    seeds = parse_seeds(args.seeds)
    if args.jobs > 1 and not os.path.isdir(cache):
        one((0, seeds[0]))     # cast the frames once before the others
    with ThreadPoolExecutor(args.jobs) as pool:
        got = list(pool.map(one, enumerate(seeds)))
    return int(any(rc for _, rc, _ in got))


def classify(rec: dict) -> dict:
    """Bootstrap frame and the frame-30 solve of one seed's records."""
    boot = min((int(i) for i, r in rec.items() if r.get("bootstrap")),
               default=None)
    r = rec.get(str(FRAME), {})
    out = {"bootstrap": boot, "ref": r.get("ref_idx"),
           "matches": r.get("n_matches"), "inliers": r.get("n_inliers"),
           "cand": r.get("n_cand"), "rejected": bool(r.get("rejected")),
           "t_err_mm": r.get("t_err_mm")}
    out["solved"] = out["cand"] is not None
    out["degenerate"] = out["solved"] and out["cand"] < 8
    return out


def interval(k: int, n: int):
    """95% Clopper-Pearson interval of k successes in n."""
    from scipy.stats import beta
    lo = 0.0 if k == 0 else float(beta.ppf(0.025, k, n - k + 1))
    hi = 1.0 if k == n else float(beta.ppf(0.975, k + 1, n - k))
    return lo, hi


def summary(dirs) -> int:
    from scipy.stats import fisher_exact
    rates = {}
    for d in dirs:
        rows = {}
        for name in os.listdir(d):
            if name.startswith("seed_") and name.endswith(".json"):
                with open(os.path.join(d, name)) as fh:
                    res = json.load(fh)
                pkg = "jax" if res.get("jax") else "torch"
                rows[int(name[5:-5])] = classify(res[pkg])
        print(f"{d}: seed | bootstrap | frame-30 solve ref -> 30: matches /"
              f" inliers / candidates | degenerate | t err mm at 30")
        for s in sorted(rows):
            r = rows[s]
            te = "-" if r["t_err_mm"] is None else f"{r['t_err_mm']:.2f}"
            print(f"  {s} | {r['bootstrap']} | {r['ref']} -> {FRAME}: "
                  f"{r['matches']} / {r['inliers']} / {r['cand']}"
                  f"{' (rejected)' if r['rejected'] else ''} | "
                  f"{'yes' if r['degenerate'] else 'no'} | {te}")
        n = sum(r["solved"] for r in rows.values())
        k = sum(r["degenerate"] for r in rows.values())
        lo, hi = interval(k, n) if n else (float("nan"),) * 2
        boots = {}
        for r in rows.values():
            boots[r["bootstrap"]] = boots.get(r["bootstrap"], 0) + 1
        rates[d] = (k, n)
        print(f"{d}: degenerate frame-30 solve {k} of {n} seeds that solved "
              f"frame 30 ({len(rows)} seeds run) = {k / max(n, 1):.3f}, 95% "
              f"interval [{lo:.3f}, {hi:.3f}]; bootstrap frames "
              f"{dict(sorted(boots.items(), key=str))}")
    names = list(rates)
    for a in range(len(names)):
        for b in range(a + 1, len(names)):
            (ka, na), (kb, nb) = rates[names[a]], rates[names[b]]
            _, p = fisher_exact([[ka, na - ka], [kb, nb - kb]])
            print(f"Fisher exact, two-sided: {names[a]} {ka}/{na} against "
                  f"{names[b]} {kb}/{nb}: p = {p:.4f}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--only", choices=("jax", "torch"), required=True)
    r.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    r.add_argument("--cpu_draws", action="store_true")
    r.add_argument("--seeds", default="0-39")
    r.add_argument("--jobs", type=int, default=4)
    r.add_argument("--cache", default=os.path.join(REPO, "output",
                                                   "frame_cache"))
    r.add_argument("--out", required=True)
    s = sub.add_parser("summary")
    s.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    return run(args) if args.cmd == "run" else summary(args.dirs)


if __name__ == "__main__":
    raise SystemExit(main())
