#!/usr/bin/env python3
"""Render a synthetic config's frames into its on-disk frame cache
(data.frame_cache_dir) ahead of a run, with the port's reader and one
process per core.

  python scripts/prewarm_synth_cache_torch.py <config> [--frames N]
      [--workers W]

The analytic ray cast is host numpy, ~1-2 s a frame at 680x1200; a run
that finds its frames cached reads them instead. The cache's files and
key are the JAX reference's, so either package's runs read them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import multiprocessing

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pointnerf_slam_torch.io.config import load_config  # noqa: E402
from pointnerf_slam_torch.io.datasets import get_dataset  # noqa: E402

_DS = None


def _init(path):
    global _DS
    _DS = get_dataset(load_config(path))


def _render(i):
    _DS[i]
    return i


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--workers", type=int,
                    default=len(os.sched_getaffinity(0)))
    args = ap.parse_args()
    cfg = load_config(args.config)
    if not cfg["data"].get("frame_cache_dir"):
        raise SystemExit("the config sets no data.frame_cache_dir")
    n = len(get_dataset(cfg))
    n = min(n, args.frames) if args.frames else n
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers, initializer=_init,
                  initargs=(args.config,)) as pool:
        for k, _ in enumerate(pool.imap_unordered(_render, range(n)), 1):
            if k % 50 == 0 or k == n:
                print(f"prewarm: {k}/{n} frames in {time.time() - t0:.0f} s",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
