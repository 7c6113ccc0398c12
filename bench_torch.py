#!/usr/bin/env python3
"""Benchmark: Replica-room0-scale tracking+mapping throughput of the
PyTorch/CUDA port on one NVIDIA card.

  python3 bench_torch.py

Prints ONE JSON line last: {"metric", "value", "unit", "vs_baseline"}, with
bench.py's metric name, unit and baseline.

Workload = bench.py's, the reference's pointNeRF/iMAP* per-cycle budget on
680x1200 frames (configs/pointNeRF_slam.yaml:58-59,87-89 of the
reference): every 5 frames, 50 tracking Adam iterations (5000 rays) and
3 x 100 mapping iterations (5000 rays over a 6-frame window), 32
stratified + 12 importance samples, 256-hidden 4-block MLP, plus
free-space regulation; one pixel batch and importance z per 5 tracker and
per 4 mapper iterations, the fused outer loop, BA off (no_ba_fast). The
steps are the port's engine (engine/tracker.py, engine/mapper.py), which
dispatches this shape to the fused value-and-grad kernels K1/K2. One
warm-up cycle, then 3 timed cycles from the initial decoder, each ending
in a host read of its last loss; fps = 15 frames / their wall time.

Baseline: the reference publishes no numbers (BASELINE.md). bench.py uses
the NICE-SLAM paper's published iMAP* per-iteration timings on the
authors' GPU (tracking 32.3 ms/iter, mapping 44.9 ms/iter;
arXiv:2112.12130 Table 6 - same codebase the reference forked), giving per
5-frame cycle 50*0.0323 + 300*0.0449 = 15.1 s -> 0.331 FPS.
vs_baseline = ours / 0.331.

HONESTY NOTE (VERDICT r3 weak #1): this is a best-case compute
microbenchmark - broadcast identical frames, uniform pixel sampling, no
dataset IO, no front-end, no keyframe selection, no mesh/ckpt cadence.
The measured END-TO-END figures for the 500-frame flagship run live next
to it in PERF.md (the milestone's phase seconds, section 5). Read both
numbers together; neither substitutes for the other.

bench.py's BENCH_* environment overrides are not taken: the shipped
schedule is fixed here. Versions are timed against each other with
scripts/torch_kernel_compare.py. The run needs a CUDA card and stops
without one; a kernel that fails to build or launch fails the run.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

METRIC = "replica_room0_budget_tracking_mapping_fps"
BASELINE_FPS = 5.0 / (50 * 0.0323 + 300 * 0.0449)
H, W = 680, 1200
FX = FY = 600.0
CX, CY = 599.5, 339.5
HIDDEN = 256
SAMPLES = (32, 12)          # stratified, importance
PIXELS = 5000               # tracking and mapping rays
TRACK_ITERS = 50
F = 6                       # window: 5 keyframes + current
N_OUTER = 3
MAP_INNER = 100             # mapping: 3 outer x 100 inner per cycle
K, KT = 4, 5                # mapper / tracker resample-every
N_CYCLES = 3
FRAMES_PER_CYCLE = 5        # every_frame
CAM0 = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 2.5)


def model_config(hidden: int = HIDDEN):
    from pointnerf_slam_torch.models.decoders import MLPConfig
    return MLPConfig(dim=3, c_dim=0, color=True, hidden_size=hidden,
                     skips=(), n_blocks=4)


def render_config(samples=SAMPLES):
    from pointnerf_slam_torch.render.renderer import RenderConfig
    return RenderConfig(N_samples=samples[0], N_surface=0,
                        N_importance=samples[1])


def engine_config(H=H, W=W, fx=FX, fy=FY, cx=CX, cy=CY, pixels=PIXELS,
                  track_iters=TRACK_ITERS, **over):
    """bench.py's EngineConfig (`over`: fields a caller sets otherwise)."""
    from pointnerf_slam_torch.engine.state import EngineConfig
    kw = dict(H=H, W=W, fx=fx, fy=fy, cx=cx, cy=cy, tracking_pixels=pixels,
              num_cam_iters=track_iters, cam_lr=1e-3,
              mapping_pixels=pixels, mapping_window_size=5,
              weak_depth=False, depth_supervision=True, no_ba_fast=True,
              map_resample_every=K, track_resample_every=KT)
    kw.update(over)
    return EngineConfig(**kw)


def make_inputs(device, H=H, W=W, cam0=CAM0, seed=1) -> dict:
    """bench.py's inputs: one random frame (colour uniform in [0, 1),
    depth uniform in [0.5, 3)), its uint8 copy broadcast over the F-slot
    window and the N_OUTER outers, every window camera at CAM0, all slots
    valid, BA off, the AABB [-3.5, 3.5]^3, and the tracker's start camera
    `cam0`."""
    g = torch.Generator(device=device).manual_seed(seed)
    color = torch.rand(H, W, 3, generator=g, device=device)
    depth = 0.5 + 2.5 * torch.rand(H, W, generator=g, device=device)
    color_u8 = (color * 255).to(torch.uint8)
    return dict(
        color=color, depth=depth,
        colors=color_u8.expand(N_OUTER, F, H, W, 3),
        depths=depth.expand(N_OUTER, F, H, W),
        cams=torch.tensor(CAM0, device=device).expand(N_OUTER, F,
                                                      7).contiguous(),
        valid=torch.ones(N_OUTER, F, dtype=torch.bool, device=device),
        ba=torch.zeros(N_OUTER, F, dtype=torch.bool, device=device),
        bound=torch.tensor([[-3.5, 3.5]] * 3, device=device),
        cam0=torch.tensor(cam0, device=device))


def make_steps(mcfg, rcfg, ecfg):
    """(tracking step, fused-outer mapper step) of the port's engine."""
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.tracker import make_tracking_step
    return (make_tracking_step(mcfg, rcfg, ecfg),
            make_mapper_step(mcfg, rcfg, ecfg, F, outer_fused=True))


def one_cycle(track, mapper, decoder, d: dict, draws, map_inner=MAP_INNER):
    """One 5-frame cycle: the tracker refines cam0 on the frame, then the
    mapper runs N_OUTER x map_inner iterations on the window (the decoder
    trained in place). Returns (best camera, tracker losses, mapper
    losses); nothing is synchronised."""
    best_cam, _, _, tl = track(decoder, d["cam0"], d["color"], d["depth"],
                               d["bound"], draws)
    _, ml = mapper(decoder, d["colors"], d["depths"], d["cams"], d["valid"],
                   d["ba"], d["bound"], draws, map_inner)
    return best_cam, tl, ml


def draws_for(device, seed: int):
    from pointnerf_slam_torch.engine.state import Draws
    return Draws(torch.Generator(device=device).manual_seed(seed))


def run(device=None, H=H, W=W, hidden=HIDDEN, samples=SAMPLES,
        pixels=PIXELS, track_iters=TRACK_ITERS, map_inner=MAP_INNER,
        n_cycles=N_CYCLES) -> dict:
    """The benchmark on `device` (None: the card; the keyword sizes are
    for tests on the CPU). Returns the result line's dict plus the timed
    seconds and the last cycle's losses."""
    from pointnerf_slam_torch.models.decoders import IMAPDecoder
    from pointnerf_slam_torch.utils.device import resolve_device
    dev = resolve_device(device)
    mcfg = model_config(hidden)
    ecfg = engine_config(H=H, W=W, cx=(W - 1) / 2, cy=(H - 1) / 2,
                         pixels=pixels, track_iters=track_iters)
    track, mapper = make_steps(mcfg, render_config(samples), ecfg)
    d = make_inputs(dev, H, W)
    decoder = IMAPDecoder(mcfg, torch.Generator().manual_seed(0)).to(dev)
    initial = {k: v.clone() for k, v in decoder.state_dict().items()}

    def cycle(seed):
        _, tl, ml = one_cycle(track, mapper, decoder, d, draws_for(dev, seed),
                              map_inner)
        last = float(ml[-1])                    # host read: the sync point
        if not math.isfinite(last):
            raise RuntimeError(f"bench: mapping loss not finite: {last}")
        return tl, ml

    cycle(2)                                    # warm-up (builds kernels)
    decoder.load_state_dict(initial)            # time from the initial one
    t0 = time.perf_counter()
    for i in range(n_cycles):
        tl, ml = cycle(3 + i)
    dt = time.perf_counter() - t0
    value = round(n_cycles * FRAMES_PER_CYCLE / dt, 3)
    return {"metric": METRIC, "value": value, "unit": "frames/s",
            "vs_baseline": round(value / BASELINE_FPS, 2), "seconds": dt,
            "tracker_losses": tl, "mapper_losses": ml}


def main(**sizes) -> int:
    """Run the benchmark (`sizes`: run()'s keywords, for tests) and print
    its line last."""
    res = run(**sizes)
    print(json.dumps({k: res[k] for k in ("metric", "value", "unit",
                                          "vs_baseline")}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        raise SystemExit("bench_torch.py takes no arguments")
    raise SystemExit(main())
