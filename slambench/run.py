"""One run of one cell: set up, warm up, measure a window of whole SLAM
cycles, check what the window produced against the plain reference, and
print one result line.

  python -m slambench --workload <cell> --seed <n> --seconds <s> --trace 0|1

The system under test is `pointnerf_slam_torch.engine.system.PointNeRFSLAM`,
built from the cell's configuration file (a complete dict, not the YAML
configs) and driven frame by frame through `step(idx, colour, depth, c2w)`
as its own `run` drives it, with no logger, mesher or writers attached.
Its frame reader is replaced by the traffic's frame source (frames.py),
cast on the device during set-up. `--seed` seeds the system (decoder
initialisation, pixel and uniform draws, keyframe choice) and the
front-end's RANSAC draws; the frames are the same at every seed.

Warm-up: frames from 0 until the first mapping call (1500 iterations; in
weak-depth mode after the front-end's two-view bootstrap) has run, then
the traffic's `warm_cycles` whole cycles. A cycle is the mapping period's
frames (every_frame), ending on a mapped frame.

Window: opens after a device synchronise at a cycle boundary, runs whole
cycles, and closes at the first cycle boundary at or after `--seconds`
with a device synchronise (weak-depth mode leaves the mapper's work queued
when `step` returns). Every run traces the window with torch.profiler
(CUDA activity only; the tracer's first start falls in set-up):
device_ms_per_frame is the window's device busy seconds over its frames,
wall_frames_per_s all its frames over all its seconds. --trace 0 reports
the end-to-end metrics, --trace 1 the per-layer ones (the system's CUDA
events, the operation counts and the device trace, all of the one
window), with the host's phase ranges recorded for the idle gaps.

Set-up time runs from the process's start to the window's opening. The
result line splits it under `setup_parts_s`: imports, the kernel
libraries (built only by a checkout's first run, loaded after), the
frames and the system, and the warm-up.
"""

from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "pointnerf_slam_tpu")


def process_age() -> float | None:
    """Seconds since this process started (Linux /proc), or None."""
    try:
        with open("/proc/self/stat") as fh:
            start = float(fh.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the harness must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class NoCard(RuntimeError):
    pass


def require_cards(need: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        raise NoCard(f"slambench: this cell needs {need} CUDA card(s); "
                     f"torch sees {torch.cuda.device_count()} "
                     f"(cuda available: {torch.cuda.is_available()}). "
                     f"No result.")


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cell_parts(cell: str, root=None, cfg_over: dict | None = None):
    """(spec, cfg, traffic): the cell's file, its configuration with the
    traffic's overrides (and cfg_over) laid over it, and its traffic."""
    from . import registry
    spec = registry.workload(cell, root)
    traffic = registry.traffic(spec["traffic"], root)
    cfg = registry.merge(registry.config(spec["config"], root),
                         traffic.get("config_overrides"))
    cfg = registry.merge(cfg, cfg_over)
    cfg["data"]["frame_cache_dir"] = ""
    return spec, cfg, traffic


def build_cell(cell: str, seed: int, device: str, root=None,
               cfg_over: dict | None = None, frames=None):
    """(spec, cfg, traffic, frames, slam, recorder, init, ref) of one
    cell: init is the system's state at construction, ref the plain
    reference module its configuration names (refused first where it
    names none)."""
    import torch

    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.engine.system import PointNeRFSLAM

    from . import registry
    from .capture import Recorder, clone_state
    from .frames import FrameSource
    spec, cfg, traffic = cell_parts(cell, root, cfg_over)
    ref = registry.reference(spec["config"], root)
    cfg["seed"] = int(seed)
    if frames is None:
        frames = FrameSource(traffic["sequence"], cfg["cam"], cfg["scale"],
                             traffic["render_frames"], device)
    slam = PointNeRFSLAM(cfg, device=device)
    slam.frame_reader = frames
    if slam.frontend is not None:
        slam.frontend.draws = Draws(
            torch.Generator(device=slam.device).manual_seed(int(seed)))
    init = clone_state(slam)
    rec = Recorder(slam, traced=False)
    rec.install()
    return spec, cfg, traffic, frames, slam, rec, init, ref


def _frame(slam, rec, frames, idx):
    with rec.span("reader"):
        _, color, depth, c2w = frames[idx]
    rec.cur_idx = idx
    slam.step(idx, color, depth, c2w)
    rec.note_frame(idx)


def _window(slam, rec, frames, idx: int, seconds: float, min_cycles: int,
            device: str) -> dict:
    """Whole cycles from frame idx + 1, between two device synchronises,
    until at least min_cycles have run and `seconds` have passed."""
    from .trace import synchronize
    every = slam.ecfg.every_frame
    synchronize(device)
    first, ends = idx + 1, []
    w0, t0 = time.time_ns() / 1e9, time.perf_counter()
    while True:
        for _ in range(every):
            idx += 1
            _frame(slam, rec, frames, idx)
        ends.append(time.perf_counter() - t0)
        rec.want_track = False
        if len(ends) >= min_cycles and ends[-1] >= seconds:
            break
    synchronize(device)
    w1, t1 = time.time_ns() / 1e9, time.perf_counter()
    return {"first": first, "last": idx, "cycles": len(ends), "t0": t0,
            "seconds": t1 - t0, "wall": (w0, w1), "cycle_ends": ends}


def drive(slam, rec, frames, traffic, seconds: float, traced: bool,
          device: str, min_cycles: int = 1) -> tuple:
    """Warm-up, then the measured window (at least min_cycles cycles; the
    captures arm at its start) under the profiler; traced, the host's
    phase ranges are recorded too. Returns (window, its Trace)."""
    from .trace import Trace, cats, profiler, warm_profiler
    every = slam.ecfg.every_frame
    idx = -1
    rec.want_map = True                       # the first mapping call
    while not (slam.mapping_first_frame_done and idx % every == 0
               and idx >= 0):
        idx += 1
        _frame(slam, rec, frames, idx)
    for _ in range(int(traffic.get("warm_cycles", 1)) * every):
        idx += 1
        _frame(slam, rec, frames, idx)
    warm_profiler(device)
    rec.in_window = rec.want_map = rec.want_track = True
    rec.traced = traced
    with profiler(device) as prof:
        win = _window(slam, rec, frames, idx, seconds, min_cycles, device)
    rec.in_window = rec.traced = False
    return win, Trace.from_profiler(prof, win["wall"], rec.spans,
                                    cats(device))


def planned_map_iters(slam) -> int:
    """Mapper iterations of a steady mapped frame as the system plans
    them: its outers (`PointNeRFSLAM._step`: one for NICE, else three),
    each the iterations of its stage schedule."""
    outer = 1 if slam.nice else 3
    return outer * sum(n for _, n in slam._stage_schedule(
        max(slam.ecfg.iters // outer, 1)))


def window_tally(slam, rec, win: dict) -> dict:
    """Iterations, failed frames and each phase's device seconds (CUDA
    events of the system's frame records) over the window."""
    import torch
    e = slam.ecfg
    lo, hi = win["first"], win["last"]
    recs = {r["idx"]: r for r in slam.frame_log if lo <= r["idx"] <= hi}
    map_iters = track_iters = failed = tracked = 0
    phase = {"mapping": 0.0, "tracking": 0.0, "frontend": 0.0}
    want_map = planned_map_iters(slam)
    for idx in range(lo, hi + 1):
        r = recs.get(idx, {})
        bad = False
        if idx % e.every_frame == 0:
            ls = r.get("map_losses")
            n = 0 if ls is None else ls.numel()
            map_iters += n
            bad |= ls is None or n != want_map \
                or not bool(torch.isfinite(ls).all())
        if idx in rec.track_losses:
            ls = rec.track_losses[idx]
            tracked += 1
            track_iters += ls.numel()
            bad |= ls.numel() != e.num_cam_iters \
                or not bool(torch.isfinite(ls).all())
        elif not e.gt_camera and (not e.weak_depth
                                  or idx % e.track_every_frame == 0):
            bad = True
        failed += bad
        if slam.device.type == "cuda":
            for k, v in slam.device_seconds(r).items():
                phase[k] = phase.get(k, 0.0) + v
    return {"map_iters": map_iters, "track_iters": track_iters,
            "tracked": tracked, "failed": failed, "phase_s": phase}


def run(cell: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", root=None, cfg_over: dict | None = None,
        control: bool = False, frames=None, t_start: float | None = None,
        min_cycles: int = 1) -> dict:
    """One run; returns the result dict (the printed line's keys) plus
    `lines` (the numbers beside their limits) and `numbers`."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_build = time.perf_counter()
    if torch.device(device).type == "cuda":
        from pointnerf_slam_torch.ops import build
        build.build_all()
    t_cell = time.perf_counter()
    spec, cfg, traffic, frames, slam, rec, init, ref = build_cell(
        cell, seed, device, root, cfg_over, frames)
    t_warm = time.perf_counter()
    try:
        win, trace = drive(slam, rec, frames, traffic, seconds, traced,
                           device, min_cycles)
    finally:
        rec.uninstall()
    setup_s = win["t0"] - t_start
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"slambench: loaded in the measured process: "
                           f"{', '.join(bad)}")
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    tally = window_tally(slam, rec, win)
    trace.map_iters, trace.track_iters = tally["map_iters"], \
        tally["track_iters"]
    captured = {"init": init, "map_caps": rec.map_caps,
                "track_caps": rec.track_caps, "fe_tris": rec.fe_tris,
                "fe_splats": rec.fe_splats,
                "patch": slam.frontend.depth_patch if slam.frontend
                else 0,
                "pseudo": {c["idx"]: slam.pseudo_depths[c["idx"]].cpu()
                           .numpy() for c in rec.fe_splats
                           if c["idx"] in slam.pseudo_depths}}
    del slam, rec
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    from . import check, registry, roofline
    limits = spec.get("limits", {})
    diag, diag_ctl = [], []
    nums = check.numbers(captured, cfg, seed, ref, diag=diag)
    correct, lines = check.judge(nums, limits, where_present=spec.get(
        "judged_where_present", ()))
    ctl = check.numbers(captured, cfg, seed, ref, control=True,
                        diag=diag_ctl) if control else None
    ctx = SimpleNamespace(
        cfg=cfg, cell=cell, seconds=win["seconds"],
        frames=win["last"] - win["first"] + 1, cycles=win["cycles"],
        setup_s=setup_s, trace=trace, roofline=roofline,
        kernels=lambda name: registry.kernel_patterns(name, root), **tally)
    metrics = {}
    for name in registry.cell_metrics(cell, traced, root):
        value = registry.metric(name, root).read(ctx)
        if value is not None:
            metrics[name] = {"value": value,
                             "unit": _unit(name, traced, root)}
    out = {"correct": bool(correct), "attempted": ctx.frames,
           "failed": tally["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if torch.device(device).type
                      == "cuda" else torch.device(device).type,
                      "kind": torch.cuda.get_device_name(0)
                      if torch.device(device).type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if traced:
        out["device"]["busy_s"] = trace.busy_s
        out["device"]["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(10),
                            "idle_gaps": trace.idle_by_span(10)}
    out["window"] = {"cycles": win["cycles"], "frames": ctx.frames,
                     "seconds": win["seconds"], "busy_s": trace.busy_s,
                     "cycle_ends_s": win["cycle_ends"]}
    out["setup_parts_s"] = {"imports": t_build - t_start,
                            "kernel_build": t_cell - t_build,
                            "frames_and_system": t_warm - t_cell,
                            "warm_up": win["t0"] - t_warm}
    out["checks"] = {k: {"value": nums.get(k), "limit": limits[k]}
                     for k in sorted(limits)}
    return dict(out, lines=lines, numbers=nums, control_numbers=ctl,
                diag=diag, diag_control=diag_ctl, win=win,
                cycles=win["cycles"])


def _unit(name: str, traced: bool, root) -> str:
    from . import registry
    bench = registry.benchmark(root)
    key = "per_layer" if traced else "end_to_end"
    return next(m["unit"] for m in bench[key] if m["name"] == name)


def main(argv=None) -> int:
    import argparse
    import json
    t_start = time.perf_counter() - (process_age() or 0.0)
    ap = argparse.ArgumentParser(prog="python -m slambench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import registry
    chips = next((w.get("chips", 1) for w in (registry.benchmark() or {})
                  .get("workloads", []) if w["name"] == args.workload), 1)
    try:
        require_cards(chips)
    except NoCard as err:
        print(str(err), file=sys.stderr)
        return 2
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t_start=t_start)
    print(f"slambench: {power_limit()}; memory peak "
          f"{res['device']['memory_peak_bytes']} bytes; kernel libraries "
          f"{res['setup_parts_s']['kernel_build']:.3f} s of set-up; window "
          f"{res['cycles']} cycles, {res['attempted']} frames",
          flush=True)
    lines = res.pop("lines")
    for k in ("numbers", "control_numbers", "diag", "diag_control", "win",
              "cycles"):
        res.pop(k)
    print(json.dumps(res), flush=True)
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
