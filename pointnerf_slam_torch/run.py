"""Run the port's SLAM system on a config.

  python -m pointnerf_slam_torch.run <config> [--n_frames N]
      [--input_folder DIR] [--device cuda|cpu] [--output DIR]
      [--resume CKPT] [--profile DIR] [--live_vis]
      [--max_restarts R [--frames_per_attempt M] [--no_eval]]

Runs sensor-depth, weak-depth (RGB-only) and NICE configs (e.g.
configs/Synthetic/room_bench.yaml with configs/nice_slam.yaml's keys
overlaid in a config of one's own through `inherit_from`). --n_frames N
(alias --max_frames) processes frames 0 .. N-1; --input_folder DIR reads
the sequence from DIR instead of the config's data.input_folder. Prints,
per processed
frame, the tracking loss (first -> best), the camera error against gt
(mean |cam7 - gt cam7| and translation error in metres), each phase's
(front-end, tracking, mapping) host self seconds and the seconds it
waited on the card, apart ("host", "wait"; on the card also the phase's
time between its events on the stream, "card"), the frame's waits in all,
and the mapping loss (first -> last); at the end the translation RMSE and
max of the poses against gt, unaligned and Horn-aligned
(tools/eval_ate.py), and one line of the phases' host and wait seconds
(with the waits outside them), which is also appended to
<output>/run_log.txt. A wait is the host blocked on the card: a blocking
read from the device or a pageable copy to it (the tracer's `wait.*`
spans, utils/tracing.py). Output
(--output, else the config's data.output): checkpoints in <output>/ckpts/
(mapping.ckpt_freq, the last frame, and before each mapping frame the
state up to the frame before it), meshes in <output>/mesh/ (one every
mapping.mesh_freq frames; at the last frame `final_mesh.ply` and, with
meshing.eval_rec, `final_mesh_eval_rec.ply`), render panels in
<output>/mapping_vis/ and tracking_vis/, match panels in matches_vis/
(weak mode), trajectory views in traj_vis/ and loss curves in loss_vis/
(outputs.attach_outputs).

--profile DIR writes a torch.profiler trace of the run (host and, on the
card, CUDA activity) to DIR as a Chrome trace (`*.pt.trace.json`), and
the program's own spans (utils/tracing.py: step, the phases, the mapper's
window selection, the wrappers, the optimiser steps, keyframe insertion,
the front-end's stages and every wait) beside it as one Chrome trace,
`program_spans.json`, on the same clock (`baseTimeNanoseconds` plus `ts`
microseconds is the host's wall clock in both).
--live_vis opens the live window (outputs/live_view.py; it disables
itself with a notice where there is no GUI backend).

--resume CKPT continues a run from a checkpoint (outputs/logger.py).
--max_restarts R supervises: the run is executed again as a subprocess
from the latest checkpoint in <output>/ckpts/ after a failure, up to R
times; with --frames_per_attempt M each attempt stops after M frames (and
then skips the end-of-sequence colour refine and final meshes) and the
next resumes. A supervised run that completes a synthetic sequence is
scored by scripts/eval_room_bench_torch.sh (the port's tools; no JAX)
into <output>/eval_metrics.txt unless --no_eval; a failed evaluation
makes the supervisor return non-zero.

Several devices (parallel.data_devices): a plain start whose data_devices
resolves to n > 1 (on CUDA "auto" is every local card and an int is
clamped to their count; on the CPU an int is taken as given and "auto" is
one) starts itself again as n processes through `python -m
torch.distributed.run --standalone --nproc_per_node n`, and the
supervisor starts its attempts that way. Under such a launcher
(WORLD_SIZE > 1) main joins the default process group, NCCL on the card
cuda:LOCAL_RANK with --device cuda, gloo with --device cpu; the mapper
splits its rays over the ranks (engine/mapper.py), and only rank 0 prints
and writes outputs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .engine import PointNeRFSLAM
from .io.config import load_config
from .outputs import attach_outputs
from .parallel.mapping import resolve_data_devices
from .tools.eval_ate import evaluate_ate, latest_checkpoint
from .utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frame_line(rec: dict) -> str:
    parts = [f"frame {rec['idx']:4d}"]
    if "track_first" in rec:
        parts.append(f"track {float(rec['track_first']):.2f} -> "
                     f"{float(rec['track_best']):.2f}")
        parts.append(f"cam err {float(rec['cam_err']):.5f} "
                     f"(t {float(rec['t_err_m']) * 1000:.1f} mm)")
    dev = PointNeRFSLAM.device_seconds(rec)
    secs = [f"{k} host {rec[k + '_s']:.2f} s wait "
            f"{rec.get(k + '_wait_s', 0.0):.2f} s"
            + (f" (card {dev[k]:.2f} s)" if k in dev else "")
            for k in ("frontend", "tracking", "mapping") if k + "_s" in rec]
    if "wait_s" in rec:
        secs.append(f"waits {rec['wait_s']:.2f} s")
    if secs:
        parts.append(", ".join(secs))
    if "map_losses" in rec:
        ls = rec["map_losses"]
        parts.append(f"map {float(ls[0]):.1f} -> {float(ls[-1]):.1f} "
                     f"({ls.numel()} it)")
    return "  ".join(parts)


def trajectory_errors(est: np.ndarray, gt: np.ndarray) -> dict:
    """Translation error of (N, 4, 4) estimated poses against gt in metres:
    RMSE and max unaligned, and after Horn alignment (tools/eval_ate.py's
    ATE, computed as that tool computes it from a checkpoint of the
    same poses)."""
    e, g = est[:, :3, 3].astype(np.float64), gt[:, :3, 3].astype(np.float64)
    raw = np.linalg.norm(e - g, axis=1)
    ate = evaluate_ate(gt, est)
    return {"rmse": float(np.sqrt(np.mean(raw ** 2))), "max": float(raw.max()),
            "ate_rmse": ate["absolute_translational_error.rmse"],
            "ate_max": ate["absolute_translational_error.max"]}


def checkpoint_index(path) -> int:
    return int(os.path.basename(path).split(".")[0]) if path else -1


def launch_size(cfg, device: str) -> int:
    """Processes a plain start runs: parallel.data_devices resolved against
    the local cards (--device cuda) or with no device count (--device
    cpu: the int as given, "auto" one)."""
    want = (cfg.get("parallel", {}) or {}).get("data_devices", "auto")
    return resolve_data_devices(
        want, torch.cuda.device_count() if device == "cuda" else None)


def module_cmd(n: int) -> list:
    """The command that runs this module as n processes (n > 1: through
    torch.distributed.run on one node)."""
    if n <= 1:
        return [sys.executable, "-m", "pointnerf_slam_torch.run"]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n), "-m", "pointnerf_slam_torch.run"]


def module_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def join_group(device: str) -> str:
    """Join the default process group of a launcher's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Returns this rank's
    device: cuda:LOCAL_RANK under NCCL, or the CPU under gloo."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
        return f"cuda:{local}"
    dist.init_process_group("gloo")
    return "cpu"


def supervise(args) -> int:
    """Run the sequence as subprocesses of this module, each resuming from
    the latest checkpoint; again after a failure, up to args.max_restarts
    times. Returns 0 when the sequence completed (and, unless --no_eval,
    its evaluation passed)."""
    cfg = load_config(args.config)
    if args.input_folder:
        cfg["data"]["input_folder"] = args.input_folder
    out = args.output or cfg["data"]["output"]
    from .io.datasets import get_dataset
    total = len(get_dataset(cfg))
    if args.n_frames:
        total = min(total, args.n_frames)
    base = module_cmd(launch_size(cfg, args.device)) + [
        args.config, "--device", args.device, "--output", out]
    if args.input_folder:
        base += ["--input_folder", args.input_folder]
    if args.profile:
        base += ["--profile", args.profile]
    if args.live_vis:
        base.append("--live_vis")
    env = module_env()
    chunk = args.frames_per_attempt
    # a supervisor started again continues from the run's own checkpoints
    resume = args.resume or latest_checkpoint(out)
    for attempt in range(args.max_restarts + 1):
        start = checkpoint_index(resume) + 1 if resume else 0
        cap = min(start + chunk, total) if chunk > 0 else total
        cmd = base + ["--n_frames", str(cap)]
        if cap < total:
            cmd.append("--no_final_refine")   # not the sequence's end
        if resume:
            cmd += ["--resume", resume]
        print(f"[supervisor] attempt {attempt}: {' '.join(cmd[2:])}",
              flush=True)
        rc = subprocess.run(cmd, env=env).returncode
        resume = latest_checkpoint(out)
        done = checkpoint_index(resume)
        if rc == 0 and done >= total - 1:
            print(f"[supervisor] finished at frame {done}", flush=True)
            if args.no_eval:
                return 0
            return evaluate_completed_run(out, cfg)
        if rc != 0:
            print(f"[supervisor] attempt failed (rc={rc}); latest "
                  f"checkpoint {resume}", flush=True)
    print("[supervisor] restart budget exhausted", flush=True)
    return 1


def evaluate_completed_run(out: str, cfg) -> int:
    """Score a completed synthetic run with scripts/eval_room_bench_torch.sh
    (ATE, 3D accuracy / completion, 2D depth-L1 with and without the view
    rejection) in a subprocess; returns its exit code."""
    if cfg["data"].get("dataset") != "synthetic":
        return 0   # no ground-truth mesh for a real dataset
    script = os.path.join(REPO, "scripts", "eval_room_bench_torch.sh")
    print(f"[supervisor] evaluating completed run: {out}", flush=True)
    env = dict(os.environ, PYTHON=sys.executable)
    rc = subprocess.run(["bash", script, os.path.abspath(out)],
                        env=env).returncode
    if rc == 0:
        print(f"[supervisor] eval done -> {out}/eval_metrics.txt",
              flush=True)
    else:
        print(f"[supervisor] EVAL FAILED (rc={rc})", flush=True)
    return rc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--n_frames", "--max_frames", dest="n_frames", type=int,
                    default=None,
                    help="process frames 0 .. N-1 of the sequence")
    ap.add_argument("--input_folder", type=str, default=None,
                    help="input folder, overrides the config's")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--output", type=str, default=None,
                    help="output folder, overrides the config's")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint (.npz) to continue from")
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="supervise: run again from the latest checkpoint "
                         "after a failure, up to N times")
    ap.add_argument("--frames_per_attempt", type=int, default=0,
                    help="with --max_restarts: each attempt processes at "
                         "most N frames, the next resumes")
    ap.add_argument("--no_eval", action="store_true",
                    help="with --max_restarts: do not score the completed "
                         "run")
    ap.add_argument("--profile", type=str, default=None,
                    help="write a torch.profiler Chrome trace of the run "
                         "to this directory")
    ap.add_argument("--live_vis", action="store_true",
                    help="live window: pose trail, latest mesh, current "
                         "frame (disables itself without a GUI backend)")
    ap.add_argument("--no_final_refine", action="store_true",
                    help=argparse.SUPPRESS)   # a chunked attempt's end
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.max_restarts > 0:
        return supervise(args)
    cfg = load_config(args.config)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = join_group(args.device)
        try:
            return run(args, cfg, device)
        finally:
            dist.destroy_process_group()
    n = launch_size(cfg, args.device)
    if n > 1:
        print(f"parallel.data_devices: {n} processes", flush=True)
        return subprocess.run(module_cmd(n) + argv,
                              env=module_env()).returncode
    return run(args, cfg, args.device)


def run(args, cfg, device: str) -> int:
    """One process's run of the sequence (rank 0 prints and writes)."""
    if args.input_folder:
        cfg["data"]["input_folder"] = args.input_folder
    if args.no_final_refine:
        cfg["mapping"]["color_refine"] = False
        cfg["meshing"]["eval_rec"] = False
        cfg["meshing"]["final_mesh"] = False
    slam = PointNeRFSLAM(cfg, n_frames_cap=args.n_frames, device=device,
                         output=args.output)
    rank = slam.group.rank
    attach_outputs(slam)
    if args.live_vis and rank == 0:
        from .outputs.live_view import LiveViewer
        slam.aux_visualizers.append(
            LiveViewer(slam.output, freq=cfg["mapping"]["vis_freq"]))
    start = 0
    if args.resume:
        from .outputs.logger import resume_slam
        start = resume_slam(slam, args.resume)
        if rank == 0:
            print(f"resumed from {args.resume}; continuing at frame "
                  f"{start}", flush=True)
    t0 = time.time()

    def on_frame(s, idx):
        if rank == 0 and s.frame_log and s.frame_log[-1]["idx"] == idx:
            print(frame_line(s.frame_log[-1]), flush=True)

    if args.profile:
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if slam.device.type == "cuda"
                                         else [])
        n0 = len(tracing.TRACER.spans)
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(args.profile)):
            est, gt = slam.run(start, on_frame=on_frame)
            if slam.device.type == "cuda":
                torch.cuda.synchronize()
        if rank == 0:
            spans = tracing.write_chrome_trace(
                os.path.join(args.profile, "program_spans.json"),
                tracing.TRACER.spans[n0:])
            print(f"profiler trace in {args.profile}, the program's spans "
                  f"in {spans}", flush=True)
    else:
        est, gt = slam.run(start, on_frame=on_frame)
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    if rank != 0:
        return 0
    err = trajectory_errors(est, gt)
    print(f"done: frames {start}..{slam.n_img - 1} in {wall:.1f} s "
          f"on {slam.device}; translation RMSE against gt over frames "
          f"0..{slam.n_img - 1} (unaligned) {err['rmse']:.4f} m, max "
          f"{err['max']:.4f} m; Horn-aligned (ATE) RMSE "
          f"{err['ate_rmse']:.4f} m, max {err['ate_max']:.4f} m; "
          f"checkpoints in {os.path.join(slam.output, 'ckpts')}, meshes in "
          f"{os.path.join(slam.output, 'mesh')}", flush=True)
    line = phase_line(slam, start, wall)
    print(line, flush=True)
    with open(os.path.join(slam.output, "run_log.txt"), "a") as fh:
        fh.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {line}\n")
    return 0


def phase_line(slam, start: int, wall: float) -> str:
    """Frames, wall seconds, and the host self seconds and the seconds
    waited on the card (and on the card, the device seconds) of the
    front-end, tracking and mapping of this attempt, and the waits outside
    them."""
    t, w = slam.timings, slam.waits
    dev = {}
    for rec in slam.frame_log:
        for k, v in PointNeRFSLAM.device_seconds(rec).items():
            dev[k] = dev.get(k, 0.0) + v
    parts = [f"{k} host {t[k]:.1f} s wait {w[k]:.1f} s"
             + (f" (card {dev[k]:.1f} s)" if k in dev else "")
             for k in ("frontend", "tracking", "mapping")]
    parts.append(f"other wait {w['other']:.1f} s")
    n = slam.n_img - start
    return (f"frames {start}..{slam.n_img - 1} ({n}) in {wall:.1f} s wall "
            f"({n / max(wall, 1e-9):.3f} frames/s): " + ", ".join(parts))


if __name__ == "__main__":
    raise SystemExit(main())
