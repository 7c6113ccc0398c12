#!/usr/bin/env python3
"""One tracked frame of a port checkpoint through both packages, from the
same state and with the same random draws, stage by stage.

  python scripts/step_replay.py --ckpt CKPT [--config YAML]
      [--device cpu|cuda] [--map_iters N] [--ref_keys2] [--ref_ulp]
      [--port_ulp] [--out DIR] [--reuse]
  python scripts/step_replay.py --table DIR [DIR ...]

Each package runs in its own subprocess (this script imports neither):
the JAX reference on the CPU, the port on --device. Both restore the
checkpoint with their own resume_slam, which restores the front-end's
step history (the last 10 accepted steps) and last tracked frame from
the checkpoint's fe_step_hist and fe_last_tracked_idx (the script checks
both against the checkpoint's front-end telemetry and prints whether they
agree), step the untracked frames up to K, the next tracked frame after the
checkpoint's, and then run frame K. The reference runs first, with
rendering.megakernel "on" where the config says "auto", so on the CPU it
takes the Pallas kernels' path (interpret mode) that it takes on a TPU;
the port takes its kernels' path (on the CPU their plain versions). The
keys the reference consumes in frame K (the front-end's RANSAC key, the
tracker's and the mapper's) are recorded and turned into the port's
draws with scripts/replay_draws.py (RANSAC hypotheses from the
reference's match mask, pixel batches among the reference's pseudo-depth
pixels, regulation uniforms), saved to DIR/draws.npz and replayed into
the port's Draws; the port must consume every one of them.

Per stage it prints both packages and their difference: the motion prior
c_prior; the two-view solve c_solve with its matches, inliers,
candidates, scale, scale_raw, parallax, par_eff and the map and sanity
corrections (f_map, n_map_anchor, f_sanity); step_d and the step gate's
decision with its median; the tracker's first -> best loss and c_refined;
every centre against gt (mm) and every rotation (the prior's, the
solve's, the refined one) against gt (deg). Centres and steps differ in
mm, rotations by their angle (deg), counts and scales by value. Each run
also records its tracker path, the loss, camera centre and translation
gradient at every iteration, through hooks on its package's own fused-VG
tracker (the reference's kernel pair reports them with
jax.debug.callback); the comparison gives where a run's path parts from
the reference's, the loss gap and gradient cosine until then, and the
iteration each run's best-of selection takes.
--map_iters N (default 0: no mapping) also runs frame K's mapping with N
iterations in all (N / 3 per outer, the windows drawn as the system draws
them; 300 is the flagship's call) and prints the losses and the largest
relative parameter difference (per tensor, |p_a - p_b| / |p_b| in the L2
norm, after the call). --ref_keys2 runs the
reference again beside the first, jax2, with every key stream folded with
1 (other RANSAC hypotheses and pixels); --ref_ulp runs jax4 and jax5,
with the same keys and the smallest change of state there is: every
decoder weight one float32 ulp up (jax4), the reference keyframe's
keypoints one ulp up (jax5). Each one's gap to the first is the
reference's own spread, the noise floor a port-reference gap stands
beside: jax2's between two draws, jax4's and jax5's under a perturbation at the
level of float rounding (where two runs from the same draws part, as a
chaotic optimisation or a near-degenerate solve parts them, these show
it in the reference alone). The front-end's stages stand beside jax2 and
jax5, the variants that perturb them. --port_ulp runs torch4, the port
with its decoder one ulp up: its gap to the port's own run (the table's
torch4 spread) is the port's own sensitivity.

--reuse takes each package's record from DIR where a run left it (e.g.
the port's, made on the card with --package torch --device cuda from the
reference's DIR/draws.npz) instead of running it again.

--table DIR... reads replays and prints the per-frame table (the gap
against each spread per stage); the frames where the gap exceeds each
spread (the departure rule as stated), and where it exceeds both the
spread and the stage's test tolerance (TOL); and the sign tests of the
port's step_d and refined step being shorter than the reference's and of
its best tracking loss being higher (one-sided binomial p); and where the
tracker paths part and how often the best-of selections differ.

Runs from the repository root with PYTHONPATH at it; the frames come
through the config's reader (data.frame_cache_dir is kept, so a prewarmed
cache serves both packages).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTRES = ("prior", "solve", "refined")
FE_KEYS = ("n_matches", "n_inliers", "n_cand", "n_accept", "scale",
           "scale_raw", "parallax", "par_eff", "s_prior", "f_map",
           "n_map_anchor", "f_sanity")
# stages the departure rule reads: centres and steps (mm), rotations
# (deg), the tracker's first loss (at the shared camera and pixels) and
# best loss (relative)
GAP_STAGES = ("prior", "solve", "rot_solve", "step_d", "track_first",
              "refined", "refined_step", "rot_refined", "track_best")
# the front-end's stages, and the variants that perturb them (other
# RANSAC keys, the reference keyframe's keypoints one ulp up)
FRONT_STAGES = ("prior", "solve", "rot_solve", "step_d")
FRONT_VARIANTS = ("jax2", "jax5")
# the tolerance each stage's gap must also exceed to count: the two-view
# tests' 0.1 mm and 0.1 deg, the tracker tests' one Adam step (cam_lr
# 1e-3: 1 mm) and loss rtol 2e-2 (tests/test_torch_frontend.py,
# tests/test_torch_engine.py)
TOL = {"prior": 0.1, "solve": 0.1, "rot_solve": 0.1, "step_d": 0.1,
       "track_first": 2e-2, "refined": 1.0, "refined_step": 1.0,
       "rot_refined": 0.1, "track_best": 2e-2}
# the reference's second runs, each against the first: every key stream
# folded with 1, or the same keys with every decoder weight, or the
# reference keyframe's keypoints, one float32 ulp up
VARIANTS = {"jax2": "keys", "jax4": "ulp", "jax5": "ulp_kps"}


def ref_name(args):
    return {v: k for k, v in VARIANTS.items()}.get(args.variant, "jax")


def port_name(args):
    """torch, or torch4: the port with every decoder weight one ulp up."""
    return "torch4" if args.variant == "ulp" else "torch"


def front_history(z, hist_len=10):
    """(step history, last tracked frame) as a checkpoint's fe2_telemetry
    records them: the last hist_len accepted step_d, and the frame of the
    last front-end record (every solve and the bootstrap set it)."""
    tel = json.loads(str(z["fe2_telemetry"]))
    hist = [float(t["step_d"]) for t in tel if "step_d" in t][-hist_len:]
    last = max(int(t["idx"]) for t in tel if "idx" in t)
    return hist, last


def replay_config(load_config, args, package):
    cfg = load_config(os.path.join(REPO, args.config))
    if package == "jax" and cfg["rendering"].get("megakernel",
                                                 "auto") == "auto":
        cfg["rendering"]["megakernel"] = "on"
    cfg["verbose"] = False
    return cfg


def restore(slam, resume, args, z):
    """Resume slam from the checkpoint. Returns the first frame to run
    and a note: the front-end's step history and last tracked frame as
    the resume left them, and whether they agree with the telemetry."""
    start = resume(slam, args.ckpt)
    hist, last = front_history(z)
    fe = slam.frontend
    note = {"hist": list(map(float, fe._step_hist)),
            "last_tracked": fe._last_tracked_idx,
            "telemetry_hist_agrees": len(fe._step_hist) == len(hist)
            and bool(np.allclose(fe._step_hist, hist)),
            "telemetry_last_agrees": fe._last_tracked_idx == last}
    return start, note


def target_frame(start, tef):
    """The first tracked frame at or after start."""
    return -(-start // tef) * tef


def wrap_map_frame(slam, args, n_pos):
    """Frame K's mapping with args.map_iters iterations in all, or none."""
    orig = slam._map_frame

    def map_frame(*a, **kw):
        if args.map_iters <= 0:
            return None
        a = list(a)
        a[n_pos] = max(args.map_iters // a[n_pos + 1], 1)
        return orig(*a, **kw)
    slam._map_frame = map_frame


def wrap_solve(fe, seen):
    """Record the front-end's continuous solve of a frame: the motion
    prior the engine wrote for it and the pose it returns."""
    orig = fe.track_continuous

    def track_continuous(frame_reader, idx, est, *a, **kw):
        seen["R_prior"] = np.asarray(est[idx][:3, :3], np.float64).tolist()
        out = orig(frame_reader, idx, est, *a, **kw)
        if out[0] is not None:
            seen["R_solve"] = np.asarray(out[0][:3, :3],
                                         np.float64).tolist()
        return out
    fe.track_continuous = track_continuous


def frame_record(slam, k, gate_med, c_last, first, best, map_losses,
                 seen):
    fe = slam.frontend
    merged = {}
    for t in fe.telemetry:
        if t.get("idx") == k:
            merged.update(t)
    st = next((t for t in slam.scale_telemetry if t["idx"] == k), {})
    decision = ("accepted" if "step_d" in merged else
                "rejected_step" if "rejected_step" in merged else
                "rejected_step_abs" if "rejected_step_abs" in merged else
                "no solve")
    step = merged.get("step_d", merged.get(
        "rejected_step", merged.get("rejected_step_abs")))
    rec = {"frame": k, "decision": decision, "step_d": step,
           "gate_median": gate_med, "c_last": list(map(float, c_last)),
           "fe": {key: merged[key] for key in FE_KEYS if key in merged},
           "track_first": first, "track_best": best,
           "map_losses": map_losses, "c_gt": st.get("c_gt"),
           "R_prior": seen.get("R_prior"), "R_solve": seen.get("R_solve"),
           "R_refined": np.asarray(slam.estimate_c2w_list[k][:3, :3],
                                   np.float64).tolist(),
           "R_gt": np.asarray(slam.gt_c2w_list[k][:3, :3],
                              np.float64).tolist()}
    for c in CENTRES:
        rec[c] = st.get(f"c_{c}")
    return rec


def gate_median(fe):
    return float(np.median(fe._step_hist)) if len(fe._step_hist) >= 3 \
        else None


def run_jax(args) -> dict:
    """The reference's frame K (on the CPU); the record of its stages, and
    unless args.variant its draws saved to args.out/draws.npz."""
    import jax
    import jax.numpy as jnp
    from pointnerf_slam_tpu.engine import PointNeRFSLAM
    from pointnerf_slam_tpu.frontend.matching import match_two_way
    from pointnerf_slam_tpu.frontend.rotation_histogram import \
        filter_matches_with_histogram_orientation
    from pointnerf_slam_tpu.io.config import load_config
    from pointnerf_slam_tpu.ops.fused_vg import supports_fused_vg
    from pointnerf_slam_tpu.ops.megakernel import supports_megakernel
    from pointnerf_slam_tpu.outputs.logger import resume_slam
    from replay_draws import hypotheses, mapper_draws, pixel_draws

    import pointnerf_slam_tpu.ops.fused_vg as fused_vg
    path = []
    split = fused_vg.make_fused_vg_split

    def split_rec(rcfg, mode, *a, **kw):
        """The tracker's kernel pair, its main reporting each iteration's
        loss, camera centre (every ray's origin) and translation gradient
        (the rays' origin gradients summed) to the host, in order."""
        prep, main = split(rcfg, mode, *a, **kw)
        if mode != "tracker":
            return prep, main

        def main_rec(params, ro, rd, *rest):
            out = main(params, ro, rd, *rest)
            jax.debug.callback(lambda *v: path.append(
                np.concatenate([np.ravel(x) for x in v]).tolist()),
                out[0], ro[0], out[2].sum(0), ordered=True)
            return out
        return prep, main_rec
    fused_vg.make_fused_vg_split = split_rec
    z = np.load(args.ckpt)
    cfg = replay_config(load_config, args, "jax")
    slam = PointNeRFSLAM(cfg, n_frames_cap=len(z["estimate_c2w_list"]))
    start, note = restore(slam, resume_slam, args, z)
    fe, e = slam.frontend, slam.ecfg
    if args.variant == "keys":
        slam.key = jax.random.fold_in(slam.key, 1)
        fe.key = jax.random.fold_in(fe.key, 1)
    if args.variant == "ulp":
        slam.params = jax.tree_util.tree_map(
            lambda p: jnp.asarray(np.nextafter(np.asarray(p), np.inf)),
            slam.params)
    if args.variant == "ulp_kps":
        kps, *rest = fe.prev["feats"]
        fe.prev["feats"] = (jnp.asarray(np.nextafter(np.asarray(kps),
                                                     np.inf)), *rest)
    consumed = []
    for obj, name in ((slam, "engine"), (fe, "frontend")):
        def next_key(obj=obj, name=name, orig=obj._next_key):
            consumed.append(name)
            return orig()
        obj._next_key = next_key
    k = target_frame(start, e.track_every_frame)
    for i in range(start, k):
        _, color, depth, gt = slam.frame_reader[i]
        slam.step(i, color, depth, gt)
        slam._commit_pending_pose()
    if consumed:
        raise RuntimeError(f"untracked frames consumed keys: {consumed}")

    solves, tracks, maps = [], [], []
    run_match = jax.jit(lambda dc, vc, dr, vr, ar, ac, nn: (
        lambda i2, mv: filter_matches_with_histogram_orientation(
            ar[i2], ac, mv, min_keep=16, min_frac=0.7)
        if fe.check_orientation else mv)(
            *match_two_way(dc, vc, dr, vr, nn)[:2]))
    runner_for = fe._runner_for

    def runner_for_rec(mode, field_ctx=None):
        r = runner_for(mode, field_ctx)
        if not getattr(r, "_recorded", False):
            run = r.run

            def run_rec(mode, feats_ref, feats_cur, Tcw_ref, key, *a,
                        nn_thresh=None, **kw):
                nn = r._nn_default if nn_thresh is None else nn_thresh
                (_, dr, vr, ar), (_, dc, vc, ac) = feats_ref, feats_cur
                mv = run_match(dc, vc, dr, vr, ar, ac, jnp.float32(nn))
                solves.append((key, np.asarray(mv)))
                return run(mode, feats_ref, feats_cur, Tcw_ref, key, *a,
                           nn_thresh=nn_thresh, **kw)
            r.run, r._recorded = run_rec, True
        return r
    fe._runner_for = runner_for_rec
    tracking_step = slam.tracking_step

    def tracking_rec(params, c_grid, cam, color, depth_sup, bound, key):
        tracks.append((key, np.asarray(depth_sup)))
        return tracking_step(params, c_grid, cam, color, depth_sup, bound,
                             key)
    slam.tracking_step = tracking_rec
    get_step = slam._get_mapper_step

    def get_step_rec(max_frames, stage, lr_factor, outer_fused=False):
        fn = get_step(max_frames, stage, lr_factor, outer_fused)

        def step_rec(params, c_grid, colors, depths, cams, valid, ba,
                     bound, key, n_iters):
            maps.append((key, np.asarray(depths), n_iters, max_frames,
                         outer_fused, colors.shape[0]))
            return fn(params, c_grid, colors, depths, cams, valid, ba,
                      bound, key, n_iters)
        return step_rec
    slam._get_mapper_step = get_step_rec
    wrap_map_frame(slam, args, 4)
    seen = {}
    wrap_solve(fe, seen)

    gmed = gate_median(fe)
    c_last = slam.estimate_c2w_list[fe._last_tracked_idx][:3, 3].copy()
    _, color, depth, gt = slam.frame_reader[k]
    slam.step(k, color, depth, gt)
    slam._commit_pending_pose()
    tr = [t for t in slam.loss_log["tracking"] if int(t[0]) == k]
    ml = [float(x) for i, ls in slam.loss_log["mapping"] if i == k
          for x in np.asarray(ls)]
    rec = frame_record(slam, k, gmed, c_last,
                       float(tr[-1][1]) if tr else None,
                       float(tr[-1][2]) if tr else None, ml, seen)
    rec.update(note=note, keys=consumed, start=start, track_path=path)
    params = {f"param_{i}": np.asarray(p) for i, p in
              enumerate(jax.tree_util.tree_leaves(slam.params))}
    np.savez(os.path.join(args.out, f"params_{ref_name(args)}.npz"),
             **params)
    if args.variant:
        return rec

    # the reference's draws as the port consumes them
    mega = (e.megakernel != "off" and not slam.nice
            and supports_megakernel(slam.model_cfg, slam.rcfg)
            and (e.megakernel == "on"
                 or jax.default_backend() == "tpu"))
    vg = supports_fused_vg(slam.model_cfg, slam.rcfg)
    track_vg = mega and vg and e.depth_supervision and not e.handle_dynamic
    map_vg = mega and vg
    if slam.rcfg.perturb != 0.0:
        raise ValueError("perturbed renders are not replayed")
    fe_draws = [hypotheses(key, mv) for key, mv in solves]
    engine = []
    kt = max(int(e.track_resample_every), 1)
    rounds = track_vg and kt > 1 and e.num_cam_iters % kt == 0
    for key, dep in tracks:
        engine += pixel_draws(
            key, e.num_cam_iters // kt if rounds else e.num_cam_iters,
            e.tracking_pixels, e.W, e.H,
            edges=(e.ignore_edge_H, e.ignore_edge_W),
            valid=dep > 0.01 if e.weak_depth else None)
    km = max(int(e.map_resample_every), 1) if map_vg else 1
    for key, deps, n_iters, F, fused, n_out in maps:
        engine += mapper_draws(
            key, F, max(e.mapping_pixels // F, 1), slam.rcfg.N_samples,
            e.W, e.H, n_iters, km, outers=n_out if fused else None,
            depths=deps if e.weak_depth else None)
    arrays = {f"fe_{i:03d}": d.numpy() for i, d in enumerate(fe_draws)}
    arrays.update({f"engine_{i:04d}": d.numpy()
                   for i, d in enumerate(engine)})
    np.savez(os.path.join(args.out, "draws.npz"), **arrays)
    rec["draws"] = {"fe": len(fe_draws), "engine": len(engine),
                    "tracker_rounds": rounds, "mapper_resample": km}
    return rec


def run_torch(args) -> dict:
    """The port's frame K on args.device with the reference's draws from
    args.out/draws.npz; the record of its stages."""
    import torch
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.models.decoders import tree_order
    from pointnerf_slam_torch.outputs.logger import resume_slam

    import pointnerf_slam_torch.engine.tracker as tracker
    path = []
    loss_of = tracker.fused_vg_loss

    def loss_rec(main, decoder, ro, rd, *a):
        """The tracker's loss, recording each iteration's loss, camera
        centre and translation gradient (the rays' origin gradients
        summed, when the backward reaches them)."""
        out = loss_of(main, decoder, ro, rd, *a)
        row = [float(out[0]), *ro[0].detach().double().cpu().tolist()]
        path.append(row)
        if ro.requires_grad:
            ro.register_hook(lambda g: row.extend(
                g.sum(0).double().cpu().tolist()))
        return out
    tracker.fused_vg_loss = loss_rec
    z = np.load(args.ckpt)
    cfg = replay_config(load_config, args, "torch")
    slam = PointNeRFSLAM(cfg, n_frames_cap=len(z["estimate_c2w_list"]),
                         device=args.device, output=args.out)
    start, note = restore(slam, resume_slam, args, z)
    if args.variant == "ulp":
        with torch.no_grad():
            for p in slam.decoder.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, np.inf)))
    fe = slam.frontend
    dev = slam.device
    d = np.load(os.path.join(args.out, "draws.npz"))

    def replay(prefix):
        return [torch.as_tensor(d[n]).to(dev)
                for n in sorted(d.files) if n.startswith(prefix)]
    k = target_frame(start, slam.ecfg.track_every_frame)
    for i in range(start, k):
        _, color, depth, gt = slam.frame_reader[i]
        slam.step(i, color, depth, gt)
    slam.draws = Draws(replay=replay("engine_"))
    fe.draws = Draws(replay=replay("fe_"))
    wrap_map_frame(slam, args, 3)
    seen = {}
    wrap_solve(fe, seen)
    gmed = gate_median(fe)
    c_last = slam.estimate_c2w_list[fe._last_tracked_idx][:3, 3].copy()
    _, color, depth, gt = slam.frame_reader[k]
    slam.step(k, color, depth, gt)
    left = {n: sum(1 for _ in dr._replay)
            for n, dr in (("engine", slam.draws), ("fe", fe.draws))}
    if any(left.values()):
        raise RuntimeError(f"draws left unconsumed: {left}")
    log = next((r for r in slam.frame_log if r["idx"] == k), {})
    ml = log.get("map_losses")
    rec = frame_record(
        slam, k, gmed, c_last,
        float(log["track_first"]) if "track_first" in log else None,
        float(log["track_best"]) if "track_best" in log else None,
        [] if ml is None else [float(x) for x in ml.cpu()], seen)
    rec.update(note=note, start=start, track_path=path)
    sd = slam.decoder.state_dict()
    np.savez(os.path.join(args.out, f"params_{port_name(args)}.npz"),
             **{f"param_{i}": sd[n].detach().cpu().numpy()
                for i, n in enumerate(tree_order(sd))})
    return rec


# -- the comparison (the parent process) ----------------------------------

def mm(a, b):
    if a is None or b is None:
        return None
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))) * 1000


def step_of(rec, c):
    return mm(rec[c], rec["c_last"])


def deg(a, b):
    """The angle (deg) of the rotation a^T b (3, 3), None if either is
    missing (atan2 of its skew and symmetric parts: exact 0 for equal
    matrices, where arccos of the trace of a float32 pose is not)."""
    if a is None or b is None:
        return None
    m = np.asarray(a, np.float64).T @ np.asarray(b, np.float64)
    w = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.degrees(np.arctan2(np.linalg.norm(w) / 2,
                                       (np.trace(m) - 1) / 2)))


def gaps(a, b) -> dict:
    """Per stage: the distance of b's value from a's (centres and steps in
    mm; the tracker's best loss relative)."""
    out = {c: mm(b[c], a[c]) for c in CENTRES}
    for r in ("solve", "refined"):
        out[f"rot_{r}"] = deg(a.get(f"R_{r}"), b.get(f"R_{r}"))
    out["step_d"] = None if a["step_d"] is None or b["step_d"] is None \
        else abs(b["step_d"] - a["step_d"]) * 1000
    ra, rb = step_of(a, "refined"), step_of(b, "refined")
    out["refined_step"] = None if ra is None or rb is None \
        else abs(rb - ra)
    for key in ("track_first", "track_best"):
        out[key] = None if not a[key] or b[key] is None else \
            abs(b[key] - a[key]) / abs(a[key])
    return out


# a tracker path has parted where the two centres lie this far apart (mm)
PART_MM = 0.1


def path_gap(a, b) -> dict | None:
    """The two runs' tracker paths iteration by iteration: the centres'
    distance (mm), the losses' relative gap, the translation gradients'
    cosine; the first iteration where the centres part by more than
    PART_MM (None: they never do); the iteration each run's best-of
    selection takes (its first least loss). None without two recorded
    paths."""
    pa, pb = a.get("track_path"), b.get("track_path")
    if not pa or not pb or len(pa) != len(pb) \
            or any(len(r) != 7 for r in pa + pb):
        return None
    pa, pb = np.asarray(pa), np.asarray(pb)
    ga, gb = pa[:, 4:], pb[:, 4:]
    centre = np.linalg.norm(pa[:, 1:4] - pb[:, 1:4], axis=1) * 1000
    parted = np.flatnonzero(centre > PART_MM)
    return {"centre_mm": centre.tolist(),
            "loss": (np.abs(pb[:, 0] - pa[:, 0]) / np.abs(pa[:, 0])).tolist(),
            "grad_cos": ((ga * gb).sum(1) / np.maximum(
                np.linalg.norm(ga, axis=1) * np.linalg.norm(gb, axis=1),
                1e-30)).tolist(),
            "parts_at": int(parted[0]) if len(parted) else None,
            "best_at": [int(np.argmin(pa[:, 0])), int(np.argmin(pb[:, 0]))]}


def path_line(name, pg) -> str:
    """One run's tracker path against the reference's, in words."""
    c, at = pg["centre_mm"], pg["parts_at"]
    upto = len(c) if at is None else max(at, 1)
    return (f"{name}: centres apart (mm) at iterations 1/5/10/20/{len(c) - 1}"
            f" {' / '.join(fmt(c[i]) for i in (1, 5, 10, 20, len(c) - 1))}"
            f"; part by > {PART_MM} mm at iteration {fmt(at)}; before that "
            f"the loss gap <= {fmt(max(pg['loss'][:upto]))}, the "
            f"translation gradients' cosine >= "
            f"{fmt(min(pg['grad_cos'][:upto]))}; best taken at iterations "
            f"{pg['best_at'][0]} / {pg['best_at'][1]}, there "
            f"{fmt(c[pg['best_at'][0]])} / {fmt(c[pg['best_at'][1]])} mm "
            f"apart")


def param_gap(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    return max(float(np.linalg.norm(a[n] - b[n])
                     / max(np.linalg.norm(b[n]), 1e-30)) for n in b.files)


def fmt(v, unit=""):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}{unit}"
    return f"{v}{unit}"


def print_replay(res: dict, out):
    j, t = res["jax"], res["torch"]
    runs = [("torch", t)] + [(n, res[n]) for n in (*VARIANTS, "torch4")
                             if n in res]
    print(f"frame {res['frame']} from {res['ckpt']} (resumed at "
          f"{j['start']}); draws replayed: {j['draws']}; reference keys "
          f"consumed: {j['keys']}", file=out)
    n = j["note"]
    print(f"step history {[round(x * 1000, 2) for x in n['hist']]} mm, "
          f"last tracked frame {n['last_tracked']} (as resumed; against "
          f"fe2_telemetry the history "
          f"{'agrees' if n['telemetry_hist_agrees'] else 'DIFFERS'}, "
          f"the frame "
          f"{'agrees' if n['telemetry_last_agrees'] else 'DIFFERS'})",
          file=out)
    print("stage | jax | " + " | ".join(f"{r} | {r}-jax" for r, _ in runs)
          + "   (jax2: every key folded, jax4: decoder one ulp up, jax5: "
          "reference keypoints one ulp up, torch4: the port's decoder one "
          "ulp up)", file=out)

    def row(name, get, diff=None):
        """get(rec) -> value; diff(rec_a, rec_b) -> their difference
        (default b - a for numbers)."""
        va = get(j)
        cells = [fmt(va)]
        for _, r in runs:
            vb = get(r)
            d = diff(j, r) if diff else (
                None if not isinstance(va, (int, float))
                or not isinstance(vb, (int, float)) else vb - va)
            cells += [fmt(vb), fmt(d)]
        print(f"{name} | " + " | ".join(cells), file=out)

    for c in CENTRES:
        row(f"c_{c} err vs gt (mm)", lambda r, c=c: mm(r[c], r["c_gt"]),
            lambda a, b, c=c: mm(b[c], a[c]))
        row(f"c_{c} step (mm)", lambda r, c=c: step_of(r, c))
        row(f"R_{c} err vs gt (deg)",
            lambda r, c=c: deg(r.get(f"R_{c}"), r.get("R_gt")),
            lambda a, b, c=c: deg(a.get(f"R_{c}"), b.get(f"R_{c}")))
    for key in FE_KEYS:
        if any(key in r["fe"] for r in (j, *(r for _, r in runs))):
            row(key, lambda r, key=key: r["fe"].get(key))
    row("step_d (mm)", lambda r: None if r["step_d"] is None
        else r["step_d"] * 1000)
    row("decision", lambda r: r["decision"])
    row("gate median (mm)", lambda r: None if r["gate_median"] is None
        else r["gate_median"] * 1000)
    row("tracker first loss", lambda r: r["track_first"])
    row("tracker best loss", lambda r: r["track_best"])
    for name, pg in res.get("paths", {}).items():
        if pg:
            print("tracker path " + path_line(name, pg), file=out)
    if j["map_losses"]:
        row("map loss first", lambda r: r["map_losses"][0])
        row("map loss last", lambda r: r["map_losses"][-1])
        print("max relative parameter difference after mapping from jax | "
              + " | ".join(f"{n} {fmt(v)}" for n, v in
                           res.get("param_gaps", {}).items()), file=out)


def run_package(args, name) -> subprocess.Popen:
    """Start one package's subprocess: "jax", a VARIANTS run of the
    reference, or "torch"; its output goes to DIR/<name>.log."""
    cmd = [sys.executable, os.path.abspath(__file__), "--package",
           "jax" if name.startswith("jax") else "torch", "--ckpt",
           args.ckpt, "--config", args.config, "--device", args.device,
           "--map_iters", str(args.map_iters), "--out", args.out]
    if name in VARIANTS:
        cmd += ["--variant", VARIANTS[name]]
    if name == "torch4":
        cmd += ["--variant", "ulp"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "scripts")]), JAX_PLATFORMS="cpu")
    with open(os.path.join(args.out, f"{name}.log"), "w") as log:
        return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT, text=True)


def result_of(args, proc, name) -> dict:
    rc = 0 if proc is None else proc.wait()
    path = os.path.join(args.out, f"{name}.json")
    if rc or not os.path.exists(path):
        with open(os.path.join(args.out, f"{name}.log")) as fh:
            print(fh.read()[-4000:], file=sys.stderr)
        raise SystemExit(f"{name} failed (exit {rc})")
    with open(path) as fh:
        return json.load(fh)


def compare(args) -> int:
    os.makedirs(args.out, exist_ok=True)
    names = ["jax"] + [n for n, on in (("jax2", args.ref_keys2),
                                       ("jax4", args.ref_ulp),
                                       ("jax5", args.ref_ulp)) if on]

    def start(n):
        done = args.reuse and os.path.exists(
            os.path.join(args.out, f"{n}.json"))
        return None if done else run_package(args, n)
    procs = {n: start(n) for n in names}
    res = {"ckpt": os.path.relpath(args.ckpt, REPO),
           "config": args.config, "map_iters": args.map_iters,
           "jax": result_of(args, procs["jax"], "jax")}
    res["torch"] = result_of(args, start("torch"), "torch")
    if args.port_ulp:
        res["torch4"] = result_of(args, start("torch4"), "torch4")
    res["frame"] = res["jax"]["frame"]
    res["gaps"] = gaps(res["jax"], res["torch"])
    res["spreads"] = {}
    for n in names[1:]:
        res[n] = result_of(args, procs[n], n)
        res["spreads"][n] = gaps(res["jax"], res[n])
    if args.port_ulp:
        # the port's own spread: its run against itself one ulp up
        res["spreads"]["torch4"] = gaps(res["torch"], res["torch4"])
    res["paths"] = {n: path_gap(res["jax"], res[n])
                    for n in ("torch", *names[1:])}
    if args.port_ulp:
        res["paths"]["torch4"] = path_gap(res["torch"], res["torch4"])
    if args.map_iters > 0:
        res["param_gaps"] = {n: param_gap(os.path.join(
            args.out, f"params_{n}.npz"), os.path.join(
                args.out, "params_jax.npz")) for n in ("torch", *names[1:])}
    with open(os.path.join(args.out, "replay.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print_replay(res, sys.stdout)
    return 0


def sign_p(k: int, n: int) -> float:
    """One-sided binomial p of k or more of n at one half."""
    return sum(math.comb(n, i) for i in range(k, n + 1)) / 2.0 ** n


def table(dirs) -> int:
    rows = []
    for d in dirs:
        with open(os.path.join(d, "replay.json")) as fh:
            rows.append(json.load(fh))
    rows.sort(key=lambda r: r["frame"])
    names = [n for n in (*VARIANTS, "torch4") if any(n in r for r in rows)]
    print("frame | decision jax / torch / " + " / ".join(names) + " | "
          + " | ".join(f"{s} gap / " + " / ".join(names)
                       for s in GAP_STAGES)
          + "   (mm; rot_* deg; track_best relative)")
    # frames where the gap exceeds the spread alone (the rule as stated),
    # and the spread and the stage's tolerance
    over = {(s, n, f): [] for s in GAP_STAGES for n in names
            for f in (False, True)}
    # the port's value on the reference's wrong side: its steps shorter,
    # its best tracking loss higher
    worse = {"step_d": 0, "refined_step": 0, "track_best": 0}
    n_cmp = dict.fromkeys(worse, 0)
    for r in rows:
        g, sp = r["gaps"], r.get("spreads", {})
        cells = []
        for st in GAP_STAGES:
            vals = [sp.get(n, {}).get(st) for n in names]
            cells.append(" / ".join(fmt(v) for v in [g.get(st), *vals]))
            for n, v in zip(names, vals):
                if st in FRONT_STAGES and n not in FRONT_VARIANTS:
                    continue
                for floor in (False, True):
                    if g.get(st) is not None and v is not None and g[st] > (
                            max(v, TOL[st]) if floor else v):
                        over[(st, n, floor)].append(r["frame"])
        j, t = r["jax"], r["torch"]
        for key, (a, b), sign in (
                ("step_d", (j["step_d"], t["step_d"]), -1),
                ("refined_step", (step_of(j, "refined"),
                                  step_of(t, "refined")), -1),
                ("track_best", (j["track_best"], t["track_best"]), 1)):
            if a is not None and b is not None and a != b:
                n_cmp[key] += 1
                worse[key] += sign * (b - a) > 0
        dec = " / ".join(r[n]["decision"] if n in r else "-"
                         for n in ("jax", "torch", *names))
        print(f"{r['frame']} | {dec} | " + " | ".join(cells))
    for floor in (False, True):
        print(f"{len(rows)} frames; frames where the port-reference gap "
              "exceeds the reference's own spread"
              + (f" and the stage's test tolerance {TOL}" if floor else "")
              + " (a departure at 3 or more frames; the front-end's stages "
              f"against {FRONT_VARIANTS} only, the variants that perturb "
              "them):")
        for st in GAP_STAGES:
            parts = [f"{n} {len(over[(st, n, floor)])} "
                     f"{over[(st, n, floor)]}" for n in names
                     if not (st in FRONT_STAGES and n not in FRONT_VARIANTS)]
            print(f"  {st}: " + "; ".join(parts))
    for key, what in (("step_d", "shorter"), ("refined_step", "shorter"),
                      ("track_best", "higher")):
        k, n = worse[key], n_cmp[key]
        print(f"  port's {key} {what} than the reference's in {k} of {n} "
              f"frames, one-sided sign-test p = "
              f"{sign_p(k, n) if n else float('nan'):.4g}")
    parts = {}
    for r in rows:
        for n, pg in r.get("paths", {}).items():
            if pg:
                parts.setdefault(n, []).append((r["frame"], pg))
    for n, fp in parts.items():
        at = [pg["parts_at"] for _, pg in fp if pg["parts_at"] is not None]
        other = [f for f, pg in fp if pg["best_at"][0] != pg["best_at"][1]]
        print(f"  tracker paths, {n} against "
              f"{'torch' if n == 'torch4' else 'jax'}: part by > {PART_MM} "
              f"mm at iteration (frame: iteration) "
              + ", ".join(f"{f}: {fmt(pg['parts_at'])}" for f, pg in fp)
              + f"; median {fmt(float(np.median(at))) if at else '-'}, "
              f"never at {len(fp) - len(at)} of {len(fp)}; best taken at "
              f"another iteration at {len(other)} of {len(fp)} {other}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt")
    ap.add_argument("--config", default="configs/Synthetic/"
                    "room_bench_weak.yaml")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--map_iters", type=int, default=0)
    ap.add_argument("--ref_keys2", action="store_true")
    ap.add_argument("--ref_ulp", action="store_true")
    ap.add_argument("--port_ulp", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reuse", action="store_true",
                    help="take a package's DIR/<name>.json where it exists")
    ap.add_argument("--table", nargs="+", default=None, metavar="DIR")
    ap.add_argument("--package", choices=("jax", "torch"), default=None,
                    help=argparse.SUPPRESS)   # one package, in a subprocess
    ap.add_argument("--variant", choices=tuple(VARIANTS.values()),
                    default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.table:
        return table(args.table)
    if not args.ckpt:
        ap.error("--ckpt is required")
    args.ckpt = os.path.abspath(args.ckpt)
    if args.out is None:
        stem = os.path.splitext(os.path.basename(args.ckpt))[0]
        args.out = os.path.join(REPO, "output", "replay", stem)
    args.out = os.path.abspath(args.out)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache_cpu"))
    elif args.package == "torch":
        import torch
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))))
    if args.package:
        rec = (run_jax if args.package == "jax" else run_torch)(args)
        name = ref_name(args) if args.package == "jax" else port_name(args)
        with open(os.path.join(args.out, f"{name}.json"), "w") as fh:
            json.dump(rec, fh, indent=1, default=float)
        return 0
    return compare(args)


if __name__ == "__main__":
    raise SystemExit(main())
