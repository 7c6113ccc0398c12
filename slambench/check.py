"""The comparison that decides `correct`: what the timed path produced,
against the plain reference that the cell's configuration names
(`reference/<name>.py`, found by registry.reference), number by number,
each against the limit the cell's file gives it. This file holds what
every scene field shares; the field's own arithmetic (its init, its
renderer, its losses, its optimizer steps, its precisions) is the
reference module's, behind the interface reference/imap.py describes.

Numbers (each the worst over the calls captured in a run):

  init_gap       max |the system's state at construction (every leaf it
                 trains or renders with) - the reference's init from the
                 seed|; exact.
  map_loss1      |L - L_ref| / |L_ref| at the first step of a mapper call.
  map_grad_med   the median leaf's | |g| - |g_ref| | / max(|g_ref|, the
                 median leaf's |g_ref|), at the first step.
  map_change1    the worst leaf's same gap of its change by the first
                 step; leaves whose reference gradient is under a
                 thousandth of the median leaf's are left out (they move by
                 round-off). A step that leaves the state unchanged, or
                 moves it twice or at another rate, reads 1 or more.
  track_loss1, track_grad_med, track_change1
                 the same for a tracker call (leaves: quaternion,
                 translation).
  pose_pick      max |committed c2w - c2w of the camera at the call's lowest
                 loss| over the captured tracker calls whose frame the
                 mapper did not bundle-adjust.
  tri_gap        max relative gap of the camera depth of the triangulated
                 points the reference accepts, against the reference's
                 float64 DLT from the same matches and poses.
  splat_gap      max |stored pseudo-depth - the reference's splat of the
                 same keypoints|; exact.

The check fails closed: where the program's leaves and the reference's
differ by name or by shape (the initial state, or a captured call's first
gradients, its state after the first step or after the last followed),
the numbers that compare them read inf. No leaf is skipped.

The calls' later steps and worst leaves are kept per call in `diag` (the
losses of steps 2 and 3, the worst leaf's gradient gap, each leaf's change
after three steps) and compared nowhere: Adam's fresh first step moves
every element by about its learning rate whatever its gradient's size,
so elements whose gradients sit at rounding level, or at an L1 kink, part
in sign between two computations, and the later steps' losses and
changes part with them; the reference parts so from itself when its start
is moved by one ulp (PERF.md).

The reference computes at the precision the configuration states (its
module's PRECISION), the front-end's geometry and the pose conversion in
float64. With `control`, the reference computed in the next precision
down takes the program's place: the field at its module's CONTROL, the
DLT on TF32 inputs, the splat on bf16 depths, the pose conversion in
bf16.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from .reference import frontend as ref_fe
from .reference.camera import quat_to_rot

TINY = 1e-30
STEPS = 3               # optimizer steps followed a captured call
INF = float("inf")


def _leaf_diff(prog: dict, ref: dict) -> dict | None:
    """None where both hold the same leaves with the same shapes, else
    what differs."""
    shape = {k: tuple(v.shape) for k, v in prog.items()}
    want = {k: tuple(v.shape) for k, v in ref.items()}
    if shape == want:
        return None
    return {"program_only": sorted(set(shape) - set(want)),
            "reference_only": sorted(set(want) - set(shape)),
            "shapes": sorted(k for k in set(shape) & set(want)
                             if shape[k] != want[k])}


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: | |prog| - |ref| | / max(|ref|, the median leaf's |ref|)}."""
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = statistics.median(rn.values())
    return {k: abs(float(prog[k].double().norm()) - rn[k])
            / max(rn[k], med, TINY) for k in leaves}


def _loss_gaps(prog, ref) -> list:
    return [abs(float(p) - r) / max(abs(r), TINY)
            for p, r in zip(prog, ref)]


def _moving(grads: dict) -> list:
    norms = {k: float(v.double().norm()) for k, v in grads.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def map_numbers(cap: dict, c: dict, ref, control: bool,
                diag=None) -> dict:
    want = ref.follow_map(cap, c, STEPS, ref.PRECISION)
    if control:
        prog = ref.follow_map(cap, c, STEPS, ref.CONTROL)
        p_losses, p_grads = prog["losses"], prog["grads1"]
        p_params1, p_params = prog["params1"], prog["params"]
    else:
        p_losses = cap["losses"][:STEPS].tolist()
        p_grads, p_params1, p_params = cap["grads1"], cap["params1"], \
            cap["params3"]
    d = {"loss": _loss_gaps(p_losses, want["losses"])}
    diff = [x for x in (_leaf_diff(p_grads, want["grads1"]),
                        _leaf_diff(p_params1, want["params1"]),
                        _leaf_diff(p_params, want["params"])) if x]
    if diff:
        d["leaves_differ"] = diff
        grad_med = change1 = INF
    else:
        p0 = cap["params0"]
        leaves = list(want["grads1"])
        moving = _moving(want["grads1"])

        def change(a, b):
            return _leaf_gaps(
                {n: a[n].float() - p0[n].float() for n in leaves},
                {n: b[n] - p0[n].float() for n in leaves}, moving)
        d.update(grad=_leaf_gaps(p_grads, want["grads1"], leaves),
                 change1=change(p_params1, want["params1"]),
                 change=change(p_params, want["params"]))
        grad_med = statistics.median(d["grad"].values())
        change1 = max(d["change1"].values())
    if diag is not None:
        diag.append(dict(d, kind="map", idx=cap["idx"],
                         stage=cap.get("stage")))
    return {"map_loss1": d["loss"][0], "map_grad_med": grad_med,
            "map_change1": change1}


def track_numbers(cap: dict, c: dict, ref, control: bool,
                  diag=None) -> dict:
    want = ref.follow_track(cap, c, STEPS, ref.PRECISION)
    cam0 = cap["cam0"].float()
    if control:
        prog = ref.follow_track(cap, c, STEPS, ref.CONTROL)
        p_losses, p_grads = prog["losses"], prog["grads1"]
        p_cam1, p_cam = prog["cam1"], prog["cam"]
    else:
        p_losses = cap["losses"][:STEPS].tolist()
        p_grads, p_cam1, p_cam = cap["grads1"], cap["cam1"], cap["cam3"]

    def split(cam):
        cam = cam.float()
        return {"quad": cam[:4] - cam0[:4], "trans": cam[4:] - cam0[4:]}
    d = {"loss": _loss_gaps(p_losses, want["losses"])}
    diff = _leaf_diff(p_grads, want["grads1"])
    if diff:
        d["leaves_differ"] = [diff]
        grad_med = change1 = INF
    else:
        moving = _moving(want["grads1"])
        d.update(grad=_leaf_gaps(p_grads, want["grads1"], list(p_grads)),
                 change1=_leaf_gaps(split(p_cam1), split(want["cam1"]),
                                    moving),
                 change=_leaf_gaps(split(p_cam), split(want["cam"]),
                                   moving))
        grad_med = statistics.median(d["grad"].values())
        change1 = max(d["change1"].values())
    if diag is not None:
        diag.append(dict(d, kind="track", idx=cap["idx"]))
    return {"track_loss1": d["loss"][0], "track_grad_med": grad_med,
            "track_change1": change1, "pose_pick": pose_pick(cap, control)}


def _c2w(cam: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_to_rot(cam[:4]), cam[4:, None]], 1)


def pose_pick(cap: dict, control: bool = False) -> float | None:
    """The committed pose against the camera the call evaluated at its
    lowest loss (the first such; losses that never fall below 1e10 keep
    the start), converted in float64. The control converts the same
    camera in bfloat16 (the next precision below the pose's float32).
    None where the mapper bundle-adjusted the frame's pose after the
    tracker (capture.py records no committed pose there)."""
    if cap["committed"] is None:
        return None
    best, cam = 1e10, cap["cam0"]
    for loss, c in zip(cap["losses"].tolist(), cap["cams"]):
        if loss < best:
            best, cam = loss, c
    ref = _c2w(cam.double().cpu()).numpy()
    got = _c2w(cam.cpu().to(torch.bfloat16)).double().numpy() if control \
        else cap["committed"][:3, :4]
    return float(np.abs(got - ref).max())


def tri_gap(cap: dict, fx: float, control: bool) -> float | None:
    a = {k: cap[k].detach().double().cpu().numpy()
         for k in ("Tcw_cur", "Tcw_ref", "kpn_cur", "kpn_ref", "pts")}
    ok = cap["ok"].cpu().numpy() & np.isfinite(a["pts"]).all(1)
    ref = ref_fe.triangulate(a["Tcw_cur"], a["Tcw_ref"], a["kpn_cur"],
                             a["kpn_ref"])
    keep = ok & ref_fe.accepted(ref, a["Tcw_cur"], a["Tcw_ref"],
                                a["kpn_cur"], a["kpn_ref"], fx)
    if not keep.any():
        return None
    pts = ref_fe.triangulate(a["Tcw_cur"], a["Tcw_ref"], a["kpn_cur"],
                             a["kpn_ref"], quant="tf32") if control \
        else a["pts"]
    z_ref = ref_fe.camera_depth(ref[keep], a["Tcw_cur"])
    z = ref_fe.camera_depth(pts[keep], a["Tcw_cur"])
    return float((np.abs(z - z_ref) / np.abs(z_ref)).max())


def splat_gap(cap: dict, stored, H: int, W: int, patch: int,
              control: bool) -> float:
    ref = ref_fe.splat(cap["uv"], cap["z"], cap["keep"], H, W, patch)
    prog = ref_fe.splat(cap["uv"], cap["z"], cap["keep"], H, W, patch,
                        quant="bf16") if control else stored
    if prog is None:
        return float("inf")
    return float(np.abs(np.asarray(prog, np.float32) - ref).max())


def _init_gap(got: dict, want: dict) -> float:
    if _leaf_diff(got, want):
        return INF
    return max(float((got[k] - v).abs().max()) for k, v in want.items())


def numbers(run: dict, cfg: dict, seed: int, ref, control: bool = False,
            diag: list | None = None) -> dict:
    """Every number a run's captures give against the reference module
    `ref` (registry.reference); `diag` (a list) collects each call's
    per-step and per-leaf gaps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = ref.consts(cfg)
    out = {}

    def worst(name, v):
        if v is not None:
            out[name] = max(out.get(name, v), v)

    if run.get("init") is not None:
        got = ref.init(seed, cfg, ref.CONTROL) if control else \
            {k: v.cpu().float() for k, v in run["init"].items()}
        worst("init_gap", _init_gap(got, ref.init(seed, cfg,
                                                  ref.PRECISION)))
    for cap in run["map_caps"]:
        for k, v in map_numbers(cap, c, ref, control, diag).items():
            worst(k, v)
    for cap in run["track_caps"]:
        for k, v in track_numbers(cap, c, ref, control, diag).items():
            worst(k, v)
    for cap in run["fe_tris"]:
        worst("tri_gap", tri_gap(cap, cfg["cam"]["fx"], control))
    for cap in run["fe_splats"]:
        worst("splat_gap", splat_gap(
            cap, run["pseudo"].get(cap["idx"]), cfg["cam"]["H"],
            cfg["cam"]["W"], run["patch"], control))
    return out


def judge(nums: dict, limits: dict, require_all: bool = True,
          where_present=()) -> tuple:
    """(correct, lines): every number that has a limit under it and, with
    require_all, present (except those `where_present` names, which a
    window may not produce); one line per limited number, `name value
    limit`. A cell without limits is never correct."""
    ok, lines = bool(limits), []
    for name in sorted(limits):
        v, lim = nums.get(name), limits.get(name)
        if v is None and (not require_all or name in where_present):
            lines.append(f"{name} None limit {lim!r}  (nothing to judge)")
            continue
        good = v is not None and lim is not None and bool(np.isfinite(v)) \
            and v <= lim
        ok &= good
        lines.append(f"{name} {v!r} limit {lim!r}"
                     + ("" if good else "  FAILED"))
    return ok, lines
