"""What the harness records from the system under test, from outside it.

Everything here wraps the system's instance (or, for the two-view
triangulation, the function the front-end's solver looks up), so no file
of the program changes:

  spans     host-clock ranges (name, start, end) around the system's
            `_frontend_frame`, `_track_frame` and `_map_frame` and around
            the harness's own frame reads (only in a traced run), for the
            idle-gap breakdown;
  draws     the system's random draws, tapped in the order the engine
            takes them (pixel indices, regulation uniforms), while a
            capture is armed;
  state     the scene field's whole state (field_state): the decoder's
            parameters under their names and each feature grid under its
            `c_grid` name; the run's initial state, each captured call's
            start and the tracker's constants are copies of it;
  steps     through torch.optim's global step hooks, while a capture is
            armed: the gradients the optimizer gets at the first step
            (each leaf of the state that got one; a leaf without one, such
            as a grid the stage does not sample, is absent), the camera at
            every tracker step and the state the optimizer holds after the
            first and the third step. The mapper's optimizer is the one
            that holds a leaf of the state (not the cameras' under BA);
  calls     the state and the window a mapper call starts from, with its
            stage, learning-rate factor and further arguments (grid
            masks), the camera, frame and supervision a tracker call
            starts from, and what each returned (losses, the kept camera);
  front-end the matches and the pose each two-view triangulation is given
            and the points it returns, and the inputs of each pseudo-depth
            splat.

Captures are armed by `want_map` and `want_track` and the front-end's
while `in_window` holds; otherwise the wrappers only keep the loss tensors
that count failed frames. `want_map` arms the next mapped frame: its
first call of each stage is captured (one call for iMAP*'s single stage;
each of NICE's coarse, middle, fine and colour stages).
"""

from __future__ import annotations

import contextlib
import inspect
import time

import numpy as np
import torch

from pointnerf_slam_torch.engine.state import Draws

KEEP_DRAWS = 8          # takes kept per captured call (three steps' worth)


def field_state(slam) -> dict:
    """Every tensor the system trains or renders its scene field with, by
    name: the decoder's parameters, then each grid of `c_grid` (none for
    iMAP*)."""
    return {**dict(slam.decoder.named_parameters()), **slam.c_grid}


def clone_state(slam) -> dict:
    return {k: v.detach().clone() for k, v in field_state(slam).items()}


class _TapDraws(Draws):
    """The system's draws, passed through; while `log` is a list, each
    taken value is appended to it (up to KEEP_DRAWS)."""

    def __init__(self, inner: Draws):
        self.inner = inner
        self.generator = inner.generator
        self._replay = None
        self.log = None

    def take(self, make):
        value = self.inner.take(make)
        if self.log is not None and len(self.log) < KEEP_DRAWS:
            self.log.append(value)
        return value


class Recorder:
    def __init__(self, slam, traced: bool):
        self.slam = slam
        self.traced = traced
        self.want_map = False
        self.want_track = False
        self.in_window = False
        self.cur_idx = -1
        self.map_caps, self.track_caps = [], []
        self.fe_tris, self.fe_splats = [], []
        self.track_losses = {}          # frame idx -> losses tensor
        self.spans = []                 # (name, start s, end s), wall clock
        self._cap = None                # the armed capture
        self._armed_frame = None        # (frame idx, stages captured)
        self._names = {}                # id -> name in the state, when armed
        self._restore = []

    # -- installation -----------------------------------------------------
    def install(self):
        slam = self.slam
        self.tap = _TapDraws(slam.draws)
        slam.draws = self.tap
        for phase, attr in (("frontend", "_frontend_frame"),
                            ("tracker", "_track_frame"),
                            ("mapper", "_map_frame")):
            setattr(slam, attr, self._spanned(phase, getattr(slam, attr)))
        slam.tracking_step = self._track_step(slam.tracking_step)
        get_step = slam._get_mapper_step

        def get_mapper_step(*args, **kwargs):
            return self._map_step(get_step(*args, **kwargs), get_step, args,
                                  kwargs)
        slam._get_mapper_step = get_mapper_step
        if slam.frontend is not None:
            self._install_frontend(slam.frontend)
        from torch.optim import optimizer as hooks
        self._hooks = [hooks.register_optimizer_step_pre_hook(self._pre),
                       hooks.register_optimizer_step_post_hook(self._post)]

    def _install_frontend(self, fe):
        from pointnerf_slam_torch.frontend import fused_twoview
        tri = fused_twoview.triangulate_points

        def triangulate_points(Tcw_cur, Tcw_ref, kpn_cur, kpn_ref):
            pts, ok = tri(Tcw_cur, Tcw_ref, kpn_cur, kpn_ref)
            if self.in_window:
                self.fe_tris.append({
                    "idx": self.cur_idx, "Tcw_cur": Tcw_cur.detach().clone(),
                    "Tcw_ref": Tcw_ref.detach().clone(),
                    "kpn_cur": kpn_cur.detach().clone(),
                    "kpn_ref": kpn_ref.detach().clone(),
                    "pts": pts.detach().clone(), "ok": ok.detach().clone()})
            return pts, ok
        fused_twoview.triangulate_points = triangulate_points
        self._restore.append((fused_twoview, "triangulate_points", tri))
        splat = fe._splat

        def splat_capture(uv, z, accept):
            out = splat(uv, z, accept)
            if self.in_window:
                self.fe_splats.append({
                    "idx": self.cur_idx, "uv": np.array(uv, np.float32),
                    "z": np.array(z, np.float32),
                    "keep": np.array(accept, bool)})
            return out
        fe._splat = splat_capture

    def uninstall(self):
        for h in self._hooks:
            h.remove()
        for mod, attr, fn in self._restore:
            setattr(mod, attr, fn)
        self._restore = []

    # -- wrappers ---------------------------------------------------------
    def _spanned(self, phase, fn):
        def run(*a, **k):
            with self.span(phase):
                return fn(*a, **k)
        return run

    @contextlib.contextmanager
    def span(self, phase):
        if not self.traced:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((phase, t0 / 1e9, time.time_ns() / 1e9))

    def _map_step(self, fn, get_step, args, kwargs):
        """fn, the step get_step(*args, **kwargs) built, with the
        capture."""
        def run(decoder, colors, depths, cams, valid, ba, bound, draws,
                num_iters, *rest):
            how = self._map_call(get_step, args, kwargs)
            if how is None:
                return fn(decoder, colors, depths, cams, valid, ba, bound,
                          draws, num_iters, *rest)
            further = list(inspect.signature(fn).parameters)[9:]
            first = (lambda t: t[0]) if how["outer_fused"] else (lambda t: t)
            cap = {"kind": "map", "idx": self.cur_idx,
                   "stage": how["stage"], "lr_factor": how["lr_factor"],
                   "params0": self._arm_state(),
                   "colors": first(colors), "depths": first(depths),
                   "cams": first(cams), "valid": first(valid),
                   "ba": first(ba), "bound": bound.detach().clone(),
                   "num_iters": int(num_iters), "draws": [],
                   # the grids are the state (params0): the rest as given
                   "further": {k: v for k, v in zip(further, rest)
                               if v is not self.slam.c_grid},
                   "n_pre": 0, "n_post": 0}
            self._arm(cap)
            try:
                out = fn(decoder, colors, depths, cams, valid, ba, bound,
                         draws, num_iters, *rest)
            finally:
                self._disarm()
            cap["losses"] = out[1]
            self.map_caps.append(cap)
            return out
        return run

    def _map_call(self, get_step, args, kwargs) -> dict | None:
        """The step's arguments (max_frames, outer_fused, stage,
        lr_factor) where this mapper call is to be captured: the armed
        frame's first call of its stage; else None."""
        if self.want_map:
            self.want_map = False
            self._armed_frame = (self.cur_idx, set())
        if self._armed_frame is None or self._armed_frame[0] != self.cur_idx:
            self._armed_frame = None
            return None
        how = inspect.signature(get_step).bind(*args, **kwargs)
        how.apply_defaults()
        if how.arguments["stage"] in self._armed_frame[1]:
            return None
        self._armed_frame[1].add(how.arguments["stage"])
        return how.arguments

    def _track_step(self, fn):
        def run(decoder, cam, color, depth_sup, bound, draws, *rest):
            cap = None
            if self.want_track:
                cap = {"kind": "track", "idx": self.cur_idx,
                       "params": self._arm_state(),
                       "cam0": cam.detach().clone().float(),
                       "color": color, "depth": depth_sup,
                       "bound": bound.detach().clone(), "draws": [],
                       "cams": [], "n_pre": 0, "n_post": 0}
                self._arm(cap)
            try:
                out = fn(decoder, cam, color, depth_sup, bound, draws, *rest)
            finally:
                if cap is not None:
                    self._disarm()
            self.track_losses[self.cur_idx] = out[3]
            if cap is not None:
                cap["losses"], cap["best_cam"] = out[3], out[0]
                self.track_caps.append(cap)
            return out
        return run

    def _arm_state(self) -> dict:
        """A copy of the state, whose tensors the optimizer hooks then know
        by name."""
        state = field_state(self.slam)
        self._names = {id(v): k for k, v in state.items()}
        return {k: v.detach().clone() for k, v in state.items()}

    def _arm(self, cap):
        self._cap = cap
        self.tap.log = cap["draws"]

    def _disarm(self):
        self._cap = None
        self.tap.log = None

    # -- optimizer hooks ----------------------------------------------------
    def _which(self, opt):
        """'map' for an optimizer of the state, 'track' for the camera's."""
        ps = [p for g in opt.param_groups for p in g["params"]]
        if any(id(p) in self._names for p in ps):
            return "map"
        if len(ps) == 2 and ps[0].numel() == 4 and ps[1].numel() == 3:
            return "track"
        return None

    def _state_of(self, opt, grads: bool = False) -> dict:
        """{name: copy} of the optimizer's leaves of the state (their
        gradients, of those that have one)."""
        out = {}
        for g in opt.param_groups:
            for p in g["params"]:
                name = self._names.get(id(p))
                t = p.grad if grads else p
                if name is not None and t is not None:
                    out[name] = t.detach().clone()
        return out

    def _pre(self, opt, args, kwargs):
        cap = self._cap
        if cap is None or self._which(opt) != cap["kind"]:
            return
        if cap["kind"] == "map":
            if cap["n_pre"] == 0:
                cap["grads1"] = self._state_of(opt, grads=True)
        else:
            q, t = (g["params"][0] for g in opt.param_groups)
            cap["cams"].append(torch.cat([q, t]).detach().clone())
            if cap["n_pre"] == 0:
                cap["grads1"] = {"quad": q.grad.detach().clone(),
                                 "trans": t.grad.detach().clone()}
        cap["n_pre"] += 1

    def _post(self, opt, args, kwargs):
        cap = self._cap
        if cap is None or self._which(opt) != cap["kind"]:
            return
        cap["n_post"] += 1
        if cap["n_post"] in (1, 3):
            n = cap["n_post"]
            if cap["kind"] == "map":
                cap[f"params{n}"] = self._state_of(opt)
            else:
                q, t = (g["params"][0] for g in opt.param_groups)
                cap[f"cam{n}"] = torch.cat([q, t]).detach().clone()

    # -- after a frame -----------------------------------------------------
    def note_frame(self, idx: int):
        """Keep the pose the system committed for a captured tracker call;
        None where the mapper bundle-adjusted it after the tracker."""
        log = self.slam.frame_log
        ba = bool(log and log[-1]["idx"] == idx and log[-1].get("ba"))
        for cap in self.track_caps:
            if cap["idx"] == idx and "committed" not in cap:
                cap["committed"] = None if ba else np.array(
                    self.slam.estimate_c2w_list[idx], np.float64)
