"""Single-controller SLAM system: the iMAP* path with sensor depth or,
in weak-depth (RGB-only) mode, with the sparse front-end's pseudo-depth;
and NICE mode (the feature-grid stack, configs/nice_slam.yaml).

Per-frame schedule (the JAX reference's engine/system.py):
  idx == 0: adopt the gt pose, insert the first keyframe; sensor-depth
            mode init-maps with iters_first (a fresh Adam; lr_first_factor
            has no effect on the iMAP* decoder learning rate, as upstream).
  tracking: sensor-depth mode tracks every frame (or takes the gt pose
            with tracking.gt_camera). Weak mode tracks every
            track_every_frame-th frame:
              - before the bootstrap: the front-end's two-view bootstrap
                against frame 0 (a RuntimeError, too little parallax,
                postpones it to the next tracked frame); then the skipped
                poses are interpolated, frames 0 and idx get their
                pseudo-depth and the first keyframe's slot is back-filled;
              - after it: the motion model at tracked-frame granularity,
                the front-end's continuous solve (field context, pose-init
                override, scale telemetry), then the NeRF tracker on the
                fresh pseudo-depth, then interpolation of the untracked
                frames in between;
            other weak frames copy the previous pose.
  mapping:  idx % every_frame == 0 (and the final frame): keyframe
            insertion (keyframe_every, the second-to-last frame, and every
            mapped frame in weak mode), window selection ('global': random
            keyframes drawn with np.random.default_rng(seed), the same
            draws as the JAX reference), then 3 outers x iters/3 mapping
            iterations (mapping.fused_outer: windows drawn first, then the
            outers back to back); weak mode maps nothing before the
            bootstrap and its first map runs iters_first. Weak supervision
            is the frame's pseudo-depth, or the latest one when the frame
            has none; keyframes supervise with their pseudo-depth slots.
  final frame: colour refine (5 outers, doubled window).

NICE (`nice: True`): the grids (models/grids.init_grids, from a generator
seeded seed + 7, over the scaled bound) beside the NICEDecoder; the
tracker renders the 'color' stage; each mapping call (one outer; the
first with iters_first and lr_first_factor) runs the stage schedule
middle / fine / color split by mapping.middle_iter_ratio and
fine_iter_ratio (a coarse segment first with `coarse`), each stage with
its own learning rates (mapping.stage), cameras bundle-adjusted only at
'color'. mapping.keyframe_selection_method 'overlap' scores every
keyframe by the share of the current frame's back-projected depth
samples it sees and draws the window from those that see any (the same
np_rng draws as the reference; 'global' otherwise), and
frustum_feature_selection masks each grid's update to the current
frame's frustum (models/grids.make_frustum_mask_fn; never the coarse
grid).

Frames go to the device once each, quantised to u8 colour and u16 depth
(step depth_max / 65535) as the keyframe store holds them.

Outputs: with outputs.attach_outputs(slam) the checkpoint logger and
the mesher run after every frame (checkpoints into <output>/ckpts/ at
mapping.ckpt_freq, and before each mapping frame the state up to the
frame before it; mesh cadence, final and eval meshes into
<output>/mesh/); output is data.output, or the `output` argument.
outputs/logger.resume_slam restores a checkpoint into a fresh system,
whose run(start_idx) then continues.

Datasets: every reader of io/datasets.py (synthetic, replica, scannet,
tumrgbd, cofusion, azure). Weak mode's front-end takes SuperPoint where
`superpoint_weights` names a checkpoint that exists, else Harris.

Data parallelism (parallel.data_devices): under an initialised
torch.distributed default group of W processes, one per device (run.py
starts them), "auto" maps over the whole group and an int is clamped to
W; the mapper then splits its ray budget over the ranks and sums the
gradients each iteration (engine/mapper.py `group`). Tracking, the
front-end, keyframe selection and np_rng stay common: every rank makes
the same draws from `draws` and np_rng, and each map call takes its rank's
stream from one draw of the common stream with the rank folded in (the
reference folds the device index into its mapper keys), so every rank
keeps the same decoder, window and trajectory. Only rank 0 writes outputs
(outputs.attach_outputs).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..core.se3 import camera_from_tensor
from ..core.se3_np import (camera_from_tensor_np, interp_c2w_np,
                           tensor_from_camera_np, to_homogeneous_np)
from ..io.config import load_config
from ..io.datasets import get_dataset
from ..models.decoders import get_model
from ..parallel.mapping import data_devices, make_mesh
from ..render.renderer import RenderConfig
from ..utils import tracing
from ..utils.device import resolve_device
from .mapper import make_mapper_step
from .state import Draws, EngineConfig, KeyframeBuffer
from .tracker import make_tracking_step


# the tracer's span of each phase (frame_log and timings keep the keys)
PHASE_SPANS = {"frontend": "frontend", "tracking": "tracker",
               "mapping": "mapper"}


def phase_of(key: str):
    """A method (self, idx, ...) run as phase `key` of frame idx
    (PointNeRFSLAM._phase)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, idx, *args, **kwargs):
            with self._phase(key, idx):
                return fn(self, idx, *args, **kwargs)
        return run
    return wrap


def random_select(length, k, rng: np.random.Generator):
    """k distinct indices from range(length)."""
    return list(rng.permutation(np.arange(length))[: min(length, k)])


class PointNeRFSLAM:
    def __init__(self, cfg: dict | str, args=None, n_frames_cap=None,
                 device=None, output: str | None = None):
        if isinstance(cfg, str):
            cfg = load_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scale = cfg["scale"]
        self.output = output or cfg["data"]["output"]
        self.verbose = cfg.get("verbose", False)
        # outputs.attach_outputs wires the logger, the mesher and the
        # writers (render panels, match panels, trajectory, loss curves)
        self.mesher = None
        self.logger = None
        self.visualizer = None
        self.tracking_visualizer = None
        self.match_visualizer = None
        self.aux_visualizers = []
        # commit a tracked pose to the host table at once, as the tracking
        # panel needs; attach_outputs sets it on every rank, so the ranks'
        # windows stay equal though rank 0 alone draws the panels
        self.commit_tracked_pose = False
        self.group = make_mesh(device=self.device)
        data_devices((cfg.get("parallel", {}) or {}).get("data_devices",
                                                         "auto"),
                     self.group.world_size)

        self._update_cam()
        self._load_bound()
        seed = cfg.get("seed", 1219)
        self.nice = bool(cfg.get("nice", False))
        self.model_cfg, make = get_model(cfg, nice=self.nice)
        # init on the CPU from seeded generators, so CPU and CUDA runs
        # start from the same weights and grids
        self.decoder = make(torch.Generator().manual_seed(seed)).to(
            self.device)
        self.c_grid = {}
        if self.nice:
            from ..models.grids import init_grids
            self.c_grid = init_grids(
                torch.Generator().manual_seed(seed + 7), cfg,
                np.array(cfg["mapping"]["bound"], np.float32) * self.scale,
                self.device)
        self.rcfg = RenderConfig.from_cfg(cfg)
        self.ecfg = EngineConfig.from_cfg(cfg, self.H, self.W, self.fx,
                                          self.fy, self.cx, self.cy)
        self.frame_reader = get_dataset(cfg, args, self.scale)
        self.n_img = len(self.frame_reader)
        if n_frames_cap is not None:
            self.n_img = min(self.n_img, n_frames_cap)
        cap = cfg["data"].get(
            "keyframe_capacity",
            min(self.n_img // max(self.ecfg.every_frame, 1) + 4, 512))
        self.keyframes = KeyframeBuffer(cap, self.H, self.W, self.device)
        self.max_window = self.ecfg.mapping_window_size + 1   # + current
        self._mapper_steps = {}
        self._use_grid_masks = bool(self.nice
                                    and self.ecfg.frustum_feature_selection)
        self._frustum_mask_fns = {}
        self.tracking_step = make_tracking_step(self.model_cfg, self.rcfg,
                                                self.ecfg)
        self.estimate_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)
        self.gt_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)
        self.draws = Draws(torch.Generator(device=self.device).manual_seed(
            seed + 1))
        self.np_rng = np.random.default_rng(seed)
        self.mapping_first_frame_done = False
        self._pending_pose = None      # (idx, device cam7) of a tracked frame
        self._frame_dev = None         # (idx, color f32, depth f32, color u8)
        # per-frame device records: tracking first/best loss, camera error
        # against gt, mapping losses and whether the mapper bundle-adjusted
        # (read by run.py, no sync in step); the host self seconds of the
        # front-end, tracking and mapping (`<phase>_s`), the seconds they
        # waited on the card (`<phase>_wait_s`) and the frame's waits in
        # all (`wait_s`), and on the card the phases' events
        self.frame_log = []
        self.frontend = None
        if self.ecfg.weak_depth and not self.ecfg.gt_camera:
            from ..frontend.frontend import SparseFrontend
            self.frontend = SparseFrontend(cfg, self.H, self.W, self.fx,
                                           self.fy, self.cx, self.cy,
                                           device=self.device)
        self._bootstrapped = not self.ecfg.weak_depth or self.ecfg.gt_camera
        self._pose_init_override = None
        self.pseudo_depths = {}        # frame idx -> device (H, W)
        self.scale_telemetry = []      # per tracked frame (weak mode)
        # host self seconds of each phase, and the seconds each waited on
        # the card ("other": waits in step outside the phases)
        self.timings = {"tracking": 0.0, "mapping": 0.0, "frontend": 0.0}
        self.waits = {"tracking": 0.0, "mapping": 0.0, "frontend": 0.0,
                      "other": 0.0}

    # -- setup ------------------------------------------------------------
    def _update_cam(self):
        """Intrinsics rescale for crop_size / crop_edge."""
        c = self.cfg["cam"]
        self.H, self.W = c["H"], c["W"]
        self.fx, self.fy, self.cx, self.cy = c["fx"], c["fy"], c["cx"], c["cy"]
        if "crop_size" in c:
            ch, cw = c["crop_size"]
            sx, sy = cw / self.W, ch / self.H
            self.fx *= sx
            self.fy *= sy
            self.cx *= sx
            self.cy *= sy
            self.W, self.H = cw, ch
        edge = c["crop_edge"]
        if edge > 0:
            self.H -= 2 * edge
            self.W -= 2 * edge
            self.cx -= edge
            self.cy -= edge

    def _load_bound(self):
        """Scene bound * scale, upper edge rounded up to bound_divisible."""
        b = np.array(self.cfg["mapping"]["bound"], np.float32) * self.scale
        div = self.cfg["grid_len"]["bound_divisible"]
        b[:, 1] = (np.ceil((b[:, 1] - b[:, 0]) / div) * div) + b[:, 0]
        self.bound = torch.as_tensor(b, device=self.device)

    # -- helpers ----------------------------------------------------------
    def _cam7(self, c2w44) -> torch.Tensor:
        cam = tensor_from_camera_np(np.asarray(c2w44, np.float32))
        with tracing.wait("cam7"):
            return torch.as_tensor(cam.astype(np.float32),
                                   device=self.device)

    @staticmethod
    def _c2w44(cam7) -> np.ndarray:
        c = cam7
        if torch.is_tensor(cam7):
            with tracing.wait("c2w44"):
                c = cam7.detach().cpu().numpy()
        return to_homogeneous_np(camera_from_tensor_np(
            np.asarray(c, np.float32))).astype(np.float32)

    def _upload_frame(self, idx: int, color, sensor_depth):
        """One quantised host->device transfer per frame: u8 colour and u16
        depth (exact 0 stays 0), decoded to float32 on the device. Returns
        (color f32, depth f32, color u8), cached for the frame."""
        if self._frame_dev is not None and self._frame_dev[0] == idx:
            return self._frame_dev[1:]
        color_u8 = np.clip(np.asarray(color) * 255, 0, 255).astype(np.uint8)
        d = np.asarray(sensor_depth, np.float32)
        dmax = float(d.max())
        q = dmax / 65535.0 if dmax > 0 else 1.0
        d_u16 = np.round(d / q).astype(np.uint16)
        with tracing.wait("upload_frame"):
            u8 = torch.from_numpy(color_u8).to(self.device)
        with tracing.wait("upload_frame"):
            d_dev = torch.from_numpy(d_u16.astype(np.int32)).to(self.device)
        with tracing.wait("upload_frame"):
            q_dev = torch.tensor(q, dtype=torch.float32, device=self.device)
        c = u8.to(torch.float32) / 255.0
        dd = d_dev.to(torch.float32) * q_dev
        self._frame_dev = (idx, c, dd, u8)
        return c, dd, u8

    def _get_mapper_step(self, max_frames: int, outer_fused: bool,
                         stage: str = "color", lr_factor: float = 1.0):
        key = (max_frames, outer_fused, stage, lr_factor)
        if key not in self._mapper_steps:
            grid_lrs = dec_lr = None
            if self.nice:
                st = self.cfg["mapping"]["stage"][stage]
                grid_lrs = {name: st[f"{name[5:]}_lr"] * lr_factor
                            for name in self.c_grid}
                dec_lr = st["decoders_lr"] * lr_factor
            self._mapper_steps[key] = make_mapper_step(
                self.model_cfg, self.rcfg, self.ecfg, max_frames,
                outer_fused=outer_fused, stage=stage, grid_lrs=grid_lrs,
                decoders_lr=dec_lr, group=self.group)
        return self._mapper_steps[key]

    def _stage_schedule(self, num_iters: int):
        """[(stage, iterations)]: one 'color' stage for iMAP*; NICE splits
        middle / fine / color by middle_iter_ratio and fine_iter_ratio, with
        a coarse segment (a third of the iterations) first with `coarse`."""
        if not self.nice:
            return [("color", num_iters)]
        m = int(num_iters * self.ecfg.middle_iter_ratio)
        f = int(num_iters * self.ecfg.fine_iter_ratio) - m
        c = num_iters - m - f
        stages = [(s, n) for s, n in
                  (("middle", m), ("fine", f), ("color", c)) if n > 0]
        if self.cfg["coarse"] and "grid_coarse" in self.c_grid:
            stages = [("coarse", max(num_iters // 3, 1))] + stages
        return stages

    def _select_window(self, refine: bool, cur_depth=None, cur_c2w=None):
        """Window slots: random keyframes ('global') or, with 'overlap',
        drawn from those that see the current frame; plus the last one."""
        wsize = self.ecfg.mapping_window_size * (2 if refine else 1)
        n_kf = len(self.keyframes)
        if n_kf == 0:
            return []
        if self.ecfg.keyframe_selection_method == "overlap" and n_kf > 1:
            chosen = self._overlap_select(cur_depth, cur_c2w, n_kf - 1,
                                          wsize - 2)
        else:
            chosen = random_select(n_kf - 1, wsize - 2, self.np_rng)
        return sorted(set(int(c) for c in chosen) | {n_kf - 1})

    def _overlap_scores(self, pts: torch.Tensor, n: int) -> np.ndarray:
        """(n,) share of the world points pts (M, 3) that project inside
        each of the first n keyframes' images, 20 pixels from the edge and
        in front of the camera."""
        c2w = camera_from_tensor(self.keyframes.est_c2w[:n])      # (n, 3, 4)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0],
                              device=c2w.device).expand(n, 1, 4)
        w2c = torch.linalg.inv(torch.cat([c2w, bottom], 1))
        pc = torch.einsum("kij,mj->kmi", w2c[:, :3, :3], pts) \
            + w2c[:, None, :3, 3]
        zz = -pc[..., 2]
        zc = zz.clamp(min=1e-5)
        u = pc[..., 0] / zc * self.fx + self.cx
        v = -pc[..., 1] / zc * self.fy + self.cy
        edge = 20
        inside = ((zz > 1e-5) & (u > edge) & (u < self.W - edge)
                  & (v > edge) & (v < self.H - edge))
        share = inside.to(torch.float32).mean(1)
        with tracing.wait("overlap_scores"):
            return share.cpu().numpy()

    def _overlap_select(self, depth, c2w, n_candidates, k, n_samples=16,
                        pixels=100):
        """'overlap' keyframe selection: `pixels` valid pixels of the
        current depth drawn with np_rng, n_samples points each from 0.8 d
        to d + 0.5 along their rays at pose c2w (4, 4); keyframes scored
        by the share of those points they see; k drawn (np_rng
        permutation) from the keyframes with a positive score, in
        descending score order, else k at random."""
        if torch.is_tensor(depth):
            with tracing.wait("overlap_depth"):
                depth_np = depth.cpu().numpy()
        else:
            depth_np = np.asarray(depth)
        valid = np.argwhere(depth_np > 0.01)
        if len(valid) == 0:
            return random_select(n_candidates, k, self.np_rng)
        sel = valid[self.np_rng.integers(0, len(valid), pixels)]
        d = depth_np[sel[:, 0], sel[:, 1]]
        i = sel[:, 1].astype(np.float64)
        j = sel[:, 0].astype(np.float64)
        dirs = np.stack([(i - self.cx) / self.fx, -(j - self.cy) / self.fy,
                         -np.ones_like(i)], -1)
        rays_d = dirs @ c2w[:3, :3].T
        t = np.linspace(0.0, 1.0, n_samples)
        z = (d[:, None] * 0.8) * (1 - t) + (d[:, None] + 0.5) * t
        pts = (c2w[:3, 3] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
        scores = self._overlap_scores(
            torch.as_tensor(pts, dtype=torch.float32, device=self.device),
            n_candidates)
        order = [s for s in np.argsort(scores)[::-1] if scores[s] > 0]
        return list(self.np_rng.permutation(np.array(order, np.int64))[:k]) \
            if order else random_select(n_candidates, k, self.np_rng)

    def _frustum_masks(self, idx, cur_depth) -> dict:
        """{grid name: (Dx, Dy, Dz, 1) mask} of frame idx's frustum at its
        estimated pose (the coarse grid all ones)."""
        from ..models.grids import make_frustum_mask_fn
        with tracing.wait("frustum_pose"):
            c2w = torch.as_tensor(self.estimate_c2w_list[idx],
                                  device=self.device)
        masks = {}
        for name, g in self.c_grid.items():
            if name == "grid_coarse":
                masks[name] = torch.ones(g.shape[:3] + (1,),
                                         device=self.device)
                continue
            if name not in self._frustum_mask_fns:
                self._frustum_mask_fns[name] = make_frustum_mask_fn(
                    g.shape[:3], self.H, self.W, self.fx, self.fy, self.cx,
                    self.cy)
            masks[name] = self._frustum_mask_fns[name](self.bound, c2w,
                                                       cur_depth)
        return masks

    def _window(self, slots, max_frames, cur_color_u8, cur_depth, cur_cam):
        kf_color, kf_depth, kf_pseudo, kf_cams = self.keyframes.gather_window(
            np.asarray(slots + [0] * (max_frames - 1 - len(slots)), np.int64))
        if self.ecfg.weak_depth:
            kf_depth = kf_pseudo
        valid = np.zeros((max_frames,), bool)
        valid[: len(slots)] = True
        valid[-1] = True
        with tracing.wait("window_valid"):
            valid_dev = torch.as_tensor(valid, device=self.device)
        return (torch.cat([kf_color, cur_color_u8[None]], 0),
                torch.cat([kf_depth, cur_depth[None]], 0),
                torch.cat([kf_cams, cur_cam[None]], 0), valid_dev)

    @contextlib.contextmanager
    def _phase(self, key: str, idx: int):
        """One phase of frame idx (a key of `timings`): the tracer's phase
        span, whose host self seconds and waits go to timings, waits and
        frame idx's record, and on the card a pair of events recorded on
        the current stream around it (never waited for in step);
        device_seconds reads them."""
        ev0 = None
        if self.device.type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        with tracing.phase(PHASE_SPANS[key]) as sp:
            yield
        host, wait = sp.self_ns / 1e9, sp.wait_ns / 1e9
        self.timings[key] += host
        self.waits[key] += wait
        if not self.frame_log or self.frame_log[-1]["idx"] != idx:
            self.frame_log.append({"idx": idx})
        rec = self.frame_log[-1]
        rec[f"{key}_s"] = rec.get(f"{key}_s", 0.0) + host
        rec[f"{key}_wait_s"] = rec.get(f"{key}_wait_s", 0.0) + wait
        if ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            rec.setdefault(f"{key}_events", []).append((ev0, ev1))

    @staticmethod
    def device_seconds(rec: dict) -> dict:
        """{phase: seconds} of one frame record on the card: the time
        between each phase's start and end events on the stream. Waits for
        the frame's last event, so call it after step, not inside it."""
        out = {}
        for k, pairs in rec.items():
            if k.endswith("_events"):
                pairs[-1][1].synchronize()
                out[k[:-len("_events")]] = sum(
                    a.elapsed_time(b) for a, b in pairs) / 1e3
        return out

    def _supervising_depth(self, idx: int, sensor_depth_dev):
        """Sensor depth, or in weak mode the frame's pseudo-depth (else the
        latest one, as the reference tracks against the last tracked
        frame's; zeros before the bootstrap)."""
        if not self.ecfg.weak_depth:
            return sensor_depth_dev
        if idx in self.pseudo_depths:
            return self.pseudo_depths[idx]
        if self.pseudo_depths:
            return self.pseudo_depths[max(self.pseudo_depths)]
        return torch.zeros(self.H, self.W, device=self.device)

    # -- mapping ----------------------------------------------------------
    def _mapper_draws(self) -> Draws:
        """The draws of one map call: the common stream at world size 1;
        with W ranks a generator seeded from one draw of the common stream
        (the same on every rank) and the rank."""
        if self.group.world_size == 1:
            return self.draws
        s = self.draws.take(lambda g: torch.randint(
            0, 2 ** 62, (1,), generator=g, device=g.device))
        seed = np.random.SeedSequence([int(s), self.group.rank]
                                      ).generate_state(1, np.uint64)[0]
        return Draws(torch.Generator(device=self.device).manual_seed(
            int(seed)))

    @phase_of("mapping")
    def _map_frame(self, idx, color, sensor_depth, num_iters, outer_iters,
                   refine=False, lr_factor: float = 1.0):
        max_frames = (self.ecfg.mapping_window_size * 2 + 1 if refine
                      else self.max_window)
        if (self.ecfg.keyframe_selection_method == "overlap"
                or self._use_grid_masks):
            # these read the frame's pose on the host
            self._commit_pending_pose()
        cur_cam = self._cam7_current(idx)
        _, sensor_dev, cur_u8 = self._upload_frame(idx, color, sensor_depth)
        cur_depth = self._supervising_depth(idx, sensor_dev)
        grid_masks = (self._frustum_masks(idx, cur_depth)
                      if self._use_grid_masks else None)
        do_ba = self.ecfg.BA and len(self.keyframes) > 4
        self._log(idx, "ba", do_ba)
        draws = self._mapper_draws()

        def select():
            return self._select_window(refine, cur_depth,
                                       self.estimate_c2w_list[idx])

        if (self.ecfg.fused_outer and not self.nice and not do_ba
                and outer_iters > 1):
            with tracing.span("mapper.select"):
                wins = [self._window(select(), max_frames, cur_u8,
                                     cur_depth, cur_cam)
                        for _ in range(outer_iters)]
                stacked = [torch.stack([w[k] for w in wins])
                           for k in range(4)]
            ba_o = torch.zeros_like(stacked[3])
            step_fn = self._get_mapper_step(max_frames, True)
            _, losses = step_fn(self.decoder, *stacked, ba_o, self.bound,
                                draws, num_iters)
            self._log(idx, "map_losses", losses)
            self.mapping_first_frame_done = True
            return
        for _ in range(outer_iters):
            with tracing.span("mapper.select"):
                slots = select()
                colors, depths, cams, valid = self._window(
                    slots, max_frames, cur_u8, cur_depth, cur_cam)
            ba_all = torch.zeros_like(valid)
            if do_ba:
                ba_all[: len(slots)] = True
                ba_all[-1] = True
                if slots:
                    ba_all[int(np.argmin(np.asarray(slots)))] = False
            for stage, n_iters in self._stage_schedule(num_iters):
                # NICE bundle-adjusts only at its colour stage
                ba_mask = (ba_all if stage == "color" or not self.nice
                           else torch.zeros_like(valid))
                step_fn = self._get_mapper_step(max_frames, False, stage,
                                                lr_factor)
                cams, losses = step_fn(self.decoder, colors, depths, cams,
                                       valid, ba_mask, self.bound,
                                       draws, n_iters, self.c_grid,
                                       grid_masks)
                self._log(idx, "map_losses", losses)
            cams_out = cams
            if do_ba:
                for w, slot in enumerate(slots):
                    self.keyframes.est_c2w[slot] = cams_out[w]
                cur_cam = cams_out[-1]
                if self._pending_pose is not None \
                        and self._pending_pose[0] == idx:
                    self._pending_pose = None
                self.estimate_c2w_list[idx] = self._c2w44(cur_cam)
        self.mapping_first_frame_done = True

    # -- tracking ---------------------------------------------------------
    @phase_of("tracking")
    def _track_frame(self, idx, color, sensor_depth, gt_c2w):
        """Refine the pose of frame idx; the result stays on the device
        until the end of the step."""
        if self._pose_init_override is not None:
            init = self._pose_init_override
            self._pose_init_override = None
        elif self.ecfg.const_speed_assumption and idx >= 2:
            pre = self.estimate_c2w_list[idx - 1]
            prepre = self.estimate_c2w_list[idx - 2]
            init = pre @ np.linalg.inv(prepre) @ pre
        else:
            init = self.estimate_c2w_list[idx - 1]
        color_dev, depth_dev, _ = self._upload_frame(idx, color,
                                                     sensor_depth)
        best_cam, best_loss, first_loss, _ = self.tracking_step(
            self.decoder, self._cam7(init), color_dev,
            self._supervising_depth(idx, depth_dev), self.bound, self.draws,
            self.c_grid)
        gt_cam = self._cam7(gt_c2w)
        self._log(idx, "track_first", first_loss)
        self._log(idx, "track_best", best_loss)
        self._log(idx, "cam_err", (gt_cam - best_cam).abs().mean())
        self._log(idx, "t_err_m", torch.linalg.norm(gt_cam[4:]
                                                    - best_cam[4:]))
        self._pending_pose = (idx, best_cam)
        if self.commit_tracked_pose:
            # the panel renders at the committed pose, which the mapper
            # then takes from the host table as well (as the reference)
            self._commit_pending_pose()
        if self.tracking_visualizer is not None:
            self.tracking_visualizer.vis(self, idx, sensor_depth, color,
                                         self.estimate_c2w_list[idx])

    def _commit_pending_pose(self):
        if self._pending_pose is not None:
            idx, cam = self._pending_pose
            self._pending_pose = None
            self.estimate_c2w_list[idx] = self._c2w44(cam)

    def _cam7_current(self, idx):
        if self._pending_pose is not None and self._pending_pose[0] == idx:
            return self._pending_pose[1]
        return self._cam7(self.estimate_c2w_list[idx])

    def _log(self, idx, key, value):
        if not self.frame_log or self.frame_log[-1]["idx"] != idx:
            self.frame_log.append({"idx": idx})
        rec = self.frame_log[-1]
        if key == "map_losses":
            # one mapper event; outputs.draw.loss_log splits them again
            rec["map_sizes"] = rec.get("map_sizes", []) + [value.numel()]
            if key in rec:
                value = torch.cat([rec[key], value])
        rec[key] = value

    # -- keyframes --------------------------------------------------------
    def _maybe_insert_keyframe(self, idx, color, sensor_depth):
        e = self.ecfg
        want = (idx % e.keyframe_every == 0 or idx == self.n_img - 2
                or (e.weak_depth and idx % e.every_frame == 0))
        if not want or idx in self.keyframes.frame_idx:
            return
        with tracing.span("keyframe.insert"):
            _, depth_dev, color_u8 = self._upload_frame(idx, color,
                                                        sensor_depth)
            self.keyframes.insert(idx, color_u8, depth_dev,
                                  self._cam7_current(idx),
                                  pseudo_depth=self.pseudo_depths.get(idx),
                                  gt_c2w7=self._cam7(self.gt_c2w_list[idx]))

    # -- main loop ----------------------------------------------------------
    def step(self, idx, color, sensor_depth, gt_c2w):
        """Process one frame (tracking + mapping as scheduled) under the
        tracer's `step` span; the frame's waits on the card go to its
        record (`wait_s`)."""
        phases = sum(self.waits.values())
        with tracing.frame(idx) as fr:
            self._step(idx, color, sensor_depth, gt_c2w)
        if fr.wait_ns:
            wait = fr.wait_ns / 1e9
            self.waits["other"] += wait - (sum(self.waits.values()) - phases)
            self._log(idx, "wait_s", wait)

    def _step(self, idx, color, sensor_depth, gt_c2w):
        e = self.ecfg
        self.gt_c2w_list[idx] = gt_c2w
        if idx == 0:
            self.estimate_c2w_list[0] = gt_c2w
            self._maybe_insert_keyframe(0, color, sensor_depth)
            if not e.weak_depth:
                self._map_frame(0, color, sensor_depth, e.iters_first, 1,
                                lr_factor=self.cfg["mapping"][
                                    "lr_first_factor"])
            return
        if e.gt_camera:
            self.estimate_c2w_list[idx] = gt_c2w
        elif e.weak_depth:
            tracked = idx % e.track_every_frame == 0
            if tracked and not self._bootstrapped:
                self._bootstrap_weak(idx)
            elif tracked and self.mapping_first_frame_done:
                self._frontend_frame(idx)
                self._track_frame(idx, color, sensor_depth, gt_c2w)
                self._commit_pending_pose()
                if self.scale_telemetry \
                        and self.scale_telemetry[-1]["idx"] == idx:
                    self.scale_telemetry[-1]["c_refined"] = \
                        self.estimate_c2w_list[idx][:3, 3].tolist()
                    self.scale_telemetry[-1]["c_gt"] = \
                        np.asarray(gt_c2w)[:3, 3].tolist()
                self._backfill_poses(idx - e.track_every_frame, idx)
            else:
                self.estimate_c2w_list[idx] = self.estimate_c2w_list[idx - 1]
        else:
            self._track_frame(idx, color, sensor_depth, gt_c2w)
        final = idx == self.n_img - 1
        if (idx % e.every_frame == 0 or final) and self._bootstrapped:
            self._maybe_insert_keyframe(idx, color, sensor_depth)
            if final and e.color_refine:
                self._map_frame(idx, color, sensor_depth, e.iters, 5,
                                refine=True)
            elif e.weak_depth and not self.mapping_first_frame_done:
                self._map_frame(idx, color, sensor_depth, e.iters_first, 1,
                                lr_factor=self.cfg["mapping"][
                                    "lr_first_factor"])
            else:
                outer = 1 if self.nice else 3
                self._map_frame(idx, color, sensor_depth,
                                max(e.iters // outer, 1), outer)
            # the mapper's work is queued, not waited for: read the next
            # tracked frame on the host while the device maps, then queue
            # its feature extraction behind the mapper
            if self.frontend is not None and not final:
                nxt = (idx // e.track_every_frame + 1) * e.track_every_frame
                if nxt < self.n_img:
                    with self._phase("frontend", idx):
                        self.frontend.prefetch_extract(self.frame_reader,
                                                       nxt)
        self._commit_pending_pose()

    # -- weak mode ----------------------------------------------------------
    def _backfill_poses(self, lo: int, hi: int):
        """SE(3) interpolation of the untracked frames strictly between
        two solved frames (the pose copies would cost their full motion)."""
        if hi - lo < 2 or lo < 0:
            return
        a = self.estimate_c2w_list[lo]
        b = self.estimate_c2w_list[hi]
        for k in range(lo + 1, hi):
            self.estimate_c2w_list[k] = interp_c2w_np(a, b,
                                                      (k - lo) / (hi - lo))

    @phase_of("frontend")
    def _bootstrap_weak(self, idx):
        """The front-end's two-view bootstrap of frame idx against frame 0;
        a RuntimeError (too little parallax) postpones it."""
        try:
            est_c2w, pseudo_ref, pseudo_cur = self.frontend.bootstrap(
                self.frame_reader, 0, idx, self.estimate_c2w_list[0])
        except RuntimeError as err:
            if self.group.rank == 0:
                print(f"frontend bootstrap failed at {idx} ({err}); "
                      f"retrying at the next tracked frame", flush=True)
            self.estimate_c2w_list[idx] = self.estimate_c2w_list[idx - 1]
            return
        self._bootstrapped = True
        self.bootstrap_idx = idx
        self.estimate_c2w_list[idx] = est_c2w
        self._backfill_poses(0, idx)
        self.pseudo_depths[0] = pseudo_ref
        self.pseudo_depths[idx] = pseudo_cur
        if 0 in self.keyframes.frame_idx:
            slot = self.keyframes.frame_idx.index(0)
            self.keyframes.pseudo_depth[slot] = pseudo_ref

    @phase_of("frontend")
    def _frontend_frame(self, idx):
        """The front-end's continuous solve for tracked frame idx: its pose
        initialises the NeRF tracker, its pseudo-depth supervises it."""
        step = self.ecfg.track_every_frame
        est = self.estimate_c2w_list
        if idx - 2 * step >= 0 and self.ecfg.const_speed_assumption:
            pre, prepre = est[idx - step], est[idx - 2 * step]
            est[idx] = pre @ np.linalg.inv(prepre) @ pre
        else:
            est[idx] = est[idx - 1]
        field_ctx = None
        if self.mapping_first_frame_done:
            decoder = self.decoder
            if self.nice:
                def decoder(x):
                    return self.decoder(x, self.c_grid, "color", self.bound)
            field_ctx = dict(decoder=decoder, c2w_pred=est[idx],
                             bound=self.bound, rcfg=self.rcfg)
        ref_idx = self.frontend.prev["frame_idx"] \
            if self.frontend.prev is not None else -1
        gt_baseline = None
        if self.ecfg.gt_scale_injection and ref_idx >= 0:
            gt_baseline = float(np.linalg.norm(
                self.gt_c2w_list[idx][:3, 3] - self.gt_c2w_list[ref_idx][:3, 3]))
        est_c2w, pseudo = self.frontend.track_continuous(
            self.frame_reader, idx, est, field_ctx=field_ctx,
            gt_baseline=gt_baseline)
        if est_c2w is not None:
            self._pose_init_override = est_c2w
        if pseudo is not None:
            self.pseudo_depths[idx] = pseudo
        self.scale_telemetry.append({
            "idx": idx, "ref_idx": ref_idx,
            "c_prior": est[idx][:3, 3].tolist(),
            "c_solve": None if est_c2w is None
            else np.asarray(est_c2w)[:3, 3].tolist()})

    def run(self, start_idx: int = 0, on_frame=None):
        """Process frames start_idx .. n_img-1; on_frame(self, idx) after
        each. Returns (estimated, gt) c2w lists."""
        for idx in range(start_idx, self.n_img):
            _, color, depth, gt_c2w = self.frame_reader[idx]
            if (self.logger is not None and idx > 0
                    and idx % self.ecfg.every_frame == 0):
                # bank the state up to idx - 1 before this frame's mapping,
                # as the reference does; a resume from it reruns frame idx
                self.logger.log(self, idx - 1)
            self.step(idx, color, depth, gt_c2w)
            if self.logger is not None:
                self.logger.maybe_log(self, idx)
            if self.mesher is not None:
                self.mesher.maybe_mesh(self, idx)
            if self.visualizer is not None and idx > 0:
                self.visualizer.vis(self, idx, depth, color,
                                    self.estimate_c2w_list[idx])
            if self.match_visualizer is not None:
                self.match_visualizer.vis(self, idx)
            for v in self.aux_visualizers:
                v.vis(self, idx)
            if on_frame is not None:
                on_frame(self, idx)
        if self.mesher is not None:
            # a run that ends mid-job finishes its periodic mesh
            self.mesher.flush(self)
        return self.estimate_c2w_list, self.gt_c2w_list

