"""Single-controller SLAM system: the iMAP* path with sensor depth or,
in weak-depth (RGB-only) mode, with the sparse front-end's pseudo-depth.

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

Not ported yet (each raises NotImplementedError): NICE mode (ROADMAP
Queue 1 item 11), multi-device mapping (item 11, parallel/), 'overlap'
keyframe selection and frustum feature masks (item 11).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.se3_np import (camera_from_tensor_np, interp_c2w_np,
                           tensor_from_camera_np, to_homogeneous_np)
from ..io.config import load_config
from ..io.datasets import get_dataset
from ..models.decoders import get_model
from ..render.renderer import RenderConfig
from ..utils.device import resolve_device
from .mapper import make_mapper_step
from .state import Draws, EngineConfig, KeyframeBuffer
from .tracker import make_tracking_step


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
        self.mesher = None             # outputs.attach_outputs wires both
        self.logger = None
        if cfg.get("nice", False):
            raise NotImplementedError(
                "NICE mode is not ported yet (ROADMAP Queue 1 item 11)")
        want = (cfg.get("parallel", {}) or {}).get("data_devices", "auto")
        if want != "auto" and int(want) > 1:
            raise NotImplementedError(
                "multi-device mapping is not ported yet (ROADMAP Queue 1 "
                "item 11, parallel/)")
        if cfg["mapping"]["keyframe_selection_method"] != "global" \
                or cfg["mapping"].get("frustum_feature_selection", False):
            raise NotImplementedError(
                "'overlap' keyframe selection and frustum masks are not "
                "ported yet (ROADMAP Queue 1 item 11)")

        self._update_cam()
        self._load_bound()
        seed = cfg.get("seed", 1219)
        self.model_cfg, make = get_model(cfg)
        # init on the CPU from a seeded generator, so CPU and CUDA runs
        # start from the same weights
        self.decoder = make(torch.Generator().manual_seed(seed)).to(
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
        # (read by run.py, no sync in step), the host seconds of the
        # front-end, tracking and mapping, and on the card their events
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
        self.timings = {"tracking": 0.0, "mapping": 0.0, "frontend": 0.0}

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
        return torch.as_tensor(tensor_from_camera_np(
            np.asarray(c2w44, np.float32)).astype(np.float32),
            device=self.device)

    @staticmethod
    def _c2w44(cam7) -> np.ndarray:
        c = cam7.detach().cpu().numpy() if torch.is_tensor(cam7) else cam7
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
        u8 = torch.from_numpy(color_u8).to(self.device)
        c = u8.to(torch.float32) / 255.0
        dd = torch.from_numpy(d_u16.astype(np.int32)).to(self.device).to(
            torch.float32) * torch.tensor(q, dtype=torch.float32,
                                          device=self.device)
        self._frame_dev = (idx, c, dd, u8)
        return c, dd, u8

    def _get_mapper_step(self, max_frames: int, outer_fused: bool):
        key = (max_frames, outer_fused)
        if key not in self._mapper_steps:
            self._mapper_steps[key] = make_mapper_step(
                self.model_cfg, self.rcfg, self.ecfg, max_frames,
                outer_fused=outer_fused)
        return self._mapper_steps[key]

    def _select_window(self, refine: bool):
        """'global' selection: random keyframes + the last one."""
        wsize = self.ecfg.mapping_window_size * (2 if refine else 1)
        n_kf = len(self.keyframes)
        if n_kf == 0:
            return []
        chosen = random_select(n_kf - 1, wsize - 2, self.np_rng)
        return sorted(set(int(c) for c in chosen) | {n_kf - 1})

    def _window(self, slots, max_frames, cur_color_u8, cur_depth, cur_cam):
        kf_color, kf_depth, kf_pseudo, kf_cams = self.keyframes.gather_window(
            np.asarray(slots + [0] * (max_frames - 1 - len(slots)), np.int64))
        if self.ecfg.weak_depth:
            kf_depth = kf_pseudo
        valid = np.zeros((max_frames,), bool)
        valid[: len(slots)] = True
        valid[-1] = True
        return (torch.cat([kf_color, cur_color_u8[None]], 0),
                torch.cat([kf_depth, cur_depth[None]], 0),
                torch.cat([kf_cams, cur_cam[None]], 0),
                torch.as_tensor(valid, device=self.device))

    def _clock(self):
        """The start of a phase: host time and, on the card, an event
        recorded on the current stream (never waited for in step)."""
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return time.time(), ev

    def _tick(self, key: str, t0, idx: int) -> None:
        """Add the host seconds since t0 (from _clock) to timings[key] and
        to frame idx's record, without waiting for the device, as the JAX
        reference times its phases. On the card the record also keeps the
        phase's start and end events; device_seconds reads them."""
        host0, ev0 = t0
        dt = time.time() - host0
        self.timings[key] += dt
        if not self.frame_log or self.frame_log[-1]["idx"] != idx:
            self.frame_log.append({"idx": idx})
        rec = self.frame_log[-1]
        rec[f"{key}_s"] = rec.get(f"{key}_s", 0.0) + dt
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
    def _map_frame(self, idx, color, sensor_depth, num_iters, outer_iters,
                   refine=False):
        t0 = self._clock()
        max_frames = (self.ecfg.mapping_window_size * 2 + 1 if refine
                      else self.max_window)
        cur_cam = self._cam7_current(idx)
        _, sensor_dev, cur_u8 = self._upload_frame(idx, color, sensor_depth)
        cur_depth = self._supervising_depth(idx, sensor_dev)
        do_ba = self.ecfg.BA and len(self.keyframes) > 4
        self._log(idx, "ba", do_ba)
        if self.ecfg.fused_outer and not do_ba and outer_iters > 1:
            wins = [self._window(self._select_window(refine), max_frames,
                                 cur_u8, cur_depth, cur_cam)
                    for _ in range(outer_iters)]
            stacked = [torch.stack([w[k] for w in wins]) for k in range(4)]
            ba_o = torch.zeros_like(stacked[3])
            step_fn = self._get_mapper_step(max_frames, True)
            _, losses = step_fn(self.decoder, *stacked, ba_o, self.bound,
                                self.draws, num_iters)
            self._log(idx, "map_losses", losses)
            self.mapping_first_frame_done = True
            self._tick("mapping", t0, idx)
            return
        step_fn = self._get_mapper_step(max_frames, False)
        for _ in range(outer_iters):
            slots = self._select_window(refine)
            colors, depths, cams, valid = self._window(
                slots, max_frames, cur_u8, cur_depth, cur_cam)
            ba_mask = torch.zeros_like(valid)
            if do_ba:
                ba_mask[: len(slots)] = True
                ba_mask[-1] = True
                if slots:
                    ba_mask[int(np.argmin(np.asarray(slots)))] = False
            cams_out, losses = step_fn(self.decoder, colors, depths, cams,
                                       valid, ba_mask, self.bound,
                                       self.draws, num_iters)
            self._log(idx, "map_losses", losses)
            if do_ba:
                for w, slot in enumerate(slots):
                    self.keyframes.est_c2w[slot] = cams_out[w]
                cur_cam = cams_out[-1]
                if self._pending_pose is not None \
                        and self._pending_pose[0] == idx:
                    self._pending_pose = None
                self.estimate_c2w_list[idx] = self._c2w44(cur_cam)
        self.mapping_first_frame_done = True
        self._tick("mapping", t0, idx)

    # -- tracking ---------------------------------------------------------
    def _track_frame(self, idx, color, sensor_depth, gt_c2w):
        """Refine the pose of frame idx; the result stays on the device
        until the end of the step."""
        t0 = self._clock()
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
            self._supervising_depth(idx, depth_dev), self.bound, self.draws)
        gt_cam = self._cam7(gt_c2w)
        self._log(idx, "track_first", first_loss)
        self._log(idx, "track_best", best_loss)
        self._log(idx, "cam_err", (gt_cam - best_cam).abs().mean())
        self._log(idx, "t_err_m", torch.linalg.norm(gt_cam[4:]
                                                    - best_cam[4:]))
        self._pending_pose = (idx, best_cam)
        self._tick("tracking", t0, idx)

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
        if key == "map_losses" and key in rec:
            value = torch.cat([rec[key], value])
        rec[key] = value

    # -- keyframes --------------------------------------------------------
    def _maybe_insert_keyframe(self, idx, color, sensor_depth):
        e = self.ecfg
        want = (idx % e.keyframe_every == 0 or idx == self.n_img - 2
                or (e.weak_depth and idx % e.every_frame == 0))
        if not want or idx in self.keyframes.frame_idx:
            return
        _, depth_dev, color_u8 = self._upload_frame(idx, color, sensor_depth)
        self.keyframes.insert(idx, color_u8, depth_dev,
                              self._cam7_current(idx),
                              pseudo_depth=self.pseudo_depths.get(idx),
                              gt_c2w7=self._cam7(self.gt_c2w_list[idx]))

    # -- main loop ----------------------------------------------------------
    def step(self, idx, color, sensor_depth, gt_c2w):
        """Process one frame (tracking + mapping as scheduled)."""
        e = self.ecfg
        self.gt_c2w_list[idx] = gt_c2w
        if idx == 0:
            self.estimate_c2w_list[0] = gt_c2w
            self._maybe_insert_keyframe(0, color, sensor_depth)
            if not e.weak_depth:
                self._map_frame(0, color, sensor_depth, e.iters_first, 1)
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
                self._map_frame(idx, color, sensor_depth, e.iters_first, 1)
            else:
                self._map_frame(idx, color, sensor_depth,
                                max(e.iters // 3, 1), 3)
            # the mapper's work is queued, not waited for: read the next
            # tracked frame on the host while the device maps, then queue
            # its feature extraction behind the mapper
            if self.frontend is not None and not final:
                nxt = (idx // e.track_every_frame + 1) * e.track_every_frame
                if nxt < self.n_img:
                    t0 = self._clock()
                    self.frontend.prefetch_extract(self.frame_reader, nxt)
                    self._tick("frontend", t0, idx)
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

    def _bootstrap_weak(self, idx):
        """The front-end's two-view bootstrap of frame idx against frame 0;
        a RuntimeError (too little parallax) postpones it."""
        t0 = self._clock()
        try:
            est_c2w, pseudo_ref, pseudo_cur = self.frontend.bootstrap(
                self.frame_reader, 0, idx, self.estimate_c2w_list[0])
        except RuntimeError as err:
            print(f"frontend bootstrap failed at {idx} ({err}); retrying at "
                  f"the next tracked frame", flush=True)
            self.estimate_c2w_list[idx] = self.estimate_c2w_list[idx - 1]
            self._tick("frontend", t0, idx)
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
        self._tick("frontend", t0, idx)

    def _frontend_frame(self, idx):
        """The front-end's continuous solve for tracked frame idx: its pose
        initialises the NeRF tracker, its pseudo-depth supervises it."""
        t0 = self._clock()
        step = self.ecfg.track_every_frame
        est = self.estimate_c2w_list
        if idx - 2 * step >= 0 and self.ecfg.const_speed_assumption:
            pre, prepre = est[idx - step], est[idx - 2 * step]
            est[idx] = pre @ np.linalg.inv(prepre) @ pre
        else:
            est[idx] = est[idx - 1]
        field_ctx = None
        if self.mapping_first_frame_done:
            field_ctx = dict(decoder=self.decoder, c2w_pred=est[idx],
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
        self._tick("frontend", t0, idx)

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
            if on_frame is not None:
                on_frame(self, idx)
        if self.mesher is not None:
            # a run that ends mid-job finishes its periodic mesh
            self.mesher.flush(self)
        return self.estimate_c2w_list, self.gt_c2w_list

