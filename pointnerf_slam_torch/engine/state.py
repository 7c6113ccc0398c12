"""Engine state: static config, the device keyframe store, and draws.

`EngineConfig` carries the same field names as the JAX reference's
engine/state.py, so both packages read a YAML config to equal values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import tracing


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters distilled from the YAML config."""
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    # tracking
    tracking_pixels: int = 5000
    num_cam_iters: int = 50
    cam_lr: float = 1e-3
    seperate_LR: bool = False
    w_color_loss_t: float = 0.5
    ignore_edge_W: int = 0
    ignore_edge_H: int = 0
    handle_dynamic: bool = False
    use_color_in_tracking: bool = True
    depth_supervision: bool = True
    weak_depth: bool = True
    gt_camera: bool = False
    const_speed_assumption: bool = True
    # mapping
    mapping_pixels: int = 5000
    mapping_window_size: int = 5
    w_color_loss_m: float = 0.05
    # beyond-surface termination penalty; 0 = the upstream loss
    w_beyond_loss: float = 0.0
    imap_decoders_lr: float = 2e-4
    BA: bool = False
    BA_cam_lr: float = 2e-4
    keyframe_every: int = 50
    every_frame: int = 5
    track_every_frame: int = 5
    iters: int = 300
    iters_first: int = 1500
    color_refine: bool = True
    keyframe_selection_method: str = "global"
    frustum_feature_selection: bool = False
    occupancy: bool = False
    # "auto"/"on": the fused kernels (K1/K2, and the K3/K4 pair where the
    # sampling or the loss needs it); "off": the plain renderer (its
    # decoder on K5/K6 when MLPConfig.fused)
    megakernel: str = "auto"
    sync_method: str = "loose"
    fix_fine: bool = True
    fix_color: bool = False
    middle_iter_ratio: float = 0.4
    fine_iter_ratio: float = 0.6
    # resample-every-K: one pixel batch + one importance z2 per K Adam
    # iterations; rays re-derived from the live cameras every iteration
    map_resample_every: int = 1
    track_resample_every: int = 1
    gt_scale_injection: bool = False
    # 3-outer mapping schedule with a fresh window and Adam per outer
    fused_outer: bool = False
    # BA off: rays built once per round, no ray gradients
    no_ba_fast: bool = False

    @classmethod
    def from_cfg(cls, cfg: dict, H: int, W: int, fx, fy, cx, cy):
        t = cfg["tracking"]
        m = cfg["mapping"]
        return cls(
            H=H, W=W, fx=fx, fy=fy, cx=cx, cy=cy,
            tracking_pixels=t["pixels"], num_cam_iters=t["iters"],
            cam_lr=t["lr"], seperate_LR=t["seperate_LR"],
            w_color_loss_t=t["w_color_loss"],
            ignore_edge_W=t["ignore_edge_W"], ignore_edge_H=t["ignore_edge_H"],
            handle_dynamic=t["handle_dynamic"],
            use_color_in_tracking=t["use_color_in_tracking"],
            depth_supervision=cfg["depth_supervision"],
            weak_depth=cfg["weak_depth"], gt_camera=t["gt_camera"],
            const_speed_assumption=t["const_speed_assumption"],
            mapping_pixels=m["pixels"],
            mapping_window_size=m["mapping_window_size"],
            w_color_loss_m=m["w_color_loss"],
            w_beyond_loss=m.get("w_beyond_loss", 0.0),
            imap_decoders_lr=m["imap_decoders_lr"], BA=m["BA"],
            BA_cam_lr=m["BA_cam_lr"], keyframe_every=m["keyframe_every"],
            every_frame=m["every_frame"],
            track_every_frame=cfg.get("track_every_frame", 1),
            iters=m["iters"], iters_first=m["iters_first"],
            color_refine=m["color_refine"],
            keyframe_selection_method=m["keyframe_selection_method"],
            frustum_feature_selection=m.get("frustum_feature_selection",
                                            False),
            occupancy=cfg["occupancy"], sync_method=cfg["sync_method"],
            megakernel=cfg["rendering"].get("megakernel", "auto"),
            fix_fine=m["fix_fine"], fix_color=m["fix_color"],
            middle_iter_ratio=m["middle_iter_ratio"],
            fine_iter_ratio=m["fine_iter_ratio"],
            map_resample_every=m.get("resample_every", 1),
            track_resample_every=t.get("resample_every", 1),
            gt_scale_injection=t.get("gt_scale_injection", False),
            fused_outer=m.get("fused_outer", False),
            no_ba_fast=m.get("no_ba_fast", False),
        )


class Draws:
    """Where the engine's random draws come from.

    draws.take(make) returns make(generator), or, when built with
    `replay`, the next recorded tensor instead (tests replay the JAX
    reference's draws this way: pixel indices and regulation uniforms, in
    the order the engine consumes them)."""

    def __init__(self, generator: torch.Generator | None = None,
                 replay=None):
        if (generator is None) == (replay is None):
            raise ValueError("give exactly one of generator, replay")
        self.generator = generator
        self._replay = iter(replay) if replay is not None else None

    def take(self, make):
        if self._replay is not None:
            return next(self._replay)
        return make(self.generator)


class KeyframeBuffer:
    """Fixed-capacity keyframe store on the device.

      color (K, H, W, 3) uint8, depth (K, H, W) float32 (sensor depth),
      pseudo_depth (K, H, W) float32 (weak mode's splatted supervision,
      0 where absent), est_c2w and gt_c2w (K, 7) camera tensors (gt is
      only written to checkpoints).
    The host keeps the frame-index list."""

    def __init__(self, capacity: int, H: int, W: int, device):
        self.capacity = capacity
        self.color = torch.zeros(capacity, H, W, 3, dtype=torch.uint8,
                                 device=device)
        self.depth = torch.zeros(capacity, H, W, device=device)
        self.pseudo_depth = torch.zeros(capacity, H, W, device=device)
        self.est_c2w = torch.zeros(capacity, 7, device=device)
        self.gt_c2w = torch.zeros(capacity, 7, device=device)
        self.frame_idx: list = []

    def __len__(self):
        return len(self.frame_idx)

    def insert(self, frame_idx: int, color_u8, depth, est_c2w7,
               pseudo_depth=None, gt_c2w7=None):
        slot = len(self.frame_idx)
        if slot >= self.capacity:
            raise RuntimeError(f"keyframe buffer full ({self.capacity}); "
                               f"raise data.keyframe_capacity")
        self.frame_idx.append(int(frame_idx))
        dev = self.color.device
        self.color[slot] = torch.as_tensor(color_u8, device=dev)
        self.depth[slot] = torch.as_tensor(depth, device=dev)
        if pseudo_depth is not None:
            self.pseudo_depth[slot] = torch.as_tensor(pseudo_depth,
                                                      device=dev)
        self.est_c2w[slot] = torch.as_tensor(est_c2w7, device=dev)
        if gt_c2w7 is not None:
            self.gt_c2w[slot] = torch.as_tensor(gt_c2w7, device=dev)

    def gather_window(self, slots: np.ndarray):
        """(color, depth, pseudo_depth, est_c2w) of the window's slots."""
        with tracing.wait("gather_window"):
            s = torch.as_tensor(np.asarray(slots), dtype=torch.int64,
                                device=self.color.device)
        return (self.color[s], self.depth[s], self.pseudo_depth[s],
                self.est_c2w[s])
