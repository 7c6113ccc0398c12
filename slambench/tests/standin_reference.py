"""A stand-in plain reference for the harness's own tests, copied into a
copy of the tree as `reference/standin.py`: it follows every captured call
by handing back what the program itself recorded, and rebuilds the
initial state from the seed with the program's own constructors. It
checks the harness's plumbing for any scene field, not a field's
arithmetic, so it is never a benchmark configuration's reference."""

from __future__ import annotations

import numpy as np
import torch

PRECISION = CONTROL = "program"


def consts(cfg: dict) -> dict:
    return {}


def init(seed: int, cfg: dict, quant) -> dict:
    """The system's state at construction (engine/system.py): the decoder
    from a CPU generator seeded `seed`, the grids from one seeded
    seed + 7 over the scaled bound."""
    from pointnerf_slam_torch.models.decoders import get_model
    from pointnerf_slam_torch.models.grids import init_grids
    nice = bool(cfg.get("nice", False))
    _, make = get_model(cfg, nice=nice)
    out = dict(make(torch.Generator().manual_seed(seed)).named_parameters())
    if nice:
        out.update(init_grids(
            torch.Generator().manual_seed(seed + 7), cfg,
            np.array(cfg["mapping"]["bound"], np.float32) * cfg["scale"]))
    return {k: v.detach() for k, v in out.items()}


def follow_map(cap: dict, c: dict, steps: int, quant) -> dict:
    return {"losses": cap["losses"][:steps].tolist(),
            "grads1": cap["grads1"], "params1": cap["params1"],
            "params": cap["params3"]}


def follow_track(cap: dict, c: dict, steps: int, quant) -> dict:
    return {"losses": cap["losses"][:steps].tolist(),
            "grads1": cap["grads1"], "cam1": cap["cam1"],
            "cam": cap["cam3"]}
