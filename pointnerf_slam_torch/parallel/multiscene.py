"""Multi-scene mapping: one step that maps S independent scenes.

Every scene carries its own decoder, grids, keyframe window, cameras,
bound and draws. The JAX reference (its parallel/multiscene.py) vmaps its
mapper step over a leading scene axis. The port's kernels take one
decoder per launch, so here the scenes run one after another through
the engine's mapper step; batching them into one launch needs a scene axis
in K1/K2's grid with per-scene weight images (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch
from torch import nn


def make_multiscene_mapper_step(model_cfg, rcfg, ecfg, max_frames: int):
    """Returns step(decoders, c_grids, colors, depths, cams, valid, ba_mask,
    bounds, draws, num_iters) -> (decoders, c_grids, cams (S, F, 7),
    losses (S, num_iters)).

    decoders: a list of S decoder modules (updated in place), or the
    (params, buffers) stacks of torch.func.stack_module_state (stack_scenes
    of the modules; updated in place too). c_grids: {} (iMAP*), a list of S
    grid dicts, or one dict of (S, ...) stacks. colors (S, F, H, W, 3) u8,
    depths (S, F, H, W), cams (S, F, 7), valid / ba_mask (S, F), bounds
    (S, 3, 2); draws: S engine Draws, one stream per scene (the reference's
    S keys)."""
    from ..engine.mapper import make_mapper_step
    from ..models.decoders import IMAPDecoder, NICEConfig, NICEDecoder

    base = make_mapper_step(model_cfg, rcfg, ecfg, max_frames)

    def scene_decoder(stacks, s):
        params, buffers = stacks
        make = NICEDecoder if isinstance(model_cfg, NICEConfig) \
            else IMAPDecoder
        dec = make(model_cfg, device=next(iter(params.values())).device)
        with torch.no_grad():
            dec.load_state_dict({**{k: v[s] for k, v in params.items()},
                                 **{k: v[s] for k, v in buffers.items()}})
        return dec

    def step(decoders, c_grids, colors, depths, cams, valid, ba_mask,
             bounds, draws, num_iters: int):
        S = colors.shape[0]
        if len(draws) != S:
            raise ValueError(f"{len(draws)} draw streams for {S} scenes")
        stacked = isinstance(decoders, tuple)
        grids_stacked = isinstance(c_grids, dict)
        cams_out, losses = [], []
        for s in range(S):
            dec = scene_decoder(decoders, s) if stacked else decoders[s]
            if grids_stacked:
                grids = {k: v[s].clone() for k, v in c_grids.items()}
            else:
                grids = c_grids[s]
            c, ls = base(dec, colors[s], depths[s], cams[s], valid[s],
                         ba_mask[s], bounds[s], draws[s], num_iters,
                         grids or None)
            if stacked:
                with torch.no_grad():
                    for k, v in dec.state_dict().items():
                        target = decoders[0] if k in decoders[0] \
                            else decoders[1]
                        target[k][s].copy_(v)
            if grids_stacked:
                with torch.no_grad():
                    for k, v in grids.items():
                        c_grids[k][s].copy_(v)
            cams_out.append(c)
            losses.append(ls)
        return decoders, c_grids, torch.stack(cams_out), torch.stack(losses)

    return step


def stack_scenes(trees):
    """Stack a list of per-scene trees along a new leading axis: modules
    through torch.func.stack_module_state ((params, buffers) stacks),
    tensors with torch.stack, dicts, lists and tuples leaf by leaf."""
    first = trees[0]
    if isinstance(first, nn.Module):
        params, buffers = torch.func.stack_module_state(list(trees))
        return ({k: v.detach() for k, v in params.items()},
                {k: v.detach() for k, v in buffers.items()})
    if isinstance(first, dict):
        return {k: stack_scenes([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_scenes(list(xs)) for xs in zip(*trees))
    return torch.stack([torch.as_tensor(t) for t in trees])
