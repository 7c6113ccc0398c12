"""The iMAP* scene decoder: Fourier embedding -> 4 x (256, ReLU) -> RGBA.

Weights keep the JAX reference's layout ((in, out) matrices, `w`/`b`
names), so `params_from_jax` maps its parameter tree onto this module's
state_dict one to one and both packages evaluate identical weights.

Init as the reference: xavier-uniform with gain sqrt(2) for the ReLU layers
and 1 for the head, zero biases, B ~ N(0, 1) * 25.

The NICE grid decoders are not ported yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .embeddings import FourierEmbedding, fourier_project

NICE_TODO = ("NICE mode is not ported yet (ROADMAP Queue 1 item 11: "
             "models/grids.py, ops/grid_sample.py, apply_nice)")


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str = ""
    dim: int = 3
    c_dim: int = 0
    hidden_size: int = 256
    n_blocks: int = 4
    leaky: bool = False
    color: bool = True
    skips: Tuple[int, ...] = ()
    pos_embedding_method: str = "fourier"
    # "bfloat16": hidden and head products take bf16-rounded operands and
    # accumulate in float32, the numerics of the fused kernels
    compute_dtype: str = "float32"
    # K5/K6 (ops/fused_mlp.py) where supports_fused holds; a library-level
    # switch as in the JAX reference (get_model leaves it False, no YAML key)
    fused: bool = False

    @property
    def embedding_size(self) -> int:
        return 93

    @property
    def out_dim(self) -> int:
        return 4 if self.color else 1


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (value), identity gradient in float32."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


class Dense(nn.Module):
    """Weight (in, out) and bias of one layer (applied by mlp_apply)."""

    def __init__(self, in_dim: int, out_dim: int, gain: float,
                 generator=None, device=None):
        super().__init__()
        limit = gain * math.sqrt(6.0 / (in_dim + out_dim))
        w = torch.rand(in_dim, out_dim, generator=generator, device=device)
        self.w = nn.Parameter(w * (2 * limit) - limit)
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))


def mlp_apply(p: dict, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """The decoder as a function of its state_dict-named tensors `p`:
    points (N, 3) -> raw (N, 4). bf16: hidden and head products take
    bf16-rounded operands and accumulate in float32 (autograd-friendly)."""
    r = bf16_round if bf16 else (lambda t: t)
    h = torch.sin(fourier_project(x, p["embedder.B"]))
    i = 0
    while f"layers.{i}.w" in p:
        h = torch.relu(r(h) @ r(p[f"layers.{i}.w"]) + p[f"layers.{i}.b"])
        i += 1
    return r(h) @ r(p["out.w"]) + p["out.b"]


def decoder_apply(cfg: MLPConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The decoder of config `cfg` as a function of its state_dict-named
    tensors `p`: the K5/K6 kernel pair (ops.fused_mlp.fused_imap_mlp) when
    cfg.fused and the kernels cover cfg, else mlp_apply (the JAX
    reference's apply_mlp rule)."""
    if cfg.fused:     # imported here: ops/ imports this module
        from ..ops.fused_mlp import fused_imap_mlp, supports_fused
        if supports_fused(cfg):
            return fused_imap_mlp(p, x)
    return mlp_apply(p, x, cfg.compute_dtype == "bfloat16")


class IMAPDecoder(nn.Module):
    """Points (N, 3) -> raw RGBA (N, 4) (sigma in column 3)."""

    def __init__(self, cfg: MLPConfig, generator=None, device=None):
        super().__init__()
        if cfg.c_dim != 0 or cfg.skips or cfg.leaky or not cfg.color \
                or cfg.pos_embedding_method != "fourier":
            raise NotImplementedError(
                f"only the iMAP* decoder is ported (c_dim=0, fourier, no "
                f"skips, colour head); got {cfg}. {NICE_TODO}")
        self.cfg = cfg
        self.embedder = FourierEmbedding(cfg.dim, cfg.embedding_size, 25.0,
                                         generator, device)
        gain = math.sqrt(2.0)
        dims = [cfg.embedding_size] + [cfg.hidden_size] * cfg.n_blocks
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], gain, generator, device)
            for i in range(cfg.n_blocks))
        self.out = Dense(cfg.hidden_size, cfg.out_dim, 1.0, generator,
                         device)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        return decoder_apply(self.cfg, dict(self.named_parameters()), p)


def get_model(cfg: dict, nice: bool = False):
    """(MLPConfig, make) with make(generator, device) -> IMAPDecoder."""
    if nice:
        raise NotImplementedError(NICE_TODO)
    mcfg = MLPConfig(dim=cfg["data"]["dim"], c_dim=0, color=True,
                     hidden_size=cfg["model"].get("hidden_size", 256),
                     skips=(), n_blocks=cfg["model"].get("n_blocks", 4),
                     pos_embedding_method=cfg["model"][
                         "pos_embedding_method"],
                     compute_dtype=cfg["model"].get("compute_dtype",
                                                    "float32"))
    return mcfg, (lambda generator=None, device=None:
                  IMAPDecoder(mcfg, generator, device))


def params_from_jax(tree) -> dict:
    """JAX parameter tree (numpy leaves) -> IMAPDecoder state_dict."""
    sd = {"embedder.B": torch.as_tensor(np.array(tree["embedder"]["B"]))}
    for i, layer in enumerate(tree["layers"]):
        sd[f"layers.{i}.w"] = torch.as_tensor(np.array(layer["w"]))
        sd[f"layers.{i}.b"] = torch.as_tensor(np.array(layer["b"]))
    sd["out.w"] = torch.as_tensor(np.array(tree["out"]["w"]))
    sd["out.b"] = torch.as_tensor(np.array(tree["out"]["b"]))
    return {k: v.to(torch.float32) for k, v in sd.items()}


def tree_order(state_dict: dict) -> list:
    """The state_dict's keys in the order the JAX reference flattens its
    parameter tree (dict keys sorted at every level, lists in order):
    embedder.B, then b before w of each layer, then out.b, out.w. The
    checkpoint's param_{i} arrays follow this order."""
    n = 1 + max(int(k.split(".")[1]) for k in state_dict
                if k.startswith("layers."))
    return (["embedder.B"]
            + [f"layers.{i}.{leaf}" for i in range(n) for leaf in "bw"]
            + ["out.b", "out.w"])


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of params_from_jax: state_dict -> numpy parameter tree."""
    def npy(k):
        return state_dict[k].detach().cpu().numpy()
    n = 1 + max(int(k.split(".")[1]) for k in state_dict
                if k.startswith("layers."))
    return {"embedder": {"B": npy("embedder.B")},
            "layers": [{"w": npy(f"layers.{i}.w"),
                        "b": npy(f"layers.{i}.b")} for i in range(n)],
            "out": {"w": npy("out.w"), "b": npy("out.b")}}
