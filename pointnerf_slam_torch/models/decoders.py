"""Scene decoders: the iMAP* MLP and the NICE grid stack.

  - IMAPDecoder: Fourier embedding -> 4 x (256, ReLU) -> RGBA, the
    flagship decoder (mlp_apply; K5/K6 with MLPConfig.fused).
  - MLP: the general decoder of one NICE level: an embedded point (Fourier,
    'same', NeRF bands or 'fc_relu'), per-block Linear -> ReLU (or leaky
    0.2) -> + fc_c[i](c) where c is the level's grid feature at the point
    (c_dim != 0), skip concatenations of the embedding, concat_feature
    (the fine level also reads the middle grid, gradient stopped), and
    no_xyz (the coarse level: the grid feature is the input). apply_mlp.
  - NICEDecoder: the coarse / middle / fine / colour stack with the staged
    forward apply_nice.

Weights keep the JAX reference's layout ((in, out) matrices, `w`/`b`
names, the same tree), so `params_from_jax` maps its parameter tree onto a
module's state_dict one to one (`grids_from_jax` its NICE grids) and both
packages evaluate identical fields.

Init as the reference: xavier-uniform with gain sqrt(2) for the ReLU layers
and 1 for the linear ones (head, fc_c), zero biases, B ~ N(0, 1) * 25, from
the caller's generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..core.coords import normalize_3d_coordinate
from ..ops.grid_sample import trilinear_sample
from .embeddings import (FourierEmbedding, fourier_project,
                         nerf_positional_embedding)


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
    concat_feature: bool = False
    no_xyz: bool = False      # the grid feature is the input (coarse level)
    grid_len: float = 0.16
    # "bfloat16": hidden and head products take bf16-rounded operands and
    # accumulate in float32, the numerics of the fused kernels
    compute_dtype: str = "float32"
    # K5/K6 (ops/fused_mlp.py) where supports_fused holds; a library-level
    # switch as in the JAX reference (get_model leaves it False, no YAML key)
    fused: bool = False

    @property
    def embedding_size(self) -> int:
        if self.no_xyz:
            return self.hidden_size
        if self.pos_embedding_method in ("fourier", "fc_relu"):
            return 93
        if self.pos_embedding_method == "same":
            return self.dim
        if self.pos_embedding_method == "nerf":
            return self.multires * 6 + self.dim
        raise ValueError(self.pos_embedding_method)

    @property
    def multires(self) -> int:
        """NeRF bands: 10 for the colour level, else 5."""
        return 10 if "color" in self.name else 5

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
                or cfg.pos_embedding_method != "fourier" or cfg.no_xyz:
            raise ValueError(f"IMAPDecoder is the iMAP* decoder (c_dim 0, "
                             f"fourier, no skips, colour head); the general "
                             f"decoder is MLP. Got {cfg}")
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


def _sample_feature(grid, p, bound):
    return trilinear_sample(grid, normalize_3d_coordinate(p, bound))


class MLP(nn.Module):
    """One decoder of the general family (applied by apply_mlp)."""

    def __init__(self, cfg: MLPConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        relu = math.sqrt(2.0)
        if not cfg.no_xyz:
            if cfg.pos_embedding_method == "fourier":
                self.embedder = FourierEmbedding(cfg.dim, 93, 25.0,
                                                 generator, device)
            elif cfg.pos_embedding_method == "fc_relu":
                self.embedder = Dense(cfg.dim, 93, relu, generator, device)
        emb, h = cfg.embedding_size, cfg.hidden_size
        layers, in_dim = [], (h if cfg.no_xyz else emb)
        for i in range(cfg.n_blocks):
            layers.append(Dense(in_dim, h, relu, generator, device))
            # the layer after a skip takes the concatenation
            in_dim = h + ((cfg.c_dim if cfg.no_xyz else emb)
                          if i in cfg.skips else 0)
        self.layers = nn.ModuleList(layers)
        if cfg.c_dim != 0 and not cfg.no_xyz:
            c_in = cfg.c_dim * (2 if cfg.concat_feature else 1)
            self.fc_c = nn.ModuleList(
                Dense(c_in, h, 1.0, generator, device)
                for _ in range(cfg.n_blocks))
        self.out = Dense(h, cfg.out_dim, 1.0, generator, device)

    def forward(self, p, c_grid=None, bound=None):
        return apply_mlp(dict(self.named_parameters()), self.cfg, p, c_grid,
                         bound)


def apply_mlp(p: dict, cfg: MLPConfig, x: torch.Tensor, c_grid=None,
              bound=None) -> torch.Tensor:
    """The decoder of config `cfg` as a function of its state_dict-named
    tensors `p` at points x (N, 3): (N, 4) with a colour head, else (N,).
    c_grid {grid name: (Dx, Dy, Dz, C)} and bound (3, 2) feed the grid
    features (c_dim != 0 or no_xyz)."""
    act = ((lambda t: torch.nn.functional.leaky_relu(t, 0.2))
           if cfg.leaky else torch.relu)
    r = bf16_round if cfg.compute_dtype == "bfloat16" else (lambda t: t)

    def dense(name, t):
        return r(t) @ r(p[f"{name}.w"]) + p[f"{name}.b"]

    c = None
    if cfg.no_xyz:
        c = _sample_feature(c_grid["grid_" + cfg.name], x, bound)
        h = emb = c
    else:
        if cfg.c_dim != 0:
            c = _sample_feature(c_grid["grid_" + cfg.name], x, bound)
            if cfg.concat_feature:
                c_mid = _sample_feature(c_grid["grid_middle"], x, bound)
                c = torch.cat([c, c_mid.detach()], dim=-1)
        if cfg.pos_embedding_method == "fourier":
            emb = torch.sin(fourier_project(x, p["embedder.B"]))
        elif cfg.pos_embedding_method == "same":
            emb = x
        elif cfg.pos_embedding_method == "nerf":
            emb = nerf_positional_embedding(
                x, cfg.multires, log_sampling="color" in cfg.name)
        elif cfg.pos_embedding_method == "fc_relu":
            emb = act(dense("embedder", x))
        else:
            raise ValueError(cfg.pos_embedding_method)
        h = emb
    for i in range(cfg.n_blocks):
        h = act(dense(f"layers.{i}", h))
        if cfg.c_dim != 0 and not cfg.no_xyz:
            h = h + dense(f"fc_c.{i}", c)
        if i in cfg.skips:
            h = torch.cat([emb, h], dim=-1)
    out = dense("out", h)
    return out if cfg.color else out[..., 0]


@dataclasses.dataclass(frozen=True)
class NICEConfig:
    dim: int = 3
    c_dim: int = 32
    hidden_size: int = 32
    coarse: bool = False
    coarse_grid_len: float = 2.0
    middle_grid_len: float = 0.16
    fine_grid_len: float = 0.16
    color_grid_len: float = 0.16
    pos_embedding_method: str = "fourier"

    @property
    def sub_configs(self) -> dict:
        """{level: MLPConfig}: coarse (no_xyz, with `coarse`), middle,
        fine (concat_feature) and colour (RGBA head); 5 blocks, skip 2."""
        common = dict(dim=self.dim, c_dim=self.c_dim,
                      hidden_size=self.hidden_size, skips=(2,), n_blocks=5)
        subs = {}
        if self.coarse:
            subs["coarse"] = MLPConfig(name="coarse", color=False,
                                       no_xyz=True,
                                       grid_len=self.coarse_grid_len,
                                       **common)
        pos = self.pos_embedding_method
        subs["middle"] = MLPConfig(name="middle", color=False,
                                   grid_len=self.middle_grid_len,
                                   pos_embedding_method=pos, **common)
        subs["fine"] = MLPConfig(name="fine", color=False,
                                 grid_len=self.fine_grid_len,
                                 concat_feature=True,
                                 pos_embedding_method=pos, **common)
        subs["color"] = MLPConfig(name="color", color=True,
                                  grid_len=self.color_grid_len,
                                  pos_embedding_method=pos, **common)
        return subs


def apply_nice(params: dict, cfg: NICEConfig, p: torch.Tensor, c_grid: dict,
               stage: str, bound: torch.Tensor) -> torch.Tensor:
    """The staged NICE field at points p (N, 3) -> (N, 4) raw RGBA; the
    geometry stages fill only the occupancy column (coarse: the coarse
    level; middle: the middle level; fine: fine + middle; color: the
    colour level's RGB with fine + middle occupancy). params {level:
    state_dict-named tensors}."""
    subs = cfg.sub_configs

    def level(name):
        return apply_mlp(params[name], subs[name], p, c_grid, bound)

    def occ_only(occ):
        return torch.cat([torch.zeros(p.shape[0], 3, dtype=occ.dtype,
                                      device=occ.device), occ[:, None]], -1)

    if stage == "coarse":
        return occ_only(level("coarse"))
    if stage == "middle":
        return occ_only(level("middle"))
    if stage == "fine":
        fine = level("fine")
        return occ_only(fine + level("middle"))
    if stage == "color":
        fine = level("fine")
        raw = level("color")
        mid = level("middle")
        return torch.cat([raw[:, :3], (fine + mid)[:, None]], dim=-1)
    raise ValueError(stage)


class NICEDecoder(nn.Module):
    """The NICE stack: one MLP per level, as submodules named by level.
    Called as decoder(p, c_grid, stage, bound) -> (N, 4)."""

    def __init__(self, cfg: NICEConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        for name, sub in cfg.sub_configs.items():
            self.add_module(name, MLP(sub, generator, device))

    def params(self) -> dict:
        return {name: dict(m.named_parameters())
                for name, m in self.named_children()}

    def forward(self, p, c_grid, stage, bound):
        return apply_nice(self.params(), self.cfg, p, c_grid, stage, bound)


def get_model(cfg: dict, nice: bool = False):
    """(config, make) with make(generator, device) -> IMAPDecoder, or with
    nice the NICEDecoder of NICEConfig."""
    dim = cfg["data"]["dim"]
    pos = cfg["model"]["pos_embedding_method"]
    if nice:
        gl = cfg["grid_len"]
        ncfg = NICEConfig(dim=dim, c_dim=cfg["model"]["c_dim"],
                          coarse=cfg["coarse"],
                          hidden_size=cfg["model"].get("hidden_size", 32),
                          coarse_grid_len=gl["coarse"],
                          middle_grid_len=gl["middle"],
                          fine_grid_len=gl["fine"],
                          color_grid_len=gl["color"],
                          pos_embedding_method=pos)
        return ncfg, (lambda generator=None, device=None:
                      NICEDecoder(ncfg, generator, device))
    mcfg = MLPConfig(dim=dim, c_dim=0, color=True,
                     hidden_size=cfg["model"].get("hidden_size", 256),
                     skips=(), n_blocks=cfg["model"].get("n_blocks", 4),
                     pos_embedding_method=pos,
                     compute_dtype=cfg["model"].get("compute_dtype",
                                                    "float32"))
    return mcfg, (lambda generator=None, device=None:
                  IMAPDecoder(mcfg, generator, device))


def _flatten(tree, prefix=""):
    """{dotted path: leaf} of a nested dict / list tree."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def params_from_jax(tree) -> dict:
    """JAX parameter tree (numpy leaves; the iMAP* decoder's, or the NICE
    stack's {level: tree}) -> the matching module's state_dict."""
    return {k: torch.as_tensor(np.array(v)).to(torch.float32)
            for k, v in _flatten(tree).items()}


def grids_from_jax(c_grid: dict, device=None) -> dict:
    """JAX NICE grids {name: (Dx, Dy, Dz, C)} -> the port's (same layout)."""
    return {k: torch.as_tensor(np.array(v), dtype=torch.float32,
                               device=device) for k, v in c_grid.items()}


def _path_key(path: str):
    return tuple(int(c) if c.isdigit() else c for c in path.split("."))


def tree_order(state_dict: dict) -> list:
    """The state_dict's keys in the order the JAX reference flattens its
    parameter tree (dict keys sorted at every level, lists in order), e.g.
    embedder.B, then b before w of each layer, then out.b, out.w; NICE
    levels coarse, color, fine, middle. The checkpoint's param_{i} arrays
    follow this order."""
    return sorted(state_dict, key=_path_key)


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of params_from_jax: state_dict -> numpy parameter tree."""
    def build(items):
        if len(items) == 1 and items[0][0] == ():
            return items[0][1]
        groups = {}
        for path, v in items:
            groups.setdefault(path[0], []).append((path[1:], v))
        if all(isinstance(k, int) for k in groups):
            return [build(groups[k]) for k in sorted(groups)]
        return {k: build(g) for k, g in groups.items()}

    return build([(_path_key(k), state_dict[k].detach().cpu().numpy())
                  for k in tree_order(state_dict)])
