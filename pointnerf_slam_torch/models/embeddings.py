"""Positional embeddings: the learnable Gaussian-Fourier sin(x @ B) and
the classic NeRF sin/cos bands.

B ~ N(0, 1) * 25 with 93 columns for the iMAP* decoder. The product x @ B
stays in true float32: B's scale of 25 turns bf16 input rounding into
phase errors of ~0.05 rad through sin(), and TF32 would do the same, so it
is written as explicit multiply-adds rather than a matmul that a backend
might lower to TF32. The order of those multiply-adds matters too: the
embedding is rounded to bf16 next, and one float32 ulp of x . B (~3e-5 at
|x . B| ~ 270) moves ~1% of the bf16 values to a neighbour.
"""

from __future__ import annotations

import torch
from torch import nn


def fourier_project(x: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """x (N, 3) @ B (3, M) -> (N, M) in float32, as the fused
    multiply-add chain fma(x2, B2, fma(x1, B1, x0 * B0)) that XLA's CPU
    dot and the CUDA kernels evaluate. Each fma is one float64 product-sum
    rounded once to float32 (exact products; a double rounding is
    possible but rare)."""
    acc = x[:, 0:1] * B[0]
    for k in range(1, B.shape[0]):
        acc = (x[:, k:k + 1].double() * B[k].double()
               + acc.double()).float()
    return acc


class FourierEmbedding(nn.Module):
    """Holds B (applied by models.decoders.mlp_apply)."""

    def __init__(self, num_input_channels: int = 3, mapping_size: int = 93,
                 scale: float = 25.0, generator=None, device=None):
        super().__init__()
        self.B = nn.Parameter(torch.randn(
            num_input_channels, mapping_size, generator=generator,
            device=device) * scale)



def nerf_positional_embedding(x: torch.Tensor, multires: int,
                              log_sampling: bool = True) -> torch.Tensor:
    """[x, sin(f_1 x), cos(f_1 x), ...] over `multires` frequency bands
    (powers of two, or linearly spaced from 1 to 2^(multires-1)).
    (N, d) -> (N, d * (2 * multires + 1))."""
    if log_sampling:
        freqs = 2.0 ** torch.linspace(0.0, multires - 1, multires)
    else:
        freqs = torch.linspace(2.0 ** 0.0, 2.0 ** (multires - 1), multires)
    outs = [x]
    for f in freqs.tolist():
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)
