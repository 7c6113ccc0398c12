"""Two-way nearest-neighbour descriptor matching (the JAX reference's
frontend/matching.py): L2 distance on unit descriptors from one dense
product, mutual-NN check, distance threshold. Both sides are padded to a
fixed K with validity masks; the match table has a validity column."""

from __future__ import annotations

import torch


def match_two_way(desc1: torch.Tensor, valid1: torch.Tensor,
                  desc2: torch.Tensor, valid2: torch.Tensor,
                  nn_thresh=0.7):
    """Mutual-NN matching of desc1 (K1, D) against desc2 (K2, D).

    Returns idx2 (K1,) best match in 2 for each 1, match_valid (K1,)
    (mutual NN, below nn_thresh, both ends valid) and scores (K1,)
    distances. argmin takes the first index on ties, as jnp.argmin."""
    sim = (desc1 @ desc2.T).clamp(-1.0, 1.0)
    dmat = torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0))
    dmat = torch.where(valid1[:, None] & valid2[None, :], dmat,
                       torch.full_like(dmat, 1e6))
    idx2 = torch.argmin(dmat, dim=1)
    scores = torch.gather(dmat, 1, idx2[:, None])[:, 0]
    idx1_back = torch.argmin(dmat, dim=0)
    mutual = idx1_back[idx2] == torch.arange(desc1.shape[0],
                                             device=desc1.device)
    match_valid = mutual & (scores < nn_thresh) & valid1 & valid2[idx2]
    return idx2, match_valid, scores
