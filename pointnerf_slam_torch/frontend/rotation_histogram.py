"""Orientation-consistency match filtering (the JAX reference's
frontend/rotation_histogram.py; capability of src/rotation_histogram.py:
a 30-bin histogram of match orientation deltas, only matches in the top-3
bins survive)."""

from __future__ import annotations

import math

import torch

NUM_BINS = 30


def filter_matches_with_histogram_orientation(angles_ref, angles_cur,
                                              match_valid,
                                              num_valid_bins: int = 3,
                                              min_keep: int = 0,
                                              min_frac: float = 0.0):
    """Keep matches whose orientation delta falls in the top-k bins.

    min_keep: if fewer matches survive, return match_valid unchanged.
    min_frac: apply the gate only when it keeps at least this share of the
    valid matches (a near-uniform histogram means noise orientations).
    Returns (M,) bool."""
    two_pi = 2.0 * math.pi
    delta = torch.remainder(angles_cur - angles_ref, two_pi)
    bins = (delta / two_pi * NUM_BINS).to(torch.int64).clamp(0, NUM_BINS - 1)
    counts = torch.zeros(NUM_BINS, dtype=torch.int64,
                         device=match_valid.device).index_add_(
        0, bins, match_valid.to(torch.int64))
    thresh = torch.topk(counts, num_valid_bins).values[-1]
    bin_ok = counts >= thresh.clamp(min=1)
    filtered = match_valid & bin_ok[bins]
    if min_keep > 0 or min_frac > 0.0:
        kept = filtered.sum()
        starved = kept < min_keep
        if min_frac > 0.0:
            n_valid = match_valid.sum().clamp(min=1)
            starved = starved | (kept < min_frac * n_valid)
        return torch.where(starved, match_valid, filtered)
    return filtered
