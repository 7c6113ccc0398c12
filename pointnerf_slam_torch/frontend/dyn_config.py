"""Runtime-adaptive front-end thresholds
(capability of src/slam_dynamic_config.py:9-38: exponentially-weighted
moving averages of the descriptor-distance sigma (MAD) and the reprojection
error, used to adapt matching gates).

A numpy-only copy of the JAX reference package's frontend/dyn_config.py
(the port imports nothing of that package)."""

from __future__ import annotations

import dataclasses

import numpy as np


def descriptor_sigma_mad(distances: np.ndarray) -> float:
    """Robust sigma of descriptor distances via the median absolute
    deviation (capability of utils_features.descriptor_sigma_mad,
    src/utils/utils_features.py:137-160)."""
    d = np.asarray(distances)
    if d.size == 0:
        return 0.0
    med = np.median(d)
    return 1.4826 * float(np.median(np.abs(d - med)))


@dataclasses.dataclass
class SLAMDynamicConfig:
    ewma_alpha: float = 0.3
    max_descriptor_distance: float = 0.7
    max_reproj_distance: float = 3.0

    def update_descriptor_stat(self, match_distances: np.ndarray):
        if np.asarray(match_distances).size == 0:
            return self.max_descriptor_distance
        return self.update_descriptor_stats(
            float(np.median(match_distances)),
            descriptor_sigma_mad(match_distances))

    def update_descriptor_stats(self, med: float, sigma: float,
                                lo: float = 0.4, hi: float = 0.95):
        """EWMA update from precomputed robust stats (the fused two-view
        step returns median + MAD of the accepted match scores on-device).
        Clamped so sparse/degenerate frames cannot run the gate away."""
        if not (np.isfinite(med) and np.isfinite(sigma)) or med <= 0:
            return self.max_descriptor_distance
        new = med + 3.0 * sigma
        a = self.ewma_alpha
        self.max_descriptor_distance = float(np.clip(
            (1 - a) * self.max_descriptor_distance + a * new, lo, hi))
        return self.max_descriptor_distance

    def update_reproj_err(self, errs: np.ndarray):
        if np.asarray(errs).size == 0:
            return self.max_reproj_distance
        a = self.ewma_alpha
        new = float(np.median(errs)) * 3.0
        self.max_reproj_distance = (
            (1 - a) * self.max_reproj_distance + a * max(new, 1.0))
        return self.max_reproj_distance
