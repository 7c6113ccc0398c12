"""The system's camera, common to every scene field: a pose tensor
[qw qx qy qz tx ty tz] whose quaternion need not be unit. Imports nothing
of the program."""

from __future__ import annotations

import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z), not necessarily unit -> rotation (3, 3)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    s = 2.0 / (q * q).sum()
    return torch.stack([
        torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w),
                     s * (x * z + y * w)]),
        torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z),
                     s * (y * z - x * w)]),
        torch.stack([s * (x * z - y * w), s * (y * z + x * w),
                     1 - s * (x * x + y * y)])])
