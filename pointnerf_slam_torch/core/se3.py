"""SE(3) / quaternion pose math on torch tensors, differentiable by autograd.

Camera tensor layout [qw qx qy qz tx ty tz]; quaternions need not be unit
(the 2/|q|^2 normalisation lets gradients flow through un-normalised
quaternions, which is what the tracker and bundle adjustment optimise).
All functions are batched over leading dimensions.
"""

from __future__ import annotations

import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # a tensor numerator: `2.0 / x` gets float64 tangents under forward-mode
    # autodiff (torch.func.jacfwd, the front-end's Gauss-Newton)
    n2 = torch.sum(q * q, dim=-1)
    two_s = torch.full_like(n2, 2.0) / n2
    rows = [
        torch.stack([1.0 - two_s * (qj * qj + qk * qk),
                     two_s * (qi * qj - qk * qr),
                     two_s * (qi * qk + qj * qr)], dim=-1),
        torch.stack([two_s * (qi * qj + qk * qr),
                     1.0 - two_s * (qi * qi + qk * qk),
                     two_s * (qj * qk - qi * qr)], dim=-1),
        torch.stack([two_s * (qi * qk - qj * qr),
                     two_s * (qj * qk + qi * qr),
                     1.0 - two_s * (qi * qi + qj * qj)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit quaternion with w >= 0.

    Branchless Shepperd: all four candidates are built and the one anchored
    on the largest of (trace, R00, R11, R22) is kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                     m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                     m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21,
                     1.0 - m00 - m11 + m22], -1),
    ], dim=-2)                                            # (..., 4, 4)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def camera_from_tensor(t: torch.Tensor) -> torch.Tensor:
    """Camera tensor (..., 7) -> (..., 3, 4) pose matrix."""
    R = quat_to_rot(t[..., :4])
    return torch.cat([R, t[..., 4:, None]], dim=-1)


def tensor_from_camera(RT: torch.Tensor, t_first: bool = False
                       ) -> torch.Tensor:
    """(..., 3, 4) or (..., 4, 4) pose -> camera tensor [q | t]."""
    q = rot_to_quat(RT[..., :3, :3])
    trans = RT[..., :3, 3]
    if t_first:
        return torch.cat([trans, q], dim=-1)
    return torch.cat([q, trans], dim=-1)


def to_homogeneous(RT: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) by appending [0 0 0 1]."""
    bottom = torch.zeros(RT.shape[:-2] + (1, 4), dtype=RT.dtype,
                         device=RT.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([RT, bottom], dim=-2)
