"""Plain numpy reference of the weak-depth front-end's geometry: two-view
DLT triangulation and the pseudo-depth patch splat.

  triangulate  each match (x_c, x_r) in normalized coordinates under
               world->camera poses P_c, P_r (3 x 4): the right singular
               vector of [x_c P_c3 - P_c1; y_c P_c3 - P_c2; x_r P_r3 -
               P_r1; y_r P_r3 - P_r2] (float64), dehomogenised.
  accept       positive depth in both views, reprojection under 3 px in
               both, parallax angle above arccos(0.9998).
  splat        every kept keypoint writes its depth into the rows and
               columns [c - p, c + p) around its pixel (integer part of
               the pixel coordinates), or only its own pixel where the
               full patch would cross the border; where writes meet, the
               later keypoint wins.

`quant="tf32"` rounds the DLT's inputs to TF32's 10-bit mantissa, the
control of the front-end's float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np


def _tf32(x: np.ndarray) -> np.ndarray:
    b = np.asarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return b.view(np.float32).astype(np.float64)


def triangulate(Tcw_cur, Tcw_ref, kpn_cur, kpn_ref, quant=None):
    """World points (N, 3) float64 of matches in normalized coordinates."""
    cast = _tf32 if quant == "tf32" else (lambda a: np.asarray(a, np.float64))
    Pc, Pr = cast(Tcw_cur)[:3], cast(Tcw_ref)[:3]
    xc, xr = cast(kpn_cur), cast(kpn_ref)
    A = np.stack([xc[:, 0:1] * Pc[2] - Pc[0], xc[:, 1:2] * Pc[2] - Pc[1],
                  xr[:, 0:1] * Pr[2] - Pr[0], xr[:, 1:2] * Pr[2] - Pr[1]], 1)
    A = np.nan_to_num(A)
    X = np.linalg.svd(A)[2][:, -1, :]
    w = np.where(np.abs(X[:, 3]) > 1e-12, X[:, 3], 1.0)
    return X[:, :3] / w[:, None]


def accepted(pts, Tcw_cur, Tcw_ref, kpn_cur, kpn_ref, fx: float,
             max_px: float = 3.0, cos_max: float = 0.9998) -> np.ndarray:
    """The acceptance gates on float64 points."""
    Tc, Tr = np.asarray(Tcw_cur, np.float64), np.asarray(Tcw_ref, np.float64)
    xc = pts @ Tc[:3, :3].T + Tc[:3, 3]
    xr = pts @ Tr[:3, :3].T + Tr[:3, 3]
    ok = (xc[:, 2] > 0) & (xr[:, 2] > 0)
    zc = np.where(ok, xc[:, 2], 1.0)
    zr = np.where(ok, xr[:, 2], 1.0)
    ec = np.linalg.norm(xc[:, :2] / zc[:, None] - kpn_cur, axis=1) * fx
    er = np.linalg.norm(xr[:, :2] / zr[:, None] - kpn_ref, axis=1) * fx
    cc = -Tc[:3, :3].T @ Tc[:3, 3]
    cr = -Tr[:3, :3].T @ Tr[:3, 3]
    r1, r2 = pts - cc, pts - cr
    cosp = (r1 * r2).sum(1) / np.maximum(
        np.linalg.norm(r1, axis=1) * np.linalg.norm(r2, axis=1), 1e-12)
    return ok & (ec < max_px) & (er < max_px) & (cosp < cos_max)


def camera_depth(pts, Tcw) -> np.ndarray:
    T = np.asarray(Tcw, np.float64)
    return (pts @ T[:3, :3].T + T[:3, 3])[:, 2]


def splat(uv, depth, keep, H: int, W: int, patch: int,
          quant=None) -> np.ndarray:
    """(H, W) float32 pseudo-depth, 0 where nothing landed."""
    out = np.zeros((H, W), np.float32)
    d = np.asarray(depth, np.float32)
    if quant == "bf16":
        b = d.view(np.uint32)
        d = ((b + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(
            np.float32)
    for (u, v), z, k in zip(np.asarray(uv, np.float32), d,
                            np.asarray(keep, bool)):
        if not k:
            continue
        ui, vi = int(u), int(v)
        if v - patch > 0 and u - patch > 0 and v + patch < H \
                and u + patch < W:
            out[vi - patch:vi + patch, ui - patch:ui + patch] = z
        elif 0 < v < H and 0 < u < W:
            out[vi, ui] = z
    return out
