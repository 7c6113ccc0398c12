"""Essential-matrix relative pose by RANSAC with multi-start polish (the
JAX reference's frontend/epipolar.py).

A fixed batch of hypotheses, each the linear 8-point E of 8 drawn
correspondences, is scored by Sampson distance over all matches (MSAC).
Up to 8 MSAC winners whose translation directions lie >= 25 deg apart,
plus one all-match start, are each refit twice (weighted 8-point over
their inliers), decomposed (cheirality vote over the four (R, t)), and
polished by truncated-Huber IRLS Gauss-Newton on SO(3) x S^2; the start
with the most post-polish inliers (cost breaks ties) wins.

Convention: inputs are normalized coords; the result Trc maps
x_ref ~ R x_cur + t with |t| = 1.

The hypothesis draws are an argument, `hyp_idx` (n_hyp, 8): the JAX
reference draws them with jax.random.categorical per split key, which
torch cannot reproduce; `draw_hypotheses` makes them from a torch
generator, and the parity tests pass the reference's draws instead.
Singular vectors carry an arbitrary sign in either package; every use
here is sign-invariant (E up to sign, |t . t'|, the four-way cheirality
vote).
"""

from __future__ import annotations

import math

import torch

from ..utils import tracing

N_HYP = 256
TOPK = 8


def draw_hypotheses(gen: torch.Generator, match_valid: torch.Tensor,
                    n_hyp: int = N_HYP) -> torch.Tensor:
    """(n_hyp, 8) indices drawn uniformly with replacement among the valid
    matches (among all when none is valid)."""
    p = match_valid.to(torch.float32)
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p.expand(n_hyp, -1), 8, replacement=True,
                            generator=gen)
    return idx


def _eye(n, ref):
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


def _to_essential(E: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the essential manifold (s = 1, 1, 0)."""
    with tracing.wait("essential", syncs=2):
        u, _, vt = torch.linalg.svd(E)
    with tracing.wait("essential"):
        s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (u * s) @ vt


def _eight_point(x_cur: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
    """Linear 8-point E from (..., 8, 2) normalized correspondences,
    solving x_ref_h^T E x_cur_h = 0 (E row-major)."""
    xc, yc = x_cur[..., 0], x_cur[..., 1]
    xr, yr = x_ref[..., 0], x_ref[..., 1]
    one = torch.ones_like(xc)
    A = torch.stack([xr * xc, xr * yc, xr, yr * xc, yr * yc, yr, xc, yc,
                     one], dim=-1)
    with tracing.wait("eight_point", syncs=2):
        _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return _to_essential(vt[..., -1, :].reshape(A.shape[:-2] + (3, 3)))


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _sampson_parts(E, x_cur, x_ref):
    xc, xr = _homog(x_cur), _homog(x_ref)
    Exc = xc @ E.transpose(-1, -2)          # E @ x_cur per row
    Etxr = xr @ E                           # E^T @ x_ref per row
    num = (xr * Exc).sum(-1)
    den = Exc[..., 0] ** 2 + Exc[..., 1] ** 2 + Etxr[..., 0] ** 2 \
        + Etxr[..., 1] ** 2
    return num, torch.clamp(den, min=1e-12)


def _sampson(E, x_cur, x_ref):
    """Squared Sampson distance of every match under E (..., 3, 3)."""
    num, den = _sampson_parts(E, x_cur, x_ref)
    return num ** 2 / den


def _signed_sampson(E, x_cur, x_ref):
    """First-order signed Sampson residual (sqrt of `_sampson`)."""
    num, den = _sampson_parts(E, x_cur, x_ref)
    return num / torch.sqrt(den)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp map, Taylor-safe at 0."""
    th2 = (w * w).sum()
    th = torch.sqrt(th2 + 1e-24)
    K = _skew(w)
    a = torch.where(th < 1e-6, torch.ones_like(th), torch.sin(th) / th)
    b = torch.where(th < 1e-6, torch.full_like(th, 0.5),
                    (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-24))
    return _eye(3, w) + a * K + b * (K @ K)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(3, 2) orthonormal basis of the plane normal to unit t."""
    with tracing.wait("tangent_basis"):
        e = _eye(3, t)[torch.argmin(t.abs())]
    b1 = e - t * (e @ t)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1), min=1e-12)
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=-1)


def _unit(t):
    return t / torch.clamp(torch.linalg.norm(t), min=1e-12)


def _gn_polish(R, t, x_cur, x_ref, w, sigma: float, iters: int = 8):
    """Truncated-Huber IRLS Gauss-Newton on (R, t) in SO(3) x S^2 over the
    signed Sampson residuals of E = [t]x R; weights w / max(1, |r|/sigma),
    zero past 3 sigma."""
    for _ in range(iters):
        B = _tangent_basis(t)

        def res(p, R=R, t=t, B=B):
            Rn = R @ _exp_so3(p[:3])
            tn = _unit(t + B @ p[3:])
            return _signed_sampson(_skew(tn) @ Rn, x_cur, x_ref)

        with tracing.span("frontend.gn_polish"):
            p0 = torch.zeros(5, dtype=R.dtype, device=R.device)
            r = res(p0)
            J = torch.func.jacfwd(res)(p0)                  # (M, 5)
            ww = w / torch.clamp(r.abs() / sigma, min=1.0)
            ww = ww * (r.abs() < 3.0 * sigma)
            A = J.T @ (J * ww[:, None]) + 1e-10 * _eye(5, R)
            g = J.T @ (r * ww)
        with tracing.wait("gn_polish"):
            p = -torch.linalg.solve(A, g)
        with tracing.span("frontend.gn_polish"):
            R = R @ _exp_so3(p[:3])
            t = _unit(t + B @ p[3:])
    return R, t


def _triangulate_two_view(R, t, x_cur, x_ref):
    """Depths of each match in both frames under P_ref = [I|0], P_cur =
    [R^T | -R^T t] (DLT null vector). Returns z_ref, z_cur (M,)."""
    from .triangulate import null_vectors
    with tracing.span("frontend.dlt"):
        Rp = R.T
        tp = -R.T @ t
        P0 = torch.cat([_eye(3, R), torch.zeros_like(t)[:, None]], 1)
        P1 = torch.cat([Rp, tp[:, None]], 1)
        A = torch.stack([
            x_ref[:, 0:1] * P0[2] - P0[0],
            x_ref[:, 1:2] * P0[2] - P0[1],
            x_cur[:, 0:1] * P1[2] - P1[0],
            x_cur[:, 1:2] * P1[2] - P1[1]], dim=1)
    X, _ = null_vectors(A)
    with tracing.span("frontend.dlt"):
        w = X[:, 3]
        X = X / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12),
                            w)[:, None]
        return X[:, 2], (X[:, :3] @ Rp.T + tp)[:, 2]


def estimate_relative_pose_ransac(kpn_ref: torch.Tensor,
                                  kpn_cur: torch.Tensor,
                                  match_valid: torch.Tensor,
                                  hyp_idx: torch.Tensor,
                                  thresh: float = 3e-4):
    """RANSAC E-matrix relative pose of matched (M, 2) normalized coords.

    hyp_idx (n_hyp, 8): the matches of each hypothesis. thresh: inlier
    threshold on the Sampson distance. Returns Trc (4, 4) with unit
    translation, inlier_mask (M,), n_inliers."""
    M = kpn_ref.shape[0]
    th2 = thresh ** 2
    Es = _eight_point(kpn_cur[hyp_idx], kpn_ref[hyp_idx])   # (n_hyp, 3, 3)
    d2 = _sampson(Es, kpn_cur, kpn_ref)                      # (n_hyp, M)
    inl = (d2 < th2) & match_valid[None, :]
    msac = torch.where(match_valid[None, :], torch.relu(th2 - d2),
                       torch.zeros_like(d2)).sum(1)

    # MSAC-best-first starts with a >= 25 deg translation-direction gate
    with tracing.wait("ransac", syncs=2):
        t_all = torch.linalg.svd(Es)[0][:, :, 2]             # (n_hyp, 3)
    score = msac.clone()
    cos25 = math.cos(math.radians(25.0))
    top = []
    for _ in range(TOPK):
        b = torch.argmax(score)
        top.append(b)
        with tracing.wait("ransac"):
            close = (t_all @ t_all[b]).abs() > cos25
        score = torch.where(close, torch.full_like(score, -float("inf")),
                            score)
    top = torch.stack(top)

    A_all = (_homog(kpn_ref)[:, :, None] * _homog(kpn_cur)[:, None, :]
             ).reshape(M, 9)
    with tracing.wait("ransac"):
        W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0]], dtype=kpn_ref.dtype,
                         device=kpn_ref.device)
    wv = match_valid.to(kpn_ref.dtype)

    def refit(mask):
        # the 9x9 normal matrix and its eigenvectors in float64: at small
        # baselines its two smallest eigenvalues nearly meet, and a float32
        # product summed in another order than the reference's picks a
        # visibly different null vector (measured: 11 of 200 inliers)
        Aw = A_all.double() * mask.double()[:, None]
        with tracing.wait("ransac_refit"):
            _, vecs = torch.linalg.eigh(Aw.T @ Aw)
        E = _to_essential(vecs[:, 0].to(A_all.dtype).reshape(3, 3))
        return E, (_sampson(E, kpn_cur, kpn_ref) < th2) & match_valid

    def polish_one(mask):
        for _ in range(2):
            E, mask = refit(mask)
        with tracing.wait("ransac_polish", syncs=2):
            u, _, vt = torch.linalg.svd(E)
        u = u * torch.sign(torch.linalg.det(u))
        vt = vt * torch.sign(torch.linalg.det(vt))
        R1, R2, t = u @ W @ vt, u @ W.T @ vt, u[:, 2]
        Rs = torch.stack([R1, R1, R2, R2])
        ts = torch.stack([t, -t, t, -t])
        votes = []
        for R, tt in zip(Rs, ts):
            z_ref, z_cur = _triangulate_two_view(R, tt, kpn_cur, kpn_ref)
            votes.append(((z_ref > 0) & (z_cur > 0) & mask).sum())
        votes = torch.stack(votes)
        b = torch.argmax(votes)
        with tracing.wait("ransac_polish"):
            R = Rs[b]
        with tracing.wait("ransac_polish"):
            t = ts[b]
        with tracing.wait("ransac_polish"):
            dead = votes[b] == 0
        R, t = _gn_polish(R, t, kpn_cur, kpn_ref, wv, thresh)
        r = _signed_sampson(_skew(t) @ R, kpn_cur, kpn_ref).abs()
        rho = torch.where(r < thresh, 0.5 * r ** 2 / thresh,
                          torch.clamp(r, max=3.0 * thresh) - 0.5 * thresh)
        cost = torch.where(match_valid, rho, torch.zeros_like(rho)).sum()
        n_post = ((r ** 2 < th2) & match_valid).sum()
        n_post = torch.where(dead, torch.full_like(n_post, -1), n_post)
        return R, t, cost, n_post

    # the pool: the diverse MSAC winners, then one all-match start
    outs = [polish_one(m) for m in list(inl[top]) + [match_valid]]
    Rk = torch.stack([o[0] for o in outs])
    tk = torch.stack([o[1] for o in outs])
    costk = torch.stack([o[2] for o in outs])
    npostk = torch.stack([o[3] for o in outs])
    finite = torch.isfinite(Rk).all(dim=(1, 2)) \
        & torch.isfinite(tk).all(dim=1) & torch.isfinite(costk)
    sel = torch.where(finite, npostk.to(costk.dtype) - costk,
                      torch.full_like(costk, -float("inf")))
    b = torch.argmax(sel)
    with tracing.wait("ransac"):
        R = Rk[b]
    with tracing.wait("ransac"):
        t = tk[b]
    inlier_mask = (_sampson(_skew(t) @ R, kpn_cur, kpn_ref) < th2) \
        & match_valid
    Trc = _eye(4, R).clone()
    Trc[:3, :3] = R
    Trc[:3, 3] = t
    return Trc, inlier_mask, inlier_mask.sum()
