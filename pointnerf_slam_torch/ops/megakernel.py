"""Fused render of a ray batch and its VJP: the two-kernel path.

  fused_render(params, rays_o, rays_d, gt_d, t_reg, bound)
    -> depth (N,), depth_var (N,), color (N, 3), sigma_reg (N, N_samples)

differentiable in params, rays_o and rays_d; gt_d, t_reg and bound get no
gradient (they are data on every call path). Per ray:

  pass 1     sigma at N_samples stratified z over [0.01 * gt_d, far],
             far = clip(AABB exit + 0.01, 0, max(1.2 * gt_d)) with the max
             over the WHOLE batch
  middle     compositing weights, deterministic inverse CDF over the z
             midpoints (N_importance samples), sort of the merged z -> z2
  pass 2     RGBA at z2, composite depth, var = sum w (z - depth)^2, colour
  reg        (with_reg) sigma at N_samples stratified z over
             [0, 0.85 * gt_d] perturbed by the caller's uniforms t_reg

z2 and the regulation z are stop-gradient, so pass 1 carries no gradient.
Decoder products take bf16-rounded operands and accumulate in float32;
x . B stays float32.

CUDA tensors run the hand-written kernels of csrc/megakernel.cu: the
forward launches K3 (replaces the JAX reference's ops/megakernel.py:393
`_make_fwd_kernel`), the backward K4 (:480 `_make_bwd_kernel`) with the
incoming cotangents (gdep, gvar, gcol, gsigr); K4 skips the weight
gradients when no parameter needs one (the tracker). Both run on the
Hopper tile of K1/K2 (csrc/hopper_mlp.cuh: persistent 128-point tiles,
weights streamed as swizzled K-slices, wgmma), bound by the decoder's
bf16 products (~0.17 / ~0.20 ms at the tracker's 5000 x (32 + 12)): K3 is
K2's pass 1, a per-ray middle, K1's forward and a per-ray composite; K4
is K1's launch sequence with the composite VJP as its per-ray step. K3
reads the forward weight image (wf), K4 also the chain's (wc); each
wrapper builds only the image its kernel reads. K3 keeps no pass-2
activations; K4 recomputes pass 2 (as the TPU kernel does) and spills
its bf16 activations only for its own weight gradients, so nothing of
that size lives across the caller's loss. CPU tensors take the plain
version `fused_render_reference` (`plain_z2` then `render_at`),
differentiated by autograd. Anything else raises; there is no fallback
from a failed build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.sampling import ray_far_bound
from ..models.decoders import mlp_apply
from ..render.renderer import clip_far
from ..utils import tracing
from . import build
from .fused_vg import (GRAD_LEN, PARAM_NAMES, _check, _inside, _path,
                       _stream, _unpack_grads, pack_weights,
                       params_of)
from .fused_vg import supports_megakernel  # noqa: F401 (the cover, here
#                                            as in the JAX reference)
from .render_math import importance_z2, reg_zvals, weights, z_pass1


def plain_z2(params: dict, rays_o, rays_d, gt_d, bound, S1: int, SI: int):
    """The merged, sorted sample depths (N, S1 + SI) of the plain version:
    pass-1 sigma at z_pass1, weights, deterministic inverse CDF, sort. No
    gradient."""
    with torch.no_grad():
        gtd = gt_d.detach()[:, None]
        ro, rd = rays_o.detach(), rays_d.detach()
        far = clip_far(ray_far_bound(ro, rd, bound), gt_d.detach())
        z1 = z_pass1(gtd, far[:, None], S1)
        x1 = ro[:, None, :] + rd[:, None, :] * z1[..., None]
        p0 = {k: v.detach() for k, v in params.items()}
        s1 = mlp_apply(p0, x1.reshape(-1, 3), bf16=True)[:, 3].reshape(
            -1, S1)
        s1 = torch.where(_inside(x1, bound), s1, torch.full_like(s1, 100.0))
        dn0 = torch.sqrt(torch.sum(rd * rd, dim=1, keepdim=True))
        return importance_z2(s1, z1, dn0, SI)


def render_at(params: dict, rays_o, rays_d, gt_d, t_reg, bound, z2,
              with_reg: bool):
    """Pass 2 at the given (stop-gradient) z2, the composite (depth, var,
    colour) and, with_reg, sigma at the regulation depths; differentiable
    in params and the rays by autograd: K4's plain version."""
    n = z2.shape[0]
    x2 = rays_o[:, None, :] + rays_d[:, None, :] * z2[..., None]
    raw = mlp_apply(params, x2.reshape(-1, 3), bf16=True).reshape(n, -1, 4)
    sig = torch.where(_inside(x2, bound), raw[..., 3],
                      torch.full_like(raw[..., 3], 100.0))
    dn = torch.sqrt(torch.sum(rays_d * rays_d, dim=1, keepdim=True) + 1e-24)
    w = weights(sig, z2, dn)
    depth = torch.sum(w * z2, dim=1, keepdim=True)
    var = torch.sum(w * (z2 - depth) ** 2, dim=1)
    col = torch.sum(w[..., None] * raw[..., :3], dim=1)
    if with_reg:
        zr = reg_zvals(gt_d.detach()[:, None], t_reg.detach())
        xr = rays_o[:, None, :] + rays_d[:, None, :] * zr[..., None]
        sr = mlp_apply(params, xr.reshape(-1, 3), bf16=True)[:, 3].reshape(
            n, -1)
        sr = torch.where(_inside(xr, bound), sr, torch.full_like(sr, 100.0))
    else:
        sr = torch.zeros(n, t_reg.shape[1], device=z2.device)
    return depth[:, 0], var, col, sr


def fused_render_reference(params: dict, rays_o, rays_d, gt_d, t_reg, bound,
                           S1: int, SI: int, with_reg: bool):
    """Plain version of K3 (forward) whose autograd backward is K4's
    plain version. params: state_dict-named decoder tensors."""
    z2 = plain_z2(params, rays_o, rays_d, gt_d, bound, S1, SI)
    return render_at(params, rays_o, rays_d, gt_d, t_reg, bound, z2,
                     with_reg)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def k3_launch(lib, pw, rays_o, rays_d, gt_d, t_reg, bound, S1: int,
              SI: int, with_reg: bool):
    """K3's C call `mk_forward` of `lib` (csrc/megakernel.cu, or another
    build of it) on buffers prepared once: returns (launch, outputs), each
    launch() runs the kernel and raises on a CUDA error. outputs: outv
    (N, 8) [depth, var, colour, 0...], sigma_reg (N, SR) (zeros without
    reg), z2 (N, S1 + SI), what K4 needs (rays, t_reg, bound, SR launched)
    and the workspace (its pass-1 sigma at byte offset
    `mk_forward_sig1_offset`)."""
    n = rays_o.shape[0]
    SR = t_reg.shape[1]
    SRk = SR if with_reg else 0
    dev = rays_o.device
    far = clip_far(ray_far_bound(rays_o, rays_d, bound), gt_d)
    rays = torch.cat([rays_o.detach(), rays_d.detach(), gt_d[:, None],
                      far[:, None]], dim=1).float().contiguous()
    treg = (t_reg.detach().float().contiguous() if with_reg
            else torch.zeros(n, 1, device=dev))
    b6 = bound.reshape(-1).float().contiguous()
    _check(rays, (n, 8), torch.float32, "rays")
    _check(b6, (6,), torch.float32, "bound")
    if with_reg:
        _check(treg, (n, SR), torch.float32, "t_reg")
    lib.mk_forward_workspace_bytes.restype = ctypes.c_longlong
    lib.mk_forward.restype = ctypes.c_int
    ws = torch.empty(int(lib.mk_forward_workspace_bytes(
        ctypes.c_int(n), ctypes.c_int(S1), ctypes.c_int(SI),
        ctypes.c_int(SRk))), dtype=torch.uint8, device=dev)
    outv = torch.empty(n, 8, device=dev)
    sigr = (torch.empty(n, SR, device=dev) if with_reg
            else torch.zeros(n, SR, device=dev))
    z2 = torch.empty(n, S1 + SI, device=dev)
    pw = pw.with_images(chain=False)
    args = (pw.pointers(), _ptr(rays), _ptr(treg), _ptr(b6), _ptr(ws),
            _ptr(outv), _ptr(sigr), _ptr(z2), ctypes.c_int(n),
            ctypes.c_int(S1), ctypes.c_int(SI), ctypes.c_int(SRk),
            _stream(rays))

    def launch():
        build.check(lib, lib.mk_forward(*args), "mk_forward")
    # the launch keeps every buffer it points at alive
    launch.keep = (pw, rays, treg, b6, ws, outv, sigr, z2)
    return launch, (outv, sigr, z2, (rays, treg, b6, SRk), ws)


def k3_forward(pw, rays_o, rays_d, gt_d, t_reg, bound, S1: int, SI: int,
               with_reg: bool):
    """Launch K3 on CUDA tensors. Returns depth (N,), var (N,), colour
    (N, 3), sigma_reg (N, SR) (zeros without reg), z2 (N, S1 + SI) and what
    K4 needs (rays, t_reg, bound, SR launched)."""
    launch, (outv, sigr, z2, saved, _) = k3_launch(
        build.load("megakernel"), pw, rays_o, rays_d, gt_d, t_reg, bound,
        S1, SI, with_reg)
    launch()
    tracing.count("megakernel_fwd")
    return (outv[:, 0].clone(), outv[:, 1].clone(), outv[:, 2:5].clone(),
            sigr, z2, saved)


class _FusedRenderFn(torch.autograd.Function):
    """K3 forward, K4 backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, S1, SI, with_reg, t_reg, bound, gt_d, rays_o, rays_d,
                *plist):
        params = dict(zip(PARAM_NAMES, plist))
        pw = pack_weights(params)
        depth, var, col, sigr, z2, saved = k3_forward(
            pw, rays_o, rays_d, gt_d, t_reg, bound, S1, SI, with_reg)
        ctx.meta = (S1, SI, saved[3], pw, params["embedder.B"].shape[1])
        ctx.save_for_backward(saved[0], saved[1], z2, saved[2])
        return depth, var, col, sigr

    @staticmethod
    def backward(ctx, gdep, gvar, gcol, gsigr):
        S1, _, SRk, pw, emb = ctx.meta
        rays, treg, z2, b6 = ctx.saved_tensors
        pg = any(ctx.needs_input_grad[8:])
        dray, grads = k4_backward(pw, rays, treg, z2, b6, gdep, gvar, gcol,
                                  gsigr, S1, SRk, pg)
        dps = [None] * len(PARAM_NAMES)
        if pg:
            g = _unpack_grads(grads, emb)
            dps = [g[k] for k in PARAM_NAMES]
        return (None, None, None, None, None, None, dray[:, 0:3],
                dray[:, 3:6], *dps)


def k4_launch(lib, pw, rays, treg, z2, b6, gdep, gvar, gcol, gsigr,
              S1: int, SRk: int, param_grads: bool):
    """K4's C call `mk_backward` of `lib` (csrc/megakernel.cu, or another
    build of it) on buffers prepared once: returns (launch, (dray (N, 8)
    [d_o, d_d, 0, 0], the flat weight gradients (fused_vg's layout; a
    1-element dummy without param_grads))); each launch() runs the kernel
    and raises on a CUDA error."""
    n, dev = rays.shape[0], rays.device
    S2 = z2.shape[1]
    gsm = torch.zeros(n, 8, device=dev)
    gsm[:, 0] = gdep
    gsm[:, 1] = gvar
    gsm[:, 2:5] = gcol
    gsr = (gsigr.float().contiguous() if SRk
           else torch.zeros(n, 1, device=dev))
    lib.mk_backward_workspace_bytes.restype = ctypes.c_longlong
    lib.mk_backward.restype = ctypes.c_int
    pg = int(bool(param_grads))
    ws = torch.empty(int(lib.mk_backward_workspace_bytes(
        ctypes.c_int(n), ctypes.c_int(S2), ctypes.c_int(SRk),
        ctypes.c_int(pg))), dtype=torch.uint8, device=dev)
    dray = torch.empty(n, 8, device=dev)
    grads = torch.empty(GRAD_LEN if pg else 1, device=dev)
    pw = pw.with_images(chain=True)
    args = (pw.pointers(), _ptr(rays), _ptr(treg), _ptr(z2), _ptr(gsm),
            _ptr(gsr), _ptr(b6), _ptr(ws), _ptr(dray), _ptr(grads),
            ctypes.c_int(n), ctypes.c_int(S1), ctypes.c_int(S2 - S1),
            ctypes.c_int(SRk), ctypes.c_int(pg), _stream(rays))

    def launch():
        build.check(lib, lib.mk_backward(*args), "mk_backward")
    # the launch keeps every buffer it points at alive
    launch.keep = (pw, rays, treg, z2, gsm, gsr, b6, ws, dray, grads)
    return launch, (dray, grads)


def k4_backward(pw, rays, treg, z2, b6, gdep, gvar, gcol, gsigr, S1: int,
                SRk: int, param_grads: bool):
    """Launch K4 with the cotangents of (depth, var, colour, sigma_reg).
    Returns dray (N, 8) [d_o, d_d, 0, 0] and the flat weight gradients
    (fused_vg's layout; a 1-element dummy without param_grads)."""
    launch, out = k4_launch(build.load("megakernel"), pw, rays, treg, z2,
                            b6, gdep, gvar, gcol, gsigr, S1, SRk,
                            param_grads)
    launch()
    tracing.count("megakernel_bwd")
    return out


def make_fused_render(rcfg, with_reg: bool = True):
    """fused_render(decoder_or_params, rays_o, rays_d, gt_d, t_reg, bound)
    -> (depth, depth_var, color, sigma_reg); see the module docstring.
    A decoder (or a dict) whose tensors require grad gets parameter
    gradients; pass detached tensors to skip them."""
    S1, SI = rcfg.N_samples, rcfg.N_importance

    def fused_render(decoder, rays_o, rays_d, gt_d, t_reg, bound):
        params = params_of(decoder)
        if _path(rays_o, rays_d, gt_d, params["out.w"]) == "cpu":
            return fused_render_reference(params, rays_o, rays_d, gt_d,
                                          t_reg, bound, S1, SI, with_reg)
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("allow_tf32 must be False: the far bound and "
                               "the camera chain are float32 products")
        return _FusedRenderFn.apply(S1, SI, with_reg, t_reg, bound,
                                    gt_d.detach().float(), rays_o, rays_d,
                                    *[params[k] for k in PARAM_NAMES])

    return fused_render
