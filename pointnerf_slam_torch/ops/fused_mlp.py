"""The iMAP* decoder on arbitrary points as a kernel pair:

  fused_imap_mlp(params, pts) -> raw (N, 4)

differentiable in the decoder's tensors (state_dict names, `embedder.B`
included) and in pts. It is what `MLPConfig.fused` selects wherever the
decoder is evaluated outside K1-K4: the mesher's grid and vertex colours,
and the plain renderer of the tracker and mapper (`rendering.megakernel:
off`).

CUDA tensors run the hand-written kernels of csrc/fused_mlp.cu, on the
Hopper tile that K1-K4 run: the forward launches K5 (replaces the JAX
reference's ops/fused_mlp.py:104 `_fwd_kernel`), which streams the
forward weight image wf; the backward K6 (:116 `_bwd_kernel`), which
streams wf and the chain's image wc, recomputes the forward and returns
dx and every weight gradient, summed over tiles in a fixed order. K6
skips the weight gradients when no parameter needs one (the tracker) and
dx when pts need none (the mapper without bundle adjustment). CPU
tensors take the plain versions `mlp_forward_reference` /
`mlp_backward_reference`; anything else raises, and there is no fallback
from a failed build or launch.

Numerics, those of the TPU kernels: x . B, sin and cos in float32 (x . B
as the FMA chain of models.embeddings.fourier_project); bf16-rounded
operands at every hidden and head product with float32 sums, in the
backward too, where the cotangents g and dh are rounded to bf16 before
each product (`_dot_tn` / `_dot_nt`); bias gradients sum the unrounded
cotangents; dB = x^T demb and dx = demb B^T in float32. Autograd of
`models.decoders.mlp_apply(bf16=True)` keeps the cotangents in float32,
so it is not K6's plain version. The TPU layout's 128-lane padding is
not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.embeddings import fourier_project
from ..utils import tracing
from . import build
from .fused_vg import (GRAD_LEN, PARAM_NAMES, PackedWeights, _check, _path,
                       _stream, _unpack_grads, pack_weights)

HID = 256


def supports_fused(model_cfg) -> bool:
    """The kernels cover the flagship iMAP* decoder (the JAX reference's
    rule, ops/fused_mlp.py:249-257)."""
    return (getattr(model_cfg, "c_dim", None) == 0
            and model_cfg.color
            and model_cfg.pos_embedding_method == "fourier"
            and model_cfg.skips == ()
            and model_cfg.n_blocks == 4
            and model_cfg.hidden_size == HID
            and not model_cfg.leaky)


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _hidden(p: dict, x: torch.Tensor):
    """x . B (float32), emb = sin(x . B), and the four ReLU layers."""
    xb = fourier_project(x, p["embedder.B"])
    h = emb = torch.sin(xb)
    hs = []
    for i in range(4):
        h = torch.relu(_bf(h) @ _bf(p[f"layers.{i}.w"]) + p[f"layers.{i}.b"])
        hs.append(h)
    return xb, emb, hs


def mlp_forward_reference(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (`_fwd_kernel`): (N, 3) -> raw (N, 4)."""
    _, _, hs = _hidden(p, x)
    return _bf(hs[3]) @ _bf(p["out.w"]) + p["out.b"]


def mlp_backward_reference(p: dict, x: torch.Tensor, g: torch.Tensor,
                           param_grads: bool = True, x_grad: bool = True):
    """Plain version of K6 (`_bwd_kernel`), step by step: the forward
    recomputed, then the head and the dh chain with bf16-rounded
    cotangents at every product. Returns (dx (N, 3) or None, {name: grad}
    or None)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("allow_tf32 must be False: dB and dx are "
                           "float32 products")
    xb, emb, hs = _hidden(p, x)
    grads = {} if param_grads else None

    def weight_grad(name, inp, d):          # in^T d, bias: sum of d
        if param_grads:
            grads[f"{name}.w"] = _bf(inp).T @ _bf(d)
            grads[f"{name}.b"] = d.sum(0)

    weight_grad("out", hs[3], g)
    dh = (_bf(g) @ _bf(p["out.w"]).T) * (hs[3] > 0)
    for L in (3, 2, 1):
        weight_grad(f"layers.{L}", hs[L - 1], dh)
        dh = (_bf(dh) @ _bf(p[f"layers.{L}.w"]).T) * (hs[L - 1] > 0)
    weight_grad("layers.0", emb, dh)
    demb = (_bf(dh) @ _bf(p["layers.0.w"]).T) * torch.cos(xb)
    if param_grads:
        grads["embedder.B"] = x.T @ demb
    dx = demb @ p["embedder.B"].T if x_grad else None
    return dx, grads


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def k5_launch(lib, pw: PackedWeights, x: torch.Tensor):
    """K5's C call `mlp_fwd` of `lib` (csrc/fused_mlp.cu, or another build
    of it) on buffers prepared once: returns (launch, out (N, 4)); each
    launch() runs the kernel into out and raises on a CUDA error. The
    kernel streams the forward weight image alone (wf)."""
    n = x.shape[0]
    _check(x, (n, 3), torch.float32, "pts")
    out = torch.empty(n, 4, device=x.device)
    lib.mlp_fwd.restype = ctypes.c_int
    args = (pw.with_images(chain=False).pointers(), _ptr(x), _ptr(out),
            ctypes.c_longlong(n), _stream(x))

    def launch():
        build.check(lib, lib.mlp_fwd(*args), "mlp_fwd")
        return out
    # the launch keeps every buffer it points at alive
    launch.keep = (pw, x)
    return launch, out


def k6_launch(lib, pw: PackedWeights, x: torch.Tensor, g: torch.Tensor,
              param_grads: bool, x_grad: bool):
    """K6's C call `mlp_bwd` of `lib` on buffers prepared once: returns
    (launch, (dx (N, 3) or a 1-element placeholder, grads (GRAD_LEN,) or
    a placeholder)); each launch() runs the kernel into them and raises on
    a CUDA error. The kernel streams both weight images (wf, wc) and sizes
    its workspace by the library's answer for (N, weight gradients)."""
    n, dev = x.shape[0], x.device
    _check(x, (n, 3), torch.float32, "pts")
    _check(g, (n, 4), torch.float32, "cotangent")
    lib.mlp_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.mlp_bwd.restype = ctypes.c_int
    pg = int(bool(param_grads))
    ws = torch.empty(int(lib.mlp_bwd_workspace_bytes(ctypes.c_longlong(n),
                                                     ctypes.c_int(pg))),
                     dtype=torch.uint8, device=dev)
    dx = torch.empty(n, 3, device=dev) if x_grad else torch.empty(1,
                                                                   device=dev)
    grads = torch.empty(GRAD_LEN if pg else 1, device=dev)
    args = (pw.with_images(chain=True).pointers(), _ptr(x), _ptr(g),
            _ptr(ws), _ptr(dx), _ptr(grads), ctypes.c_longlong(n),
            ctypes.c_int(pg), ctypes.c_int(int(bool(x_grad))), _stream(x))

    def launch():
        build.check(lib, lib.mlp_bwd(*args), "mlp_bwd")
        return dx, grads
    launch.keep = (pw, x, g, ws)
    return launch, (dx, grads)


def k5_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Launch K5 on CUDA tensors: (N, 3) -> (N, 4)."""
    if x.shape[0] == 0:
        return torch.empty(0, 4, device=x.device)
    launch, out = k5_launch(build.load("fused_mlp"), pack_weights(params),
                            x.detach().float().contiguous())
    launch()
    tracing.count("fused_mlp_fwd")
    return out


def k6_backward(params: dict, x: torch.Tensor, g: torch.Tensor,
                param_grads: bool, x_grad: bool):
    """Launch K6 on CUDA tensors with the cotangent g (N, 4). Returns
    (dx (N, 3) or None, {name: grad} or None)."""
    launch, (dx, grads) = k6_launch(
        build.load("fused_mlp"), pack_weights(params),
        x.detach().float().contiguous(), g.detach().float().contiguous(),
        param_grads, x_grad)
    launch()
    tracing.count("fused_mlp_bwd")
    emb = params["embedder.B"].shape[1]
    return (dx if x_grad else None,
            _unpack_grads(grads, emb) if param_grads else None)


class _FusedMLPFn(torch.autograd.Function):
    """K5 forward / K6 backward (kernel=True), or their plain versions."""

    @staticmethod
    def forward(ctx, kernel, x, *plist):
        params = dict(zip(PARAM_NAMES, plist))
        ctx.kernel = kernel
        ctx.save_for_backward(x, *plist)
        if kernel:
            return k5_forward(params, x)
        return mlp_forward_reference(params, x)

    @staticmethod
    def backward(ctx, g):
        x, *plist = ctx.saved_tensors
        params = dict(zip(PARAM_NAMES, plist))
        pg = any(ctx.needs_input_grad[2:])
        xg = ctx.needs_input_grad[1]
        run = k6_backward if ctx.kernel else mlp_backward_reference
        dx, dps = run(params, x, g.float(), pg, xg)
        return (None, dx) + tuple(dps[k] if pg else None
                                  for k in PARAM_NAMES)


def _plist(params: dict):
    return [params[k] for k in PARAM_NAMES]


def fused_imap_mlp(params: dict, pts: torch.Tensor) -> torch.Tensor:
    """The decoder at pts (N, 3) -> raw (N, 4): K5/K6 for CUDA tensors,
    the plain versions for CPU tensors (see the module docstring)."""
    kernel = _path(pts, params["out.w"]) == "cuda"
    return _FusedMLPFn.apply(kernel, pts, *_plist(params))


def fused_mlp_reference(params: dict, pts: torch.Tensor) -> torch.Tensor:
    """The plain versions as one differentiable function, on any device
    (what the kernels are held against on the card)."""
    return _FusedMLPFn.apply(False, pts, *_plist(params))
