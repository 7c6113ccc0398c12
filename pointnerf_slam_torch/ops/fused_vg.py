"""Fused loss value-and-grad for the iMAP* tracker and mapper losses.

One optimisation iteration runs two hand-written CUDA kernels for sm_90a
with a plain-torch middle:

  p1_sigma   pass-1 density at S1 stratified z per ray (forward only;
             csrc/p1_sigma.cu, replaces the JAX reference's
             ops/fused_vg.py:284 `_make_p1_kernel`)
  [torch]    compositing weights -> deterministic inverse CDF -> sort of
             the merged z2 (render_math.importance_z2)
  fused_vg   forward over the z2 (and, for the mapper, the regulation)
             points, per-ray composite + loss + closed-form cotangents +
             composite VJP, MLP backward over stored activations, weight
             gradients and d(loss)/d(rays) (csrc/fused_vg.cu, replaces
             ops/fused_vg.py:304 `_make_vg_kernel`)

Losses (per ray, summed):
  mapper   |gt_d - depth| * m  +  w_color * |gt_c - col|_1 * ray_w
           + w_reg * |sigma_reg|_1 * ray_w  +  w_beyond * (1 - w-mass in
           [gt_d - 0.10, gt_d + 0.05]) * m,        m = (gt_d > 0) * ray_w
  tracker  |gt_d - depth| / sqrt(stopgrad(var) + 1e-10) * m
           + w_color * |gt_c - col|_1 * m

Gradient structure: z2, far, t_reg and the in-band mask are constants;
camera gradients leave as d(loss)/d(rays_o, rays_d) and the caller chains
them through ray generation with autograd (`fused_vg_loss`).

Every wrapper picks its path by the device of its tensors and nothing
else: CPU tensors take the plain version (`p1_sigma_reference`,
`fused_vg_reference`), CUDA tensors launch the kernel, anything else
raises. There is no fallback from a failed build or launch.

Layout: K1 and K2 (and the render pair K3/K4, ops/megakernel.py, and the
decoder pair K5/K6, ops/fused_mlp.py) read the hidden weights as
128-byte-swizzled K-slices that their wrappers build from the packed
weights on every call
(`PackedWeights.with_images`, `weight_images`, `swizzle128`), so that the
kernels' 1-D bulk copies land them ready for wgmma.

Numerics: the hidden and head products take bf16-rounded operands and
accumulate in float32; x @ B and the camera-gradient contractions stay in
full float32. `torch.backends.cuda.matmul.allow_tf32` must stay False (the
PyTorch default): the plain versions' float32 products would otherwise
drop to TF32 on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.sampling import ray_far_bound
from ..models.decoders import mlp_apply
from ..render.renderer import clip_far
from . import build
from .render_math import importance_z2, reg_zvals, weights, z_pass1

# termination-loss band: in-band = z in [gt - _BEYOND_LO, gt + _BEYOND_HI]
_BEYOND_LO = 0.10
_BEYOND_HI = 0.05

EMB_PAD = 128          # Fourier columns padded 93 -> 128 in the kernel layout
HID = 256

# kernel launches since the last reset, by wrapper (chip_smoke reads these)
launches = {"p1_sigma": 0, "fused_vg_mapper": 0, "fused_vg_tracker": 0,
            "megakernel_fwd": 0, "megakernel_bwd": 0, "fused_mlp_fwd": 0,
            "fused_mlp_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# most merged samples per ray the kernels hold (csrc/ray_shared.cuh MAXS)
MAX_SAMPLES = 64


# points per ray (pass 2 + regulation) fused value-and-grad takes: the JAX
# reference's cap (ops/fused_vg.py _MAX_PTS / TILE), kept so that both
# packages send a configuration down the same engine branch
MAX_VG_POINTS = 100


def supports_megakernel(model_cfg, rcfg) -> bool:
    """The kernels (K1-K4) cover the iMAP* flagship decoder and sampling."""
    return (model_cfg.c_dim == 0 and model_cfg.color
            and rcfg.N_samples + rcfg.N_importance <= MAX_SAMPLES
            and model_cfg.pos_embedding_method == "fourier"
            and model_cfg.skips == () and model_cfg.n_blocks == 4
            and model_cfg.hidden_size == HID and not model_cfg.leaky
            and rcfg.N_surface == 0 and rcfg.perturb == 0.0
            and not rcfg.lindisp and not rcfg.occupancy
            and rcfg.N_importance > 0)


def supports_fused_vg(model_cfg, rcfg) -> bool:
    """Fused value-and-grad (K1) takes the configuration: the megakernel's
    cover, at most MAX_VG_POINTS points per ray."""
    return (supports_megakernel(model_cfg, rcfg)
            and 2 * rcfg.N_samples + rcfg.N_importance <= MAX_VG_POINTS)


def _path(*tensors) -> str:
    """'cpu' or 'cuda' from the tensors' device; raises on anything else."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return "cpu"
    if devs == {"cuda"}:
        return "cuda"
    raise ValueError(f"fused value-and-grad takes CPU or CUDA tensors on "
                     f"one device type, got {sorted(devs)}")


# ---------------------------------------------------------------------------
# weight layouts
# ---------------------------------------------------------------------------

PARAM_NAMES = ("embedder.B", "layers.0.w", "layers.0.b", "layers.1.w",
               "layers.1.b", "layers.2.w", "layers.2.b", "layers.3.w",
               "layers.3.b", "out.w", "out.b")


def params_of(decoder) -> dict:
    """{state_dict name: parameter} of an IMAPDecoder (or a dict)."""
    if isinstance(decoder, dict):
        return {k: decoder[k] for k in PARAM_NAMES}
    named = dict(decoder.named_parameters())
    return {k: named[k] for k in PARAM_NAMES}


@dataclasses.dataclass
class PackedWeights:
    """The kernels' layout: Bp (3, 128) f32 (columns >= 93 zero), W0p
    (128, 256) bf16 (rows >= 93 zero), W1..W3 (256, 256) bf16, Wo (256, 4)
    bf16, biases f32. Zero padding is exact: sin(x * 0) = 0 meets zero
    rows of W0p. The kernels also read the hidden weights as swizzled
    K-slice streams (`weight_images`), built on first need by
    `with_images`: wf for the forward (K1-K6), wc for the dh chain (K1,
    K4, K6); a missing stream passes a null pointer."""
    Bp: torch.Tensor
    Ws: tuple          # W0p, W1, W2, W3, Wo (bf16)
    bs: tuple          # b0, b1, b2, b3, bo (f32)
    wf: torch.Tensor | None = None   # (14, 256, 64) bf16
    wc: torch.Tensor | None = None   # (12 * 256 * 64 + 4 * 128 * 64,) bf16

    def with_images(self, chain: bool) -> "PackedWeights":
        """Builds wf and, with chain, wc where missing; returns self."""
        wf, wc = weight_images(self.Ws, fwd=self.wf is None,
                               chain=chain and self.wc is None)
        self.wf = self.wf if wf is None else wf
        self.wc = self.wc if wc is None else wc
        return self

    def pointers(self):
        ts = [self.Bp, *self.Ws, *self.bs, self.wf, self.wc]
        return (ctypes.c_void_p * len(ts))(
            *[None if t is None else t.data_ptr() for t in ts])


SW_K = 64      # bf16 columns of one 128-byte swizzle row: one K-slice


def swizzle128(m: torch.Tensor) -> torch.Tensor:
    """(R, K) -> (K / 64, R, 64): K-slice s holds m[:, 64 s : 64 s + 64]
    as the 128-byte-swizzled image that wgmma reads from shared memory
    (csrc/hopper_mlp.cuh `sw_off`): row r's 16-byte group c (8 bf16) sits
    at group c ^ (r % 8). The map is its own inverse."""
    R, K = m.shape
    if K % SW_K:
        raise ValueError(f"swizzle128: {K} columns, want a multiple of 64")
    blk = m.reshape(R, K // SW_K, 8, 8).permute(1, 0, 2, 3)
    r = torch.arange(R, device=m.device)
    src = torch.arange(8, device=m.device)[None, :] ^ (r[:, None] % 8)
    return blk.gather(2, src[None, :, :, None].expand(blk.shape)).reshape(
        K // SW_K, R, SW_K)


def _image_index(Ws) -> tuple:
    """Positions in cat(W0p, W1, W2, W3 flattened) of wf's and wc's
    elements (`weight_images`), as int64 index tensors."""
    pos, o = [], 0
    for W in Ws[:4]:
        pos.append(torch.arange(o, o + W.numel()).reshape(W.shape))
        o += W.numel()
    wf = torch.cat([swizzle128(P.t()) for P in pos]).reshape(-1)
    wc = torch.cat([swizzle128(pos[L]).reshape(-1) for L in (3, 2, 1, 0)])
    return wf, wc


_IMAGE_INDEX: dict = {}


def weight_images(Ws, fwd: bool = True, chain: bool = True) -> tuple:
    """The K-slice streams of the kernels from W0p, W1..W3 (bf16), each only if
    asked for (else None): wf (fwd), the forward's B operands (out = in @
    W_l, K-major: W_l^T), 2 + 3 x 4 slices of 256 x 64; wc (chain), the
    chain's (dh_{L-1} = dh_L @ W_L^T, K-major: W_L itself) for L = 3, 2, 1
    as 4 slices of 256 x 64, then W0p as 4 slices of 128 x 64. One gather
    each through an index built once per device (the swizzle of every
    element's position)."""
    if not (fwd or chain):
        return None, None
    dev = Ws[0].device
    if dev not in _IMAGE_INDEX:
        _IMAGE_INDEX[dev] = tuple(i.to(dev) for i in _image_index(Ws))
    fi, ci = _IMAGE_INDEX[dev]
    flat = torch.cat([W.reshape(-1) for W in Ws[:4]])
    return (flat[fi].reshape(-1, HID, SW_K) if fwd else None,
            flat[ci] if chain else None)


def pack_weights(params: dict) -> PackedWeights:
    p = {k: v.detach() for k, v in params.items()}
    B = p["embedder.B"]
    emb = B.shape[1]
    Bp = torch.zeros(3, EMB_PAD, device=B.device, dtype=torch.float32)
    Bp[:, :emb] = B
    W0p = torch.zeros(EMB_PAD, HID, device=B.device, dtype=torch.bfloat16)
    W0p[:emb] = p["layers.0.w"].to(torch.bfloat16)
    Ws = (W0p,) + tuple(p[f"layers.{i}.w"].to(torch.bfloat16).contiguous()
                        for i in (1, 2, 3)) \
        + (p["out.w"].to(torch.bfloat16).contiguous(),)
    bs = tuple(p[f"layers.{i}.b"].float().contiguous() for i in range(4)) \
        + (p["out.b"].float().contiguous(),)
    return PackedWeights(Bp.contiguous(), Ws, bs)


# flat float32 gradient buffer written by the fused_vg kernel: the small
# per-tile sums first, then the weight matrices (csrc/fused_vg.cu GRAD_*)
_GRAD_SLOTS = (("Bp", (3, EMB_PAD)), ("b", (4, HID)), ("Wo", (HID, 4)),
               ("bo", (4,)), ("W0", (EMB_PAD, HID)), ("W1", (HID, HID)),
               ("W2", (HID, HID)), ("W3", (HID, HID)))
GRAD_LEN = sum(int(torch.Size(s).numel()) for _, s in _GRAD_SLOTS)


def _unpack_grads(flat: torch.Tensor, emb: int) -> dict:
    g, off = {}, 0
    for name, shape in _GRAD_SLOTS:
        n = int(torch.Size(shape).numel())
        g[name] = flat[off:off + n].view(shape)
        off += n
    out = {"embedder.B": g["Bp"][:, :emb], "layers.0.w": g["W0"][:emb],
           "out.w": g["Wo"], "out.b": g["bo"]}
    for i in range(4):
        out[f"layers.{i}.b"] = g["b"][i]
        if i:
            out[f"layers.{i}.w"] = g[f"W{i}"]
    return out


def _packed_as_params(pw: PackedWeights) -> dict:
    """The packed weights under state_dict names (float32 holding the bf16
    values; B and W0 keep their zero padding, which adds exact zeros)."""
    ts = [pw.Bp]
    for i in range(4):
        ts += [pw.Ws[i].float(), pw.bs[i]]
    ts += [pw.Ws[4].float(), pw.bs[4]]
    return dict(zip(PARAM_NAMES, ts))


def _inside(x: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    return ((x > bound[:, 0]) & (x < bound[:, 1])).all(dim=-1)


def _pack_rays(rays_o, rays_d, gt_d, bound):
    far = clip_far(ray_far_bound(rays_o, rays_d, bound), gt_d)
    return torch.cat([rays_o.detach(), rays_d.detach(), gt_d[:, None],
                      far[:, None]], dim=1).contiguous()


# ---------------------------------------------------------------------------
# K2: pass-1 sigma
# ---------------------------------------------------------------------------

def p1_sigma_reference(pw: PackedWeights, rays: torch.Tensor,
                       bound: torch.Tensor, S1: int) -> torch.Tensor:
    """Plain version of the p1_sigma kernel: rays (N, 8) [o, d, gt_d, far]
    -> (N, S1) sigma at z_pass1, 100 outside the AABB."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    z = z_pass1(rays[:, 6:7], rays[:, 7:8], S1)
    x = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    sig = mlp_apply(_packed_as_params(pw), x, bf16=True)[:, 3]
    sig = torch.where(_inside(x, bound), sig, torch.full_like(sig, 100.0))
    return sig.reshape(-1, S1)


def p1_launch(lib, pw: PackedWeights, rays: torch.Tensor,
              bound: torch.Tensor, S1: int):
    """K2's C call `p1_sigma` of `lib` (csrc/p1_sigma.cu, or another build
    of it) on buffers prepared once: returns (launch, sig1 (N, S1)); each
    launch() runs the kernel into sig1 and raises on a CUDA error."""
    _check(rays, (rays.shape[0], 8), torch.float32, "rays")
    n = rays.shape[0]
    sig1 = torch.empty(n, S1, device=rays.device, dtype=torch.float32)
    b6 = bound.reshape(-1).float().contiguous()
    _check(b6, (6,), torch.float32, "bound")
    lib.p1_sigma.restype = ctypes.c_int
    args = (pw.with_images(chain=False).pointers(), _ptr(rays), _ptr(b6),
            _ptr(sig1), ctypes.c_int(n), ctypes.c_int(S1), _stream(rays))

    def launch():
        build.check(lib, lib.p1_sigma(*args), "p1_sigma")
        return sig1
    # the launch keeps every buffer it points at alive
    launch.keep = (pw, rays, b6)
    return launch, sig1


def p1_sigma(pw: PackedWeights, rays: torch.Tensor, bound: torch.Tensor,
             S1: int) -> torch.Tensor:
    """Pass-1 sigma (N, S1): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if _path(rays, pw.Bp) == "cpu":
        return p1_sigma_reference(pw, rays, bound, S1)
    launch, sig1 = p1_launch(build.load("p1_sigma"), pw, rays, bound, S1)
    launch()
    launches["p1_sigma"] += 1
    return sig1


def _check(t: torch.Tensor, shape, dtype, name: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{name}: want contiguous CUDA {dtype} {shape}, got "
                         f"{t.device} {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# K1: fused value-and-grad
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VGSpec:
    """Static description of one fused value-and-grad variant."""
    S1: int
    SI: int
    SR: int
    mode: str                  # "mapper" | "tracker"
    w_color: float
    w_reg: float
    with_color: bool
    param_grads: bool
    w_beyond: float
    with_ray_grads: bool

    @property
    def with_reg(self) -> bool:
        return self.mode == "mapper"

    @property
    def with_beyond(self) -> bool:
        return self.mode == "mapper" and self.w_beyond > 0.0


def fused_vg_reference(spec: VGSpec, params: dict, rays_o, rays_d, gt_d,
                       gt_c, ray_w, t_reg, z2, bound):
    """Plain version of the fused_vg kernel, backward by autograd.

    Returns (loss, dparams {name: grad}, dray_o, dray_d, (depth, var, col));
    dparams is None without param_grads, dray_* are zeros without ray
    grads."""
    if rays_o.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("allow_tf32 must be False: x @ B and the camera "
                           "contractions are float32 products")
    with torch.enable_grad():
        p = {k: v.detach().requires_grad_(spec.param_grads)
             for k, v in params.items()}
        ro = rays_o.detach().requires_grad_(spec.with_ray_grads)
        rd = rays_d.detach().requires_grad_(spec.with_ray_grads)
        gtd = gt_d.detach()[:, None]
        n, S2 = z2.shape
        x2 = ro[:, None, :] + rd[:, None, :] * z2[..., None]
        raw2 = mlp_apply(p, x2.reshape(-1, 3), bf16=True).reshape(n, S2, 4)
        sig2 = torch.where(_inside(x2, bound), raw2[..., 3],
                           torch.full_like(raw2[..., 3], 100.0))
        dn = torch.sqrt(torch.sum(rd * rd, dim=1, keepdim=True) + 1e-24)
        w = weights(sig2, z2, dn)
        depth = torch.sum(w * z2, dim=1, keepdim=True)
        var = torch.sum(w * (z2 - depth) ** 2, dim=1, keepdim=True)
        col = torch.sum(w[..., None] * raw2[..., :3], dim=1)
        mask = (gtd > 0).float() * ray_w[:, None]
        if spec.mode == "tracker":
            wdep = mask / torch.sqrt(var.detach() + 1e-10)
            wcol = spec.w_color * mask
        else:
            wdep = mask
            wcol = spec.w_color * ray_w[:, None]
        loss_ray = torch.abs(gtd - depth) * wdep
        if spec.with_beyond:
            in_band = ((z2 > gtd - _BEYOND_LO)
                       & (z2 < gtd + _BEYOND_HI)).float()
            m_in = torch.sum(w * in_band, dim=1, keepdim=True)
            loss_ray = loss_ray + spec.w_beyond * (1.0 - m_in) * mask
        if spec.with_color:
            loss_ray = loss_ray + torch.sum(torch.abs(gt_c - col), dim=1,
                                            keepdim=True) * wcol
        if spec.with_reg:
            zr = reg_zvals(gtd, t_reg)
            xr = ro[:, None, :] + rd[:, None, :] * zr[..., None]
            sr = mlp_apply(p, xr.reshape(-1, 3), bf16=True)[:, 3].reshape(n, -1)
            sr = torch.where(_inside(xr, bound), sr,
                             torch.full_like(sr, 100.0))
            loss_ray = loss_ray + spec.w_reg * torch.sum(
                torch.abs(sr), dim=1, keepdim=True) * ray_w[:, None]
        loss = loss_ray.sum()
        wrt = ([p[k] for k in PARAM_NAMES] if spec.param_grads else []) \
            + ([ro, rd] if spec.with_ray_grads else [])
        grads = list(torch.autograd.grad(loss, wrt)) if wrt else []
    dparams = None
    if spec.param_grads:
        dparams = dict(zip(PARAM_NAMES, grads[:len(PARAM_NAMES)]))
    if spec.with_ray_grads:
        dro, drd = grads[-2], grads[-1]
    else:
        dro, drd = torch.zeros_like(rays_o), torch.zeros_like(rays_d)
    aux = (depth.detach()[:, 0], var.detach()[:, 0], col.detach())
    return loss.detach(), dparams, dro, drd, aux


def vg_launch(lib, spec: VGSpec, params: dict, rays_o, rays_d, gt_d, gt_c,
              ray_w, t_reg, z2, bound):
    """K1's C call `fused_vg` of `lib` (csrc/fused_vg.cu, or another build
    of it) on buffers prepared once: returns (launch, (outv (N, 8), dray
    (N, 8), grads (GRAD_LEN,))); each launch() runs the kernel into them
    and raises on a CUDA error."""
    n, S2 = z2.shape
    dev = rays_o.device
    pw = pack_weights(params).with_images(chain=True)
    rays = _pack_rays(rays_o, rays_d, gt_d, bound)
    aux = torch.cat([gt_c, ray_w[:, None]], dim=1).float().contiguous()
    z2c = z2.float().contiguous()
    treg = (t_reg.float().contiguous() if spec.with_reg
            else torch.zeros(n, 1, device=dev))
    b6 = bound.reshape(-1).float().contiguous()
    SR = spec.SR if spec.with_reg else 0
    for t, shape, name in ((rays, (n, 8), "rays"), (aux, (n, 4), "aux"),
                           (z2c, (n, S2), "z2"), (b6, (6,), "bound")):
        _check(t, shape, torch.float32, name)
    if spec.with_reg:
        _check(treg, (n, SR), torch.float32, "t_reg")
    lib.fused_vg_workspace_bytes.restype = ctypes.c_longlong
    lib.fused_vg.restype = ctypes.c_int
    ws_bytes = lib.fused_vg_workspace_bytes(
        ctypes.c_int(n), ctypes.c_int(S2), ctypes.c_int(SR),
        ctypes.c_int(int(spec.param_grads)))
    ws = torch.empty(int(ws_bytes), dtype=torch.uint8, device=dev)
    outv = torch.empty(n, 8, device=dev)
    dray = torch.empty(n, 8, device=dev)
    grads = torch.empty(GRAD_LEN, device=dev)
    args = (pw.pointers(), _ptr(rays), _ptr(aux), _ptr(treg), _ptr(z2c),
            _ptr(b6), _ptr(ws), _ptr(outv), _ptr(dray), _ptr(grads),
            ctypes.c_int(n), ctypes.c_int(S2), ctypes.c_int(SR),
            ctypes.c_int(int(spec.mode == "tracker")),
            ctypes.c_int(int(spec.with_color)),
            ctypes.c_int(int(spec.param_grads)),
            ctypes.c_int(int(spec.with_ray_grads)),
            ctypes.c_float(spec.w_color), ctypes.c_float(spec.w_reg),
            ctypes.c_float(spec.w_beyond if spec.with_beyond else 0.0),
            _stream(rays))

    def launch():
        build.check(lib, lib.fused_vg(*args), "fused_vg")
        return outv, dray, grads
    # the launch keeps every buffer it points at alive
    launch.keep = (pw, rays, aux, z2c, treg, b6, ws)
    return launch, (outv, dray, grads)


def _fused_vg_cuda(spec: VGSpec, params: dict, rays_o, rays_d, gt_d, gt_c,
                   ray_w, t_reg, z2, bound):
    launch, (outv, dray, grads) = vg_launch(
        build.load("fused_vg"), spec, params, rays_o, rays_d, gt_d, gt_c,
        ray_w, t_reg, z2, bound)
    launch()
    launches[f"fused_vg_{spec.mode}"] += 1
    emb = params["embedder.B"].shape[1]
    dparams = _unpack_grads(grads, emb) if spec.param_grads else None
    return (outv[:, 0].sum(), dparams, dray[:, 0:3], dray[:, 3:6],
            (outv[:, 1], outv[:, 2], outv[:, 3:6]))


def _make_vg_parts(rcfg, mode: str, w_color: float, w_reg: float,
                   with_color: bool, param_grads: bool, w_beyond: float,
                   with_ray_grads: bool):
    if mode not in ("mapper", "tracker"):
        raise ValueError(mode)
    spec = VGSpec(rcfg.N_samples, rcfg.N_importance, rcfg.N_samples, mode,
                  float(w_color), float(w_reg), bool(with_color),
                  bool(param_grads), float(w_beyond), bool(with_ray_grads))

    def prepare(decoder, rays_o, rays_d, gt_d, bound):
        """Pass-1 sigma + importance resample -> merged z2 (N, S1+SI),
        stop-gradient; reusable for K iterations (resample_every)."""
        pw = pack_weights(params_of(decoder))
        rays = _pack_rays(rays_o, rays_d, gt_d, bound)
        sig1 = p1_sigma(pw, rays, bound, spec.S1)
        z1 = z_pass1(rays[:, 6:7], rays[:, 7:8], spec.S1)
        dn = torch.sqrt(torch.sum(rays[:, 3:6] ** 2, dim=1, keepdim=True))
        return importance_z2(sig1, z1, dn, spec.SI)

    def main(decoder, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, z2, bound):
        """Loss value and gradients at the given z2."""
        params = params_of(decoder)
        args = (spec, params, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, z2,
                bound)
        if _path(rays_o, rays_d, gt_d, z2, params["out.w"]) == "cpu":
            return fused_vg_reference(*args)
        return _fused_vg_cuda(*args)

    def vg(decoder, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, bound):
        z2 = prepare(decoder, rays_o, rays_d, gt_d, bound)
        return main(decoder, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, z2,
                    bound)

    main.spec = spec
    return vg, prepare, main


def make_fused_vg(rcfg, mode: str, w_color: float, w_reg: float = 0.0005,
                  with_color: bool = True, param_grads: bool = True,
                  w_beyond: float = 0.0, with_ray_grads: bool = True):
    """vg(decoder, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, bound)
      -> (loss, dparams, dray_o, dray_d, (depth, depth_var, color))."""
    return _make_vg_parts(rcfg, mode, w_color, w_reg, with_color,
                          param_grads, w_beyond, with_ray_grads)[0]


def make_fused_vg_split(rcfg, mode: str, w_color: float,
                        w_reg: float = 0.0005, with_color: bool = True,
                        param_grads: bool = True, w_beyond: float = 0.0,
                        with_ray_grads: bool = True):
    """(prepare, main): prepare(decoder, rays_o, rays_d, gt_d, bound) -> z2;
    main(decoder, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, z2, bound)
    -> the outputs of make_fused_vg's vg."""
    _, prepare, main = _make_vg_parts(rcfg, mode, w_color, w_reg,
                                      with_color, param_grads, w_beyond,
                                      with_ray_grads)
    return prepare, main


class _FusedVGFn(torch.autograd.Function):
    """Loss as an autograd node whose backward hands out the gradients the
    forward already computed, scaled by the incoming gradient."""

    @staticmethod
    def forward(ctx, run, rays_o, rays_d, *params):
        loss, dparams, dro, drd, aux = run()
        ctx.grads = (dro, drd, [None if dparams is None else dparams[k]
                                for k in PARAM_NAMES][:len(params)])
        ctx.mark_non_differentiable(*aux)
        return (loss,) + tuple(aux)

    @staticmethod
    def backward(ctx, g, *_):
        dro, drd, dps = ctx.grads
        scale = lambda t: None if t is None else t * g
        return (None, scale(dro), scale(drd)) + tuple(scale(t) for t in dps)


def fused_vg_loss(main, decoder, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg,
                  z2, bound):
    """main(...) as a differentiable loss: returns (loss, depth, var, col).
    loss.backward() puts the parameter gradients into the decoder's .grad
    (mapper) and chains d(loss)/d(rays) into whatever built rays_o/rays_d
    (tracker, bundle adjustment)."""
    params = params_of(decoder)
    plist = [params[k] for k in PARAM_NAMES] if main.spec.param_grads \
        else []

    def run():
        return main(params, rays_o, rays_d, gt_d, gt_c, ray_w, t_reg, z2,
                    bound)

    return _FusedVGFn.apply(run, rays_o, rays_d, *plist)
