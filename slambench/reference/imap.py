"""Plain reference of the iMAP* field (`"reference": "imap"` in a
configuration): the field, its renderer, the mapper's and the tracker's
losses, Adam, and the first steps of a captured mapper or tracker call.

Written from the published description (iMAP* in NICE-SLAM, with
pointNeRF-SLAM's termination band and the repo's fused sampling
schedule), in plain torch float32 with TF32 off. It imports nothing of
the program and takes no tensor the program derived: rays, far bounds,
pass-1 densities, importance depths and regulation depths are worked out
again here from the pixels, cameras and uniforms the run drew.

  field    h = sin(x @ B) (x @ B as fused multiply-adds in float32);
           4 x (256, ReLU); raw RGBA = h @ Wo + bo; sigma 100 outside the
           scene bound (strict interior).
  render   near 0.01 d*, far = the bound's exit + 0.01, clipped to 1.2
           max(d*) over the batch; S1 stratified depths, SI deterministic
           inverse-CDF depths from the pass-1 weights over the strata
           midpoints, merged and sorted; alpha compositing with a last
           interval of 1e10, all intervals scaled by |d|.
  mapper   sum |d* - D| m + w_c sum |c* - C|_1 w + w_r sum |sigma_reg| w
           + w_b sum (1 - in-band mass) m, m = (d* > 0) w; regulation at
           SR depths stratified over [0, 0.85 d*] and moved in their strata
           by the run's uniforms; in-band: z in [d* - 0.10, d* + 0.05].
  tracker  sum |d* - D| / sqrt(Var + 1e-10) m + w_c sum |c* - C|_1 m,
           m = d* > 0, Var held constant.

`quant` is the precision of the operands of the hidden and head products,
forward and backward (the cotangent entering each product's backward is
rounded too; accumulation is float32 in every case): "bf16" (PRECISION),
the configuration's stated precision and the reference's own; "fp8"
(CONTROL, float8 e4m3), the control one step below; None, float32. x @ B,
its gradient and the bias gradients stay in true float32.

The interface every reference module gives check.py:

  PRECISION, CONTROL   the names of the program's precision and of the
                       control's
  consts(cfg)          what the steps read from the configuration
  init(seed, cfg, quant)
                       every leaf the system starts from, by name: the
                       decoder drawn from the seed, in float32 at
                       PRECISION, rounded to bf16 (the step below the
                       weights' float32) at CONTROL
  follow_map(cap, c, steps, quant), follow_track(cap, c, steps, quant)
                       the reference's own first `steps` optimizer steps
                       of a captured call (below)

Each call is followed on the reference's own path: its own rays, far
bounds, importance depths, loss, gradients by autograd and Adam, starting
from the program's state at the call's start (the decoder, or the
camera), since a SLAM run's state after hundreds of frames can only be
taken from the run. The pixel indices and regulation uniforms are
consumed in the engine's order: one pixel batch (and one set of
importance depths) per resample round of K steps, one set of regulation
uniforms per mapper step.
"""

from __future__ import annotations

import math

import torch

from slambench.reference.camera import quat_to_rot

PRECISION = "bf16"      # the configuration's: the products' operands
CONTROL = "fp8"         # one step below

IN_BAND_LO, IN_BAND_HI = 0.10, 0.05
LAYERS = ("layers.0", "layers.1", "layers.2", "layers.3")


LOW = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def _low(x: torch.Tensor, quant) -> torch.Tensor:
    return x.to(LOW[quant]).to(x.dtype)


class _LowMatmul(torch.autograd.Function):
    """a @ w on operands rounded to `quant`, accumulated in float32. Its
    backward rounds the incoming cotangent to `quant` too before each of
    its two products (da = g w^T, dw = a^T g), as every product on
    low-precision operands does; a bias added after it takes the unrounded
    cotangent."""

    @staticmethod
    def forward(ctx, a, w, quant):
        a, w = _low(a, quant), _low(w, quant)
        ctx.save_for_backward(a, w)
        ctx.quant = quant
        return a @ w

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = _low(g, ctx.quant)
        return g @ w.T, a.T @ g, None


def _mm(a: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    return a @ w if quant is None else _LowMatmul.apply(a, w, quant)


def init_decoder(seed: int, emb: int = 93, hidden: int = 256,
                 blocks: int = 4, out: int = 4) -> dict:
    """The decoder the configuration starts from, drawn from the seed: B ~
    N(0, 1) x 25 (3, emb), then Xavier-uniform weights (gain sqrt(2) for
    the ReLU layers, 1 for the head) with zero biases, in that order from
    one CPU generator seeded `seed`."""
    g = torch.Generator().manual_seed(int(seed))
    p = {"embedder.B": torch.randn(3, emb, generator=g) * 25.0}
    dims = [emb] + [hidden] * blocks
    for i in range(blocks):
        lim = math.sqrt(2.0) * math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        w = torch.rand(dims[i], dims[i + 1], generator=g)
        p[f"layers.{i}.w"] = w * (2 * lim) - lim
        p[f"layers.{i}.b"] = torch.zeros(dims[i + 1])
    lim = math.sqrt(6.0 / (hidden + out))
    w = torch.rand(hidden, out, generator=g)
    p["out.w"] = w * (2 * lim) - lim
    p["out.b"] = torch.zeros(out)
    return p


def fourier(x: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """x @ B in float32 as a chain of fused multiply-adds, x0 B0 first
    (each step one float64 product-sum rounded once to float32)."""
    acc = x[:, 0:1] * B[0]
    for k in range(1, B.shape[0]):
        acc = (x[:, k:k + 1].double() * B[k].double() + acc.double()).float()
    return acc


def field(p: dict, x: torch.Tensor, quant="bf16") -> torch.Tensor:
    """Points (N, 3) -> raw RGBA (N, 4)."""
    h = torch.sin(fourier(x, p["embedder.B"]))
    for name in LAYERS:
        h = torch.relu(_mm(h, p[name + ".w"], quant) + p[name + ".b"])
    return _mm(h, p["out.w"], quant) + p["out.b"]


def _sigma(p, x, bound, quant):
    """Density at points x (..., 3): the field's, 100 outside the bound."""
    raw = field(p, x.reshape(-1, 3), quant).reshape(x.shape[:-1] + (4,))
    inside = ((x > bound[:, 0]) & (x < bound[:, 1])).all(-1)
    return raw, torch.where(inside, raw[..., 3],
                            torch.full_like(raw[..., 3], 100.0))


def rays(cam7: torch.Tensor, i: torch.Tensor, j: torch.Tensor, K: tuple):
    """Rays (N, 3) of pixel columns i and rows j under camera
    [qw qx qy qz tx ty tz]; camera -z forward, +y up."""
    fx, fy, cx, cy = K
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       -1)
    rd = dirs @ quat_to_rot(cam7[:4]).T
    return cam7[4:].expand_as(rd), rd


def far_clip(ro, rd, gt_d, bound):
    d = torch.where(rd.abs() < 1e-12, torch.full_like(rd, 1e-12), rd)
    t = (bound[None] - ro.detach()[..., None]) / d.detach()[..., None]
    far = t.amax(2).amin(1) + 0.01
    return torch.minimum(far.clamp(min=0.0), (gt_d * 1.2).max())


def weights(sigma, z, dnorm):
    dist = torch.cat([z[:, 1:] - z[:, :-1],
                      torch.full_like(z[:, :1], 1e10)], 1) * dnorm
    alpha = 1.0 - torch.exp(-sigma.clamp(min=0.0) * dist)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     (1.0 - alpha + 1e-10)[:, :-1]], 1), 1)
    return alpha * trans


def importance_z(p, ro, rd, gt_d, far, bound, s1: int, si: int,
                 quant="bf16") -> torch.Tensor:
    """The merged sorted depths (N, s1 + si): s1 stratified from 0.01 d* to
    far, si at evenly spaced quantiles of the pass-1 weights over the
    strata midpoints. No gradient."""
    with torch.no_grad():
        t = torch.arange(s1, dtype=torch.float32, device=ro.device) / (s1 - 1)
        z1 = (0.01 * gt_d)[:, None] * (1 - t) + far[:, None] * t
        x1 = ro[:, None] + rd[:, None] * z1[..., None]
        _, s = _sigma(p, x1, bound, quant)
        w = weights(s, z1, rd.norm(dim=1, keepdim=True))[:, 1:-1] + 1e-5
        cdf = torch.cumsum(w / w.sum(1, keepdim=True), 1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], 1)
        bins = 0.5 * (z1[:, 1:] + z1[:, :-1])
        u = torch.linspace(0.0, 1.0, si, device=ro.device).expand(
            cdf.shape[0], si).contiguous()
        idx = torch.searchsorted(cdf.contiguous(), u, right=True)
        lo = (idx - 1).clamp(min=0)
        hi = idx.clamp(max=cdf.shape[1] - 1)
        c_lo, c_hi = cdf.gather(1, lo), cdf.gather(1, hi)
        b_lo, b_hi = bins.gather(1, lo), bins.gather(1, hi)
        den = torch.where(c_hi - c_lo < 1e-5, torch.ones_like(c_lo),
                          c_hi - c_lo)
        zs = b_lo + (u - c_lo) / den * (b_hi - b_lo)
        return torch.sort(torch.cat([z1, zs], 1), 1)[0]


def composite(p, ro, rd, z, bound, quant="bf16"):
    """Depth, variance and colour (N,), (N,), (N, 3), and the weights, of
    rays at depths z."""
    x = ro[:, None] + rd[:, None] * z[..., None]
    raw, s = _sigma(p, x, bound, quant)
    w = weights(s, z, rd.norm(dim=1, keepdim=True))
    depth = (w * z).sum(1)
    var = (w * (z - depth[:, None]) ** 2).sum(1)
    col = (w[..., None] * raw[..., :3]).sum(1)
    return depth, var, col, w


def mapper_loss(p, ro, rd, gt_d, gt_c, ray_w, t_reg, z, bound, w_color,
                w_reg, w_beyond, quant="bf16"):
    depth, _, col, w = composite(p, ro, rd, z, bound, quant)
    m = (gt_d > 0).float() * ray_w
    loss = ((gt_d - depth).abs() * m).sum()
    band = ((z > gt_d[:, None] - IN_BAND_LO)
            & (z < gt_d[:, None] + IN_BAND_HI)).float()
    loss = loss + w_beyond * ((1.0 - (w * band).sum(1)) * m).sum()
    loss = loss + w_color * ((gt_c - col).abs().sum(1) * ray_w).sum()
    sr = t_reg.shape[1]
    base = (0.85 * gt_d)[:, None] * (torch.arange(
        sr, dtype=torch.float32, device=z.device) / (sr - 1))
    mid = 0.5 * (base[:, 1:] + base[:, :-1])
    lower = torch.cat([base[:, :1], mid], 1)
    upper = torch.cat([mid, base[:, -1:]], 1)
    zr = lower + (upper - lower) * t_reg
    _, s_reg = _sigma(p, ro[:, None] + rd[:, None] * zr[..., None], bound,
                      quant)
    return loss + w_reg * (s_reg.abs() * ray_w[:, None]).sum()


def tracker_loss(p, ro, rd, gt_d, gt_c, z, bound, w_color, quant="bf16"):
    depth, var, col, _ = composite(p, ro, rd, z, bound, quant)
    m = (gt_d > 0).float()
    loss = ((gt_d - depth).abs() / torch.sqrt(var.detach() + 1e-10)
            * m).sum()
    return loss + w_color * ((gt_c - col).abs().sum(1) * m).sum()


class Adam:
    """Adam (beta 0.9 / 0.999, bias-corrected), one learning rate a leaf."""

    def __init__(self, lrs: dict, eps: float = 1e-8):
        self.lrs, self.eps, self.t = lrs, eps, 0
        self.m, self.v = {}, {}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        out = {}
        for k, g in grads.items():
            m = 0.9 * self.m.get(k, torch.zeros_like(g)) + 0.1 * g
            v = 0.999 * self.v.get(k, torch.zeros_like(g)) + 0.001 * g * g
            self.m[k], self.v[k] = m, v
            mh = m / (1 - 0.9 ** self.t)
            vh = v / (1 - 0.999 ** self.t)
            out[k] = params[k] - self.lrs[k] * mh / (vh.sqrt() + self.eps)
        return out


def consts(cfg: dict) -> dict:
    m, t, cam = cfg["mapping"], cfg["tracking"], cfg["cam"]
    frames = m["mapping_window_size"] + 1
    k_map = max(int(m.get("resample_every", 1)), 1)
    k_trk = max(int(t.get("resample_every", 1)), 1)
    return {
        "ppf": m["pixels"] // frames, "width": cam["W"],
        "intr": (cam["fx"], cam["fy"], cam["cx"], cam["cy"]),
        "s1": cfg["rendering"]["N_samples"],
        "si": cfg["rendering"]["N_importance"],
        "w_color": m["w_color_loss"], "w_reg": 0.0005,
        "w_beyond": m.get("w_beyond_loss", 0.0), "lr": m["imap_decoders_lr"],
        "k_map": k_map,
        "w_color_t": t["w_color_loss"],
        "lr_quad": t["lr"] * (0.2 if t["seperate_LR"] else 1.0),
        "lr_trans": t["lr"],
        "k_track": k_trk if t["iters"] % k_trk == 0 else 1,
    }


def init(seed: int, cfg: dict, quant) -> dict:
    """The decoder the configuration starts from (init_decoder), rounded
    to bf16 at CONTROL."""
    p = init_decoder(seed)
    if quant == CONTROL:
        return {k: v.to(torch.bfloat16).float() for k, v in p.items()}
    return p


def _pixels(idx: torch.Tensor, width: int):
    return ((idx % width).to(torch.float32),
            torch.div(idx, width, rounding_mode="floor").to(torch.float32))


def follow_map(cap: dict, c: dict, steps: int = 3, quant=PRECISION) -> dict:
    """cap: params0, colors (F, H, W, 3) u8, depths (F, H, W), cams (F, 7),
    valid (F,), bound, draws, num_iters; c: consts. Returns losses
    [steps], grads1 {leaf: tensor}, params1 and params {leaf: tensor}
    after the first step and after `steps`. A call whose iterations K
    does not divide resamples every step, as the engine does."""
    k_map = c["k_map"] if cap["num_iters"] % c["k_map"] == 0 else 1
    p = {k: v.detach().float().clone() for k, v in cap["params0"].items()}
    adam = Adam({k: c["lr"] for k in p})
    draws = iter(cap["draws"])
    colors, depths = cap["colors"], cap["depths"]
    F = colors.shape[0]
    fr = torch.arange(F, device=depths.device)[:, None]
    valid = cap["valid"].to(torch.float32)
    ppf = c["ppf"]
    ray_w = valid.repeat_interleave(ppf) * (F / valid.sum().clamp(min=1.0))
    losses, grads1, params1, done = [], None, None, 0
    while done < steps:
        idx = next(draws)
        gt_d = depths.reshape(F, -1)[fr, idx].reshape(-1)
        gt_c = (colors.reshape(F, -1, 3)[fr, idx].to(torch.float32)
                / 255.0).reshape(-1, 3)
        i, j = _pixels(idx, c["width"])
        ro, rd = [], []
        for f in range(F):
            o, d = rays(cap["cams"][f].float(), i[f], j[f], c["intr"])
            ro.append(o)
            rd.append(d)
        ro, rd = torch.cat(ro), torch.cat(rd)
        far = far_clip(ro, rd, gt_d, cap["bound"])
        z = importance_z(p, ro, rd, gt_d, far, cap["bound"], c["s1"],
                         c["si"], quant)
        for _ in range(k_map):
            if done == steps:
                break
            t_reg = next(draws)
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            loss = mapper_loss(leaves, ro, rd, gt_d, gt_c, ray_w, t_reg, z,
                               cap["bound"], c["w_color"], c["w_reg"],
                               c["w_beyond"], quant)
            g = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
            grads1 = g if grads1 is None else grads1
            losses.append(float(loss.detach()))
            with torch.no_grad():
                p = adam.step({k: v.detach() for k, v in leaves.items()}, g)
            params1 = p if params1 is None else params1
            done += 1
    return {"losses": losses, "grads1": grads1, "params1": params1,
            "params": p}


def follow_track(cap: dict, c: dict, steps: int = 3,
                 quant=PRECISION) -> dict:
    """cap: params (the decoder), cam0 (7,), color (H, W, 3) float,
    depth (H, W), bound, draws; c: consts. Returns losses [steps], grads1
    {quad, trans}, cam1 and cam (7,) after the first step and after
    `steps`."""
    p = {k: v.detach().float() for k, v in cap["params"].items()}
    cam = {"quad": cap["cam0"][:4].clone(), "trans": cap["cam0"][4:].clone()}
    adam = Adam({"quad": c["lr_quad"], "trans": c["lr_trans"]})
    draws = iter(cap["draws"])
    width = c["width"]
    losses, grads1, cam1, done = [], None, None, 0
    while done < steps:
        idx = next(draws)
        gt_d = cap["depth"].reshape(-1)[idx]
        gt_c = cap["color"].reshape(-1, 3)[idx].float()
        i, j = _pixels(idx, width)
        with torch.no_grad():
            ro, rd = rays(torch.cat([cam["quad"], cam["trans"]]), i, j,
                          c["intr"])
            far = far_clip(ro, rd, gt_d, cap["bound"])
            z = importance_z(p, ro, rd, gt_d, far, cap["bound"], c["s1"],
                             c["si"], quant)
        for _ in range(c["k_track"]):
            if done == steps:
                break
            q = cam["quad"].detach().requires_grad_(True)
            t = cam["trans"].detach().requires_grad_(True)
            ro, rd = rays(torch.cat([q, t]), i, j, c["intr"])
            loss = tracker_loss(p, ro, rd, gt_d, gt_c, z, cap["bound"],
                                c["w_color_t"], quant)
            gq, gt = torch.autograd.grad(loss, [q, t])
            g = {"quad": gq, "trans": gt}
            grads1 = g if grads1 is None else grads1
            losses.append(float(loss.detach()))
            with torch.no_grad():
                cam = adam.step({"quad": q.detach(), "trans": t.detach()}, g)
            cam1 = torch.cat([cam["quad"], cam["trans"]]) if cam1 is None \
                else cam1
            done += 1
    return {"losses": losses, "grads1": grads1, "cam1": cam1,
            "cam": torch.cat([cam["quad"], cam["trans"]])}
