"""The port's CUDA kernels against their plain PyTorch versions, on the
card (`cuda` marker; skipped without one):

  python -m pytest tests/test_torch_cuda.py -q

Each check runs on two decoders: a random one, and the same one after a
short mapping run on the kernels, where the tracker's depth weights
1/sqrt(var) are no longer set by rays with var ~ 0. The comparisons and
tolerances are chip_smoke.py's (`check_p1`, `check_vg`): loss rtol 1e-3;
parameter gradients atol 2e-2 * max|g| (off the rays at a loss kink, as
the ray gradients); ray gradients cosine > 0.999 and
norm ratio in [0.98, 1.02] on the rays off the loss kinks (for the
tracker also on those with var >= 1e-4); depth and colour within 1e-3 on
>= 95% of rays and within 2e-2 on every ray off the last-interval step;
sigma within 2e-2 * max|sigma| and within 1e-3 * (1 + |sigma|) on
>= 95%. K5/K6 (`check_mlp`): the decoder's output within 1e-3 (1 + |raw|)
on >= 98% of values and 2e-2 max|raw| on all; dx and every parameter
gradient by cosine >= 0.9999 and norm ratio within 1e-3. K1, K2 and the
render pair K3/K4 and the decoder pair K5/K6 also at ragged sizes (K5/K6
with canaries past the last row), two launches of K1, of K3/K4 and of
K5/K6 bit for bit, K3's pass-1 sigma bit for bit K2's, K5's raw bit for
bit K1's forward raw on K1's points, and one wgmma product on the
kernels' shared-memory images (`hopper_mma_probe`)."""

import numpy as np
import pytest
import torch

import chip_smoke as S
from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
from pointnerf_slam_torch.ops import fused_vg as F
from pointnerf_slam_torch.render.renderer import RenderConfig

MAPPER = dict(w_color=0.05, w_reg=0.0005)
TRACKER = dict(w_color=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def setup(dev, n=300, seed=21, mapped=False):
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1, 1, (n, 3))
    d = rng.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(
        0.9, 1.3, (n, 1))
    gt_d = rng.uniform(0.5, 2.5, n)
    gt_d[::7] = 0.0
    ray_w = np.ones(n)
    ray_w[1::5] = 1.5
    arrays = (ro, rd, gt_d, rng.uniform(size=(n, 3)), ray_w,
              rng.uniform(size=(n, 32)))
    rays = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]
    bound = torch.tensor([[-4.0, 4.0]] * 3, device=dev)
    dec = dec.to(dev)
    if mapped:
        fit(dec, rays, bound)
    return dec, rays, bound


def fit(dec, rays, bound, iters=200):
    """A short mapping run on the kernels (K=4, Adam lr 1e-3)."""
    prep, main = F.make_fused_vg_split(RenderConfig(), "mapper", **MAPPER,
                                       w_beyond=1.0, with_ray_grads=False)
    opt = torch.optim.Adam(dec.parameters(), lr=1e-3, eps=1e-8)
    for it in range(iters):
        if it % 4 == 0:
            z2 = prep(dec, *rays[:3], bound)
        loss = F.fused_vg_loss(main, dec, *rays, z2, bound)[0]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()


def sigma_noise(dec, rays, bound):
    """Twice the largest p1 sigma difference on these rays."""
    pw = F.pack_weights(F.params_of(dec))
    return 2 * S.check_p1(torch, F, pw, F._pack_rays(*rays[:3], bound),
                          bound, "test")


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True])
def test_cuda_p1_sigma_matches_plain(cuda, mapped):
    dec, rays, b = setup(cuda, mapped=mapped)
    before = F.launches["p1_sigma"]
    sigma_noise(dec, rays, b)
    assert F.launches["p1_sigma"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("mode,kw", [
    ("mapper", dict(MAPPER, w_beyond=1.0, with_ray_grads=False)),
    ("mapper", dict(MAPPER, w_beyond=1.0)),
    ("tracker", dict(TRACKER, param_grads=False))])
def test_cuda_fused_vg_matches_plain(cuda, mode, kw, mapped):
    dec, rays, b = setup(cuda, mapped=mapped)
    noise = sigma_noise(dec, rays, b)
    prep, main = F.make_fused_vg_split(RenderConfig(), mode, **kw)
    z2 = prep(dec, *rays[:3], b)
    args = (*rays, z2, b)
    params = F.params_of(dec)
    out_k = main(dec, *args)
    out_p = F.fused_vg_reference(main.spec, params, *args)
    S.check_vg(f"{mode}{kw}", out_k, out_p, main.spec, args, params, noise)
    if not main.spec.param_grads:
        assert out_k[1] is None
    if not main.spec.with_ray_grads:
        assert float(out_k[2].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_fused_vg_loss_backward(cuda):
    """The autograd node hands the kernel's gradients to the decoder and
    to the rays' graph."""
    dec, rays, b = setup(cuda, n=200, seed=3)
    prep, main = F.make_fused_vg_split(RenderConfig(), "mapper", **MAPPER)
    ro = rays[0].clone().requires_grad_(True)
    z2 = prep(dec, *rays[:3], b)
    ref = main(dec, *rays, z2, b)
    loss = F.fused_vg_loss(main, dec, ro, *rays[1:], z2, b)[0]
    loss.backward()
    for k, p in F.params_of(dec).items():
        torch.testing.assert_close(p.grad, ref[1][k])
    torch.testing.assert_close(ro.grad, ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("with_reg", [False, True])
def test_cuda_megakernel_matches_plain(cuda, with_reg, mapped):
    """K3/K4 against fused_render_reference's pieces (chip_smoke's
    check_render: z2, per-ray outputs, var, sigma_reg, and the gradients
    of a loss linear in the outputs, with and without weight gradients)."""
    dec, rays, b = setup(cuda, mapped=mapped)
    noise = sigma_noise(dec, rays, b)
    before = (F.launches["megakernel_fwd"], F.launches["megakernel_bwd"])
    S.check_render(torch, "test", dec, rays[0], rays[1], rays[2], rays[5], b,
                   with_reg, noise)
    assert F.launches["megakernel_fwd"] > before[0]
    assert F.launches["megakernel_bwd"] > before[1]


@pytest.mark.cuda
def test_cuda_megakernel_out_of_bound_sentinel(cuda):
    """Rays entirely outside the AABB composite against sigma 100 and get
    no sigma cotangent: K3 equals the plain version there."""
    from pointnerf_slam_torch.ops.megakernel import make_fused_render
    dec, rays, b = setup(cuda, n=130, seed=4)
    ro = rays[0] + 10.0
    render = make_fused_render(RenderConfig(), with_reg=True)
    k = render(dec, ro, rays[1], rays[2], rays[5], b)
    with torch.no_grad():
        p = render({n: t.cpu() for n, t in F.params_of(dec).items()},
                   ro.cpu(), rays[1].cpu(), rays[2].cpu(), rays[5].cpu(),
                   b.cpu())
    torch.testing.assert_close(k[3].cpu(), p[3], atol=1e-3, rtol=0)
    torch.testing.assert_close(k[0].detach().cpu(), p[0], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True])
def test_cuda_megakernel_tracker_shape(cuda, mapped):
    """K3/K4 at box_ba_dynamic's tracker launch (24 + 8 samples, no
    regulation, its 1500 rays) through chip_smoke's check_render, K3's
    middle included."""
    dec, rays, b = setup(cuda, n=1500, mapped=mapped)
    noise = sigma_noise(dec, rays, b)
    S.check_render(torch, "test 24+8", dec, rays[0], rays[1], rays[2],
                   rays[5][:, :24].contiguous(), b, False, noise, S1=24,
                   SI=8)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 700, 1025])
def test_cuda_fused_mlp_tail_tiles(cuda, n):
    """K5/K6 at the tile edges (128-point tiles; K6 pads to 1024 points)."""
    dec, _, _ = setup(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.rand(n, 3, generator=gen, device=cuda) * 4 - 2
    g = torch.randn(n, 4, generator=gen, device=cuda)
    before = (F.launches["fused_mlp_fwd"], F.launches["fused_mlp_bwd"])
    S.check_mlp(torch, f"test {n}", {k: v.detach() for k, v in
                                     F.params_of(dec).items()}, x, g)
    assert F.launches["fused_mlp_fwd"] == before[0] + 1
    assert F.launches["fused_mlp_bwd"] == before[1] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 127, 128, 129, 131073])
def test_cuda_fused_mlp_ragged_canaries(cuda, n):
    """K5/K6 at ragged sizes against the 128-point tiles and K6's padding
    to 1024 points: check_mlp on inputs whose rows past n are NaN (a read
    past row n - 1 would poison K6's weight gradients through the
    padding's zero cotangents), then direct launches into buffers with
    canary values past row n of K5's raw and K6's dx, which must stay
    untouched; those launches equal the wrappers' bit for bit."""
    import ctypes
    from pointnerf_slam_torch.ops import build
    from pointnerf_slam_torch.ops import fused_mlp as M
    dec, _, _ = setup(cuda)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    gen = torch.Generator(device=cuda).manual_seed(n)
    pad = 300
    xb = torch.full((n + pad, 3), float("nan"), device=cuda)
    gb = torch.full((n + pad, 4), float("nan"), device=cuda)
    xb[:n] = torch.rand(n, 3, generator=gen, device=cuda) * 4 - 2
    gb[:n] = torch.randn(n, 4, generator=gen, device=cuda)
    x, g = xb[:n], gb[:n]
    S.check_mlp(torch, f"ragged {n}", params, x, g)
    lib = build.load("fused_mlp")
    lib.mlp_fwd.restype = lib.mlp_bwd.restype = ctypes.c_int
    lib.mlp_bwd_workspace_bytes.restype = ctypes.c_longlong
    pw = F.pack_weights(params).with_images(chain=True)
    out = torch.full((n + pad, 4), 7.25, device=cuda)
    dx = torch.full((n + pad, 3), -3.5, device=cuda)
    grads = torch.empty(F.GRAD_LEN, device=cuda)
    ws = torch.empty(int(lib.mlp_bwd_workspace_bytes(ctypes.c_longlong(n),
                                                     ctypes.c_int(1))),
                     dtype=torch.uint8, device=cuda)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    build.check(lib, lib.mlp_fwd(pw.pointers(), ptr(x), ptr(out),
                                 ctypes.c_longlong(n), F._stream(x)),
                "mlp_fwd")
    build.check(lib, lib.mlp_bwd(pw.pointers(), ptr(x), ptr(g), ptr(ws),
                                 ptr(dx), ptr(grads), ctypes.c_longlong(n),
                                 ctypes.c_int(1), ctypes.c_int(1),
                                 F._stream(x)), "mlp_bwd")
    torch.cuda.synchronize()
    assert bool((out[n:] == 7.25).all()) and bool((dx[n:] == -3.5).all())
    assert torch.equal(out[:n], M.k5_forward(params, x))
    dx_w, g_w = M.k6_backward(params, x, g, True, True)
    assert torch.equal(dx[:n], dx_w)
    got = F._unpack_grads(grads, params["embedder.B"].shape[1])
    for k in F.PARAM_NAMES:
        assert torch.equal(got[k], g_w[k]), k
        assert bool(torch.isfinite(got[k]).all()), k


@pytest.mark.cuda
def test_cuda_fused_mlp_bit_reproducible(cuda):
    """Two K5 launches give the same raw, and two K6 launches of each kind
    (dx and weight gradients, dx only, weight gradients only) the same dx
    and weight gradients, bit for bit (split-K partials and ordered
    reduces, no atomics), at the mapper loss's 379,848 points with its own
    cotangent."""
    from pointnerf_slam_torch.ops import fused_mlp as M
    dec, rays, b = setup(cuda, n=4998)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    x_all, x, g = S.plain_mapper_points(torch, params, *rays, b)
    assert torch.equal(M.k5_forward(params, x_all),
                       M.k5_forward(params, x_all))
    for pg, xg in ((True, True), (False, True), (True, False)):
        a = M.k6_backward(params, x, g, pg, xg)
        c = M.k6_backward(params, x, g, pg, xg)
        torch.cuda.synchronize()
        if xg:
            assert torch.equal(a[0], c[0]) and bool(torch.isfinite(a[0]).all())
        if pg:
            for k in F.PARAM_NAMES:
                assert torch.equal(a[1][k], c[1][k]), (pg, xg, k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mapper", "tracker"])
def test_cuda_fused_mlp_forward_is_k1s(cuda, mode):
    """K5's raw on K1's own points (x, y, z of the x4 its forward wrote,
    read from its workspace after a launch) equals K1's forward raw bit for
    bit: the same Hopper forward tile and the same arithmetic, fed the
    points from a (N, 3) array in place of points along rays (the mapper
    runs K1's forward with its bf16 spill, the tracker without)."""
    import ctypes
    from pointnerf_slam_torch.ops import build
    from pointnerf_slam_torch.ops import fused_mlp as M
    dec, rays, b = setup(cuda, n=4998)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    kw = (dict(MAPPER, w_beyond=1.0) if mode == "mapper"
          else dict(TRACKER, param_grads=False))
    prep, main = F.make_fused_vg_split(RenderConfig(), mode, **kw)
    z2 = prep(dec, *rays[:3], b)
    spec = main.spec
    lib = build.load("fused_vg")
    launch, _ = F.vg_launch(lib, spec, params, *rays, z2, b)
    launch()
    ws = launch.keep[-1]
    n, S2 = z2.shape
    SR = spec.SR if spec.with_reg else 0
    P = n * (S2 + SR)
    lib.fused_vg_ws_offset.restype = ctypes.c_longlong
    off = [int(lib.fused_vg_ws_offset(
        ctypes.c_int(n), ctypes.c_int(S2), ctypes.c_int(SR),
        ctypes.c_int(int(spec.param_grads)), ctypes.c_int(w)))
        for w in (0, 1)]
    x4, raw = (ws[o:o + P * 16].view(torch.float32).reshape(P, 4)
               for o in off)
    raw5 = M.k5_forward(params, x4[:, :3].contiguous())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(raw).all())
    assert torch.equal(raw5, raw), float((raw5 - raw).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True])
def test_cuda_fused_mlp_mapper_shape(cuda, mapped):
    """K5 at the mapper's plain-path shape (4998 rays x (32 + 44 + 32) =
    539,784 points along rays) and K6 at the points its loss reaches
    (379,848) with the loss's own cotangent (chip_smoke's
    plain_mapper_points)."""
    dec, rays, b = setup(cuda, n=4998, mapped=mapped)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    x_all, x_live, g = S.plain_mapper_points(torch, params, rays[0], rays[1],
                                             rays[2], rays[3], rays[4],
                                             rays[5], b)
    assert x_all.shape[0] == 539784 and x_live.shape[0] == 379848
    S.check_mlp(torch, "test mapper", params, x_all)
    S.check_mlp(torch, "test mapper loss", params, x_live, g)


@pytest.mark.cuda
def test_cuda_fused_decoder_autograd(cuda):
    """IMAPDecoder(fused=True) on the card launches K5 forward and K6
    backward through autograd, and its gradients are the direct K6 call's."""
    import dataclasses
    dec, _, _ = setup(cuda)
    dec.cfg = dataclasses.replace(dec.cfg, fused=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.rand(3000, 3, generator=gen, device=cuda) * 4 - 2
         ).requires_grad_(True)
    g = torch.randn(3000, 4, generator=gen, device=cuda)
    before = (F.launches["fused_mlp_fwd"], F.launches["fused_mlp_bwd"])
    dec(x).backward(g)
    assert F.launches["fused_mlp_fwd"] == before[0] + 1
    assert F.launches["fused_mlp_bwd"] == before[1] + 1
    from pointnerf_slam_torch.ops.fused_mlp import k6_backward
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    dx, dps = k6_backward(params, x.detach(), g, True, True)
    assert torch.equal(x.grad, dx)
    for k, p in F.params_of(dec).items():
        assert torch.equal(p.grad, dps[k]), k


# K1 at ragged shapes: merged samples per ray S2 = S1 + SI from the real
# pass 1 and importance resample; SR = 32 regulation samples with the
# mapper's loss, SR = 0 with the tracker's
_S2_SPLIT = {20: (12, 8), 32: (24, 8), 44: (32, 12), 64: (40, 24)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 333, 1500, 4998])
@pytest.mark.parametrize("S2", sorted(_S2_SPLIT))
@pytest.mark.parametrize("SR", [0, 32])
@pytest.mark.parametrize("pg,rg", [(True, True), (True, False),
                                   (False, True), (False, False)])
def test_cuda_fused_vg_ragged(cuda, n, S2, SR, pg, rg):
    """The Hopper K1 (128-point tiles over a point count padded to 1024)
    against its plain version with chip_smoke's check_vg, at every
    combination of parameter and ray gradients."""
    import dataclasses
    dec, rays, b = setup(cuda, n=n)
    if n < 8:           # keep a depth-supervised ray at the smallest sizes
        rays[2] = torch.where(rays[2] > 0, rays[2], torch.full_like(
            rays[2], 1.7))
    noise = sigma_noise(dec, rays, b)
    S1, SI = _S2_SPLIT[S2]
    mode, kw = (("mapper", dict(MAPPER, w_beyond=1.0)) if SR
                else ("tracker", dict(TRACKER)))
    prep, main = F.make_fused_vg_split(
        RenderConfig(N_samples=S1, N_importance=SI), mode, **kw,
        param_grads=pg, with_ray_grads=rg)
    spec = dataclasses.replace(main.spec, SR=SR)
    z2 = prep(dec, *rays[:3], b)
    assert z2.shape == (n, S2)
    args = (*rays, z2, b)
    params = F.params_of(dec)
    out_k = F._fused_vg_cuda(spec, params, *args)
    out_p = F.fused_vg_reference(spec, params, *args)
    S.check_vg(f"{mode} n={n} S2={S2} SR={SR} pg={pg} rg={rg}", out_k,
               out_p, spec, args, params, noise)
    assert (out_k[1] is None) == (not pg)
    if not rg:
        assert float(out_k[2].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 333, 4998])
@pytest.mark.parametrize("S1", [8, 24, 32])
def test_cuda_p1_sigma_ragged(cuda, n, S1):
    """The Hopper K2 (128-point tiles, ragged last tile) against its plain
    version with chip_smoke's check_p1."""
    dec, rays, b = setup(cuda, n=n)
    pw = F.pack_weights(F.params_of(dec))
    before = F.launches["p1_sigma"]
    S.check_p1(torch, F, pw, F._pack_rays(*rays[:3], b), b, f"n={n}", S1)
    assert F.launches["p1_sigma"] == before + 1


@pytest.mark.cuda
def test_cuda_fused_vg_bit_reproducible(cuda):
    """Two launches of the mapper K1 with weight and ray gradients give
    the same loss, gradients and ray gradients bit for bit (split-K
    partials and ordered reduces, no atomics)."""
    dec, rays, b = setup(cuda, n=4998)
    prep, main = F.make_fused_vg_split(RenderConfig(), "mapper", **MAPPER,
                                       w_beyond=1.0)
    z2 = prep(dec, *rays[:3], b)
    a = main(dec, *rays, z2, b)
    c = main(dec, *rays, z2, b)
    assert torch.equal(a[0], c[0])
    for k in F.PARAM_NAMES:
        assert torch.equal(a[1][k], c[1][k]), k
    assert torch.equal(a[2], c[2]) and torch.equal(a[3], c[3])
    for x, y in zip(a[4], c[4]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("tn", [0, 1])
def test_cuda_wgmma_tile_layout(cuda, tn):
    """One wgmma m64n256k16 x 4 product on the kernels' shared-memory
    images (`hopper_mma_probe`): K-major (tn = 0: a 64 x 64 activation
    chunk times a forward weight slice) and MN-major (tn = 1: the weight
    gradients' spill blocks, in^T @ dh) against a float64 product."""
    import ctypes
    from pointnerf_slam_torch.ops import build
    g = torch.Generator().manual_seed(tn)
    a = torch.randn(64, 64, generator=g).to(torch.bfloat16)
    bm = torch.randn(64, 256, generator=g).to(torch.bfloat16)
    if tn == 0:
        imgs = (F.swizzle128(a), F.swizzle128(bm.t().contiguous()))
        ref = a.double() @ bm.double()
    else:
        imgs = (F.swizzle128(a), F.swizzle128(bm))
        ref = a.double().t() @ bm.double()
    ai, bi = (t.contiguous().to(cuda) for t in imgs)
    out = torch.empty(64, 256, device=cuda)
    lib = build.load("fused_vg")
    lib.hopper_mma_probe.restype = ctypes.c_int
    rc = lib.hopper_mma_probe(ctypes.c_void_p(ai.data_ptr()),
                              ctypes.c_void_p(bi.data_ptr()),
                              ctypes.c_void_p(out.data_ptr()),
                              ctypes.c_int(tn), F._stream(out))
    build.check(lib, rc, "hopper_mma_probe")
    torch.cuda.synchronize()
    err = float((out.double().cpu() - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


# K3/K4 at ragged shapes: (S1, SI) of box_ba_dynamic's tracker (24 + 8), the
# bench tracker (32 + 12) and the mapper's two-kernel branch (40 + 24, the
# 64-sample edge); SR = S1 regulation samples or none
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 333, 1500, 5000])
@pytest.mark.parametrize("S1,SI", [(24, 8), (32, 12), (40, 24)])
@pytest.mark.parametrize("with_reg", [False, True])
def test_cuda_megakernel_ragged(cuda, n, S1, SI, with_reg):
    """The Hopper K3/K4 (pass 1 over n * S1 points in 128-point tiles, pass
    2 over n * (S1 + SI + SR) padded to 1024, up to 104 points per ray) at
    ragged sizes, with and without parameter gradients. From 333 rays up,
    against the plain version with chip_smoke's check_render (which
    launches K4 both ways). Below 8 rays check_render's ray-gradient bound
    (cosine and norm ratio over all rays, the reference's, set at >= 130
    rays) does not hold for any kernel with the TPU kernel's numerics (bf16
    cotangents and ties: the parent's WMMA K4 reads the same ratios to five
    digits, scripts/torch_kernel_compare.py): there K3/K4 on the n rays
    must give bit for bit what they give for the same rays inside a
    333-ray batch that meets check_render, since every per-ray result is
    computed per point and per ray (the batch's far clip is kept by
    including its deepest ray)."""
    from pointnerf_slam_torch.ops import megakernel as MK
    big = 333 if n < 8 else n
    dec, rays, b = setup(cuda, n=big)
    gen = torch.Generator(device=cuda).manual_seed(big + S1)
    t_reg = torch.rand(big, S1, generator=gen, device=cuda)
    if n >= 8:
        noise = sigma_noise(dec, rays, b)
        before = (F.launches["megakernel_fwd"],
                  F.launches["megakernel_bwd"])
        S.check_render(torch, f"n={n}", dec, rays[0], rays[1], rays[2],
                       t_reg, b, with_reg, noise, S1=S1, SI=SI)
        assert F.launches["megakernel_fwd"] > before[0]
        assert F.launches["megakernel_bwd"] >= before[1] + 2
        return
    sub = torch.cat([rays[2].argmax()[None], torch.arange(
        2, 2 + n - 1, device=cuda)])
    pw = F.pack_weights({k: v.detach() for k, v in F.params_of(dec).items()})
    cot = (torch.randn(big, generator=gen, device=cuda),
           torch.randn(big, generator=gen, device=cuda),
           torch.randn(big, 3, generator=gen, device=cuda),
           torch.randn(big, S1, generator=gen, device=cuda))
    outs = {}
    for tag, i in (("batch", torch.arange(big, device=cuda)), ("sub", sub)):
        f = MK.k3_forward(pw, rays[0][i], rays[1][i], rays[2][i], t_reg[i],
                          b, S1, SI, with_reg)
        rays8, treg, b6, SRk = f[5]
        k4 = [MK.k4_backward(pw, rays8, treg, f[4], b6, *[c[i] for c in cot],
                             S1, SRk, pg) for pg in (False, True)]
        outs[tag] = (f[:5], k4)
    torch.cuda.synchronize()
    (fb, kb), (fs, ks) = outs["batch"], outs["sub"]
    for x, y in zip(fb, fs):
        assert torch.equal(x[sub], y)
    for pg in (0, 1):
        assert torch.equal(kb[pg][0][sub], ks[pg][0])
    # with and without weight gradients: check_render's criterion
    assert float((ks[0][0] - ks[1][0]).abs().max()) <= 1e-6 * float(
        ks[1][0].abs().max())
    assert bool(torch.isfinite(ks[1][1]).all())
    assert bool(torch.isfinite(fs[0]).all()) and bool(
        torch.isfinite(ks[0][0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,S1,SI,with_reg", [
    (1, 24, 8, False), (333, 32, 12, True), (1500, 24, 8, False),
    (5000, 32, 12, False), (4998, 40, 24, True)])
def test_cuda_megakernel_pass1_is_k2(cuda, n, S1, SI, with_reg):
    """K3's pass-1 sigma, read from its workspace after a launch, equals
    K2's (p1_sigma) on the same rays bit for bit: both run the same
    128-point tiles of the Hopper forward."""
    import ctypes
    from pointnerf_slam_torch.ops import build
    from pointnerf_slam_torch.ops import megakernel as MK
    dec, rays, b = setup(cuda, n=n)
    rays[2] = torch.where(rays[2] > 0, rays[2], torch.full_like(rays[2],
                                                                1.7))
    pw = F.pack_weights(F.params_of(dec))
    t_reg = torch.rand(n, S1, generator=torch.Generator(
        device=cuda).manual_seed(n), device=cuda)
    lib = build.load("megakernel")
    launch, (_, _, z2, saved, ws) = MK.k3_launch(
        lib, pw, rays[0], rays[1], rays[2], t_reg, b, S1, SI, with_reg)
    launch()
    lib.mk_forward_sig1_offset.restype = ctypes.c_longlong
    off = int(lib.mk_forward_sig1_offset(
        ctypes.c_int(n), ctypes.c_int(S1), ctypes.c_int(SI),
        ctypes.c_int(saved[3])))
    sig_k3 = ws[off:off + n * S1 * 4].view(torch.float32).reshape(n, S1)
    sig_k2 = F.p1_sigma(pw, saved[0], b, S1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(z2).all())
    assert torch.equal(sig_k3, sig_k2), float((sig_k3 - sig_k2).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("with_reg", [False, True])
def test_cuda_megakernel_bit_reproducible(cuda, with_reg):
    """Two K3 launches give the same outputs and two K4 launches with
    weight gradients the same ray and weight gradients, bit for bit
    (split-K partials and ordered reduces, no atomics)."""
    from pointnerf_slam_torch.ops import megakernel as MK
    dec, rays, b = setup(cuda, n=4998)
    params = {k: v.detach() for k, v in F.params_of(dec).items()}
    pw = F.pack_weights(params)
    f1 = MK.k3_forward(pw, rays[0], rays[1], rays[2], rays[5], b, 32, 12,
                       with_reg)
    f2 = MK.k3_forward(pw, rays[0], rays[1], rays[2], rays[5], b, 32, 12,
                       with_reg)
    for x, y in zip(f1[:5], f2[:5]):
        assert torch.equal(x, y)
    rays8, treg, b6, SRk = f1[5]
    gen = torch.Generator(device=cuda).manual_seed(17)
    n = rays8.shape[0]
    cot = (torch.randn(n, generator=gen, device=cuda),
           torch.randn(n, generator=gen, device=cuda),
           torch.randn(n, 3, generator=gen, device=cuda),
           torch.randn(n, 32, generator=gen, device=cuda))
    a = MK.k4_backward(pw, rays8, treg, f1[4], b6, *cot, 32, SRk, True)
    c = MK.k4_backward(pw, rays8, treg, f1[4], b6, *cot, 32, SRk, True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    assert bool(torch.isfinite(a[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["box", "room"])
def test_cuda_superpoint_matches_cpu(cuda, which):
    """The SuperPoint extractor (distilled checkpoint) on the card against
    its float32 run on the CPU (chip_smoke.check_superpoint: heatmap and
    descriptors within 1e-4, >= 98% of keypoints on the same pixel and
    their angles within 1e-4): a 120x160 box frame and the flagship's
    680x1200 frame 0."""
    import os
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.io.datasets import get_dataset
    if which == "room":
        cfg = S.weak_config()
        max_kps = 1000
    else:
        cfg = load_config(os.path.join(S.HERE, "configs/Synthetic/box.yaml"))
        max_kps = 300
    color = get_dataset(cfg)[0][1]
    r = S.check_superpoint(torch, np.asarray(color, np.float32).mean(-1),
                           max_kps=max_kps)
    assert r["keypoints"][0] > 20


def test_tum_fixture_round_trip(tmp_path):
    """The smoke's TUM fixture (chip_smoke.write_tum_fixture: PNGs written
    with cv2) read back by the port's TUM reader: frames equal the render
    to the u8 / u16 quantisation, poses the rebased c2w
    (chip_smoke.check_tum_reader)."""
    fixture, M, bound = S.write_tum_fixture(str(tmp_path / "tum"), n=3)
    err = S.check_tum_reader(str(tmp_path / "tum"), fixture, M, n=3)
    assert err["color"] > 0 and err["depth"] > 0
    assert all(lo < hi for lo, hi in bound)
