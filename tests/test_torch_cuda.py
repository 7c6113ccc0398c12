"""The port's CUDA kernels against their plain PyTorch versions, on the
card (`cuda` marker; skipped without one):

  python -m pytest tests/test_torch_cuda.py -q

Each check runs on two decoders: a random one, and the same one after a
short mapping run on the kernels, where the tracker's depth weights
1/sqrt(var) are no longer set by rays with var ~ 0. The comparisons and
tolerances are chip_smoke.py's (`check_p1`, `check_vg`): loss rtol 1e-3;
parameter gradients atol 2e-2 * max|g|; ray gradients cosine > 0.999 and
norm ratio in [0.98, 1.02] on the rays off the loss kinks (for the
tracker also on those with var >= 1e-4); depth and colour within 1e-3 on
>= 95% of rays and within 2e-2 on every ray off the last-interval step;
sigma within 2e-2 * max|sigma| and within 1e-3 * (1 + |sigma|) on
>= 95%. K5/K6 (`check_mlp`): the decoder's output within 1e-3 (1 + |raw|)
on >= 98% of values and 2e-2 max|raw| on all; dx and every parameter
gradient by cosine >= 0.9999 and norm ratio within 1e-3."""

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
    """K5/K6 at the tile edges (64-point tiles; K6 pads to 1024 points)."""
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
