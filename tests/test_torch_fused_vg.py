"""The port's fused value-and-grad (pointnerf_slam_torch.ops.fused_vg)
against the JAX reference's Pallas kernels, run in interpret mode on the
CPU as tests/test_fused_vg.py runs them.

On the CPU the port's wrappers take the plain versions (p1_sigma_reference,
fused_vg_reference), so this holds the math the CUDA kernels are checked
against on the card (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances, as chip_smoke.py: loss rtol 1e-3; parameter gradients atol
2e-2 * max|g|; ray gradients cosine > 0.999 and norm ratio in
[0.98, 1.02]; depth and colour within 1e-3 on >= 95% of rays and within
2e-2 on every ray off the last-interval step, and sigma within
2e-2 * max|sigma| (bf16 noise: the packages sum float32 products in
different orders, so a pre-activation near a bf16 tie rounds the other way
at ~1e-5 of values; a ray transparent up to a last sample of density ~0
turns that into a depth step, since alpha over the 1e10 last interval is a
step in sigma: such rays, found by chip_smoke.last_step with that sigma
bound as the noise, are held to the jump of their last weight)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as S
from pointnerf_slam_tpu.models.decoders import MLPConfig as JCfg
from pointnerf_slam_tpu.models.decoders import init_mlp
from pointnerf_slam_tpu.ops import fused_vg as JF
from pointnerf_slam_tpu.ops import megakernel as JM
from pointnerf_slam_tpu.ops.fused_mlp import pad_params
from pointnerf_slam_tpu.render.renderer import RenderConfig as JRC
from pointnerf_slam_torch.models.decoders import (IMAPDecoder, MLPConfig,
                                                  mlp_apply, params_from_jax,
                                                  params_to_jax)
from pointnerf_slam_torch.ops import fused_vg as F
from pointnerf_slam_torch.render.renderer import RenderConfig
from tests.torch_threads import share_cores

share_cores()

JCFG = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
            n_blocks=4)
JRCFG = JRC(N_samples=32, N_surface=0, N_importance=12)
RCFG = RenderConfig(N_samples=32, N_surface=0, N_importance=12)
BOUND = np.array([[-4.0, 4.0]] * 3, np.float32)
MAPPER = dict(w_color=0.05, w_reg=0.0005)
TRACKER = dict(w_color=0.5)


def T(a):
    return torch.as_tensor(np.array(a))


def setup(n=260, seed=3):
    tree = jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.PRNGKey(seed), JCFG))
    dec = IMAPDecoder(MLPConfig())
    dec.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rd = (d * rng.uniform(0.9, 1.3, (n, 1))).astype(np.float32)
    gt_d = rng.uniform(0.5, 2.5, n).astype(np.float32)
    gt_d[::7] = 0.0
    gt_c = rng.uniform(size=(n, 3)).astype(np.float32)
    t_reg = rng.uniform(size=(n, 32)).astype(np.float32)
    ray_w = np.ones(n, np.float32)
    ray_w[1::5] = 1.5
    return tree, dec, (ro, rd, gt_d, gt_c, ray_w, t_reg)


def cmp_outputs(out_t, out_j, dec, rays, z2, param_grads=True,
                ray_grads=True):
    lt, gt_, ot, dt, at = out_t
    lj, gj, oj, dj, aj = out_j
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    if param_grads:
        for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(gt_)),
                        jax.tree_util.tree_leaves(gj)):
            b = np.asarray(b, np.float64)
            np.testing.assert_allclose(np.asarray(a, np.float64), b,
                                       atol=2e-2 * np.abs(b).max() + 1e-8)
    if ray_grads:
        for a, b in ((ot, oj), (dt, dj)):
            a = a.numpy().astype(np.float64).ravel()
            b = np.asarray(b, np.float64).ravel()
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            ratio = np.linalg.norm(a) / np.linalg.norm(b)
            assert cos > 0.999 and 0.98 <= ratio <= 1.02, (cos, ratio)
    params = F.params_of(dec)
    ro, rd, z2, b = T(rays[0]), T(rays[1]), T(z2), T(BOUND)
    x = (ro[:, None] + rd[:, None] * z2[..., None]).reshape(-1, 3)
    with torch.no_grad():
        sig = mlp_apply(params, x, bf16=True)[:, 3]
    noise = S.SIG_MAX * float(sig[F._inside(x, b)].abs().max())
    step, Tl, zl, cl = S.last_step(torch, F, params, ro, rd, z2, b, noise)
    for i, jump in ((0, Tl * zl), (2, Tl * cl)):
        err = np.abs(at[i].numpy() - np.asarray(aj[i]))
        err = err.reshape(err.shape[0], -1).max(1)
        assert np.mean(err > 1e-3) <= 0.05, np.mean(err > 1e-3)
        assert err[~step.numpy()].max() <= S.OUT_MAX
        assert np.all(err[step.numpy()] <= jump[step].numpy() + S.OUT_MAX)


def jax_z2(mode, tree, rays, **kw):
    ro, rd, gt_d = rays[:3]
    prep, _ = JF.make_fused_vg_split(JRCFG, mode, **kw)
    return np.asarray(prep(tree, ro, rd, gt_d, BOUND))


@pytest.mark.parametrize("w_beyond", [0.0, 1.0])
def test_mapper_main_matches_reference(w_beyond):
    tree, dec, rays = setup()
    n = rays[0].shape[0]
    z2 = jax_z2("mapper", tree, rays, **MAPPER, w_beyond=w_beyond)
    _, jmain = JF.make_fused_vg_split(JRCFG, "mapper", **MAPPER,
                                      w_beyond=w_beyond)
    out_j = jmain(tree, *map(jnp.asarray, rays), jnp.asarray(z2),
                  jnp.asarray(BOUND))
    _, main = F.make_fused_vg_split(RCFG, "mapper", **MAPPER,
                                    w_beyond=w_beyond)
    out_t = main(dec, *map(T, rays), T(z2[:n]), T(BOUND))
    cmp_outputs(out_t, out_j, dec, rays, z2[:n])


def test_mapper_no_ray_grads_keeps_param_grads():
    tree, dec, rays = setup()
    n = rays[0].shape[0]
    z2 = jax_z2("mapper", tree, rays, **MAPPER, w_beyond=1.0)
    _, jmain = JF.make_fused_vg_split(JRCFG, "mapper", **MAPPER,
                                      w_beyond=1.0, with_ray_grads=False)
    out_j = jmain(tree, *map(jnp.asarray, rays), jnp.asarray(z2),
                  jnp.asarray(BOUND))
    _, main = F.make_fused_vg_split(RCFG, "mapper", **MAPPER, w_beyond=1.0,
                                    with_ray_grads=False)
    out_t = main(dec, *map(T, rays), T(z2[:n]), T(BOUND))
    cmp_outputs(out_t, out_j, dec, rays, z2[:n], ray_grads=False)
    assert float(out_t[2].abs().max()) == 0.0


def test_tracker_main_matches_reference():
    tree, dec, rays = setup(seed=7)
    n = rays[0].shape[0]
    rays = rays[:4] + (np.ones(n, np.float32), np.zeros((n, 32), np.float32))
    z2 = jax_z2("tracker", tree, rays, **TRACKER)
    _, jmain = JF.make_fused_vg_split(JRCFG, "tracker", **TRACKER,
                                      param_grads=False)
    out_j = jmain(tree, *map(jnp.asarray, rays), jnp.asarray(z2),
                  jnp.asarray(BOUND))
    _, main = F.make_fused_vg_split(RCFG, "tracker", **TRACKER,
                                    param_grads=False)
    out_t = main(dec, *map(T, rays), T(z2[:n]), T(BOUND))
    assert out_t[1] is None
    cmp_outputs(out_t, out_j, dec, rays, z2[:n], param_grads=False)


def test_p1_sigma_matches_reference_kernel():
    tree, dec, rays = setup(seed=9)
    ro, rd, gt_d = rays[:3]
    n = ro.shape[0]
    pk = F._pack_rays(T(ro), T(rd), T(gt_d), T(BOUND))
    pkp = np.pad(pk.numpy(), ((0, (-n) % 128), (0, 0)))
    b8 = np.zeros((1, 8), np.float32)
    b8[0, :6] = BOUND.reshape(-1)
    kp = pad_params(jax.tree_util.tree_map(jnp.asarray, tree))
    from jax.experimental import pallas as pl
    sig_j = np.asarray(pl.pallas_call(
        JF._make_p1_kernel(32), grid=(pkp.shape[0] // 128,),
        in_specs=[JF._vrow(8), JM._bound_spec()]
        + [JM._full_spec(kp[k].shape) for k in JF._KP_ORDER],
        out_specs=JF._vrow(32),
        out_shape=jax.ShapeDtypeStruct((pkp.shape[0], 32), jnp.float32),
        interpret=True)(jnp.asarray(pkp), jnp.asarray(b8),
                        *[kp[k] for k in JF._KP_ORDER]))[:n]
    sig_t = F.p1_sigma(F.pack_weights(F.params_of(dec)), pk, T(BOUND),
                       32).numpy()
    err = np.abs(sig_t - sig_j)
    assert (sig_t == 100.0).sum() == (sig_j == 100.0).sum()
    assert err.max() <= 2e-2 * np.abs(sig_j[sig_j != 100.0]).max()
    assert np.mean(err > 1e-3 * (1 + np.abs(sig_j))) <= 0.05


def test_unsplit_vg_and_prepare_track_reference():
    """prepare's z2 (pass-1 sigma -> inverse CDF -> sort) follows the
    reference's; the unsplit loss agrees to rtol 1e-3. (z2 inherits the
    bf16 noise of pass 1 through a steep inverse CDF, so it is bounded by
    share: median ray within 1e-3, >= 90% within 5e-3, all within 0.1.)"""
    tree, dec, rays = setup(seed=11)
    n = rays[0].shape[0]
    z2_j = jax_z2("mapper", tree, rays, **MAPPER, w_beyond=1.0)[:n]
    prep, _ = F.make_fused_vg_split(RCFG, "mapper", **MAPPER, w_beyond=1.0)
    z2_t = prep(dec, *map(T, rays[:3]), T(BOUND)).numpy()
    assert np.all(np.diff(z2_t, axis=1) >= 0)
    err = np.abs(z2_t - z2_j).max(1)
    assert np.median(err) <= 1e-3 and np.mean(err > 5e-3) <= 0.1
    assert err.max() <= 0.1
    vg_j = JF.make_fused_vg(JRCFG, "mapper", **MAPPER, w_beyond=1.0)
    vg_t = F.make_fused_vg(RCFG, "mapper", **MAPPER, w_beyond=1.0)
    l_j = float(vg_j(tree, *map(jnp.asarray, rays), jnp.asarray(BOUND))[0])
    l_t = float(vg_t(dec, *map(T, rays), T(BOUND))[0])
    np.testing.assert_allclose(l_t, l_j, rtol=1e-3)


def test_split_composition_equals_vg():
    _, dec, rays = setup(n=90, seed=13)
    vg = F.make_fused_vg(RCFG, "mapper", **MAPPER, w_beyond=1.0)
    prep, main = F.make_fused_vg_split(RCFG, "mapper", **MAPPER,
                                       w_beyond=1.0)
    a = vg(dec, *map(T, rays), T(BOUND))
    z2 = prep(dec, *map(T, rays[:3]), T(BOUND))
    b = main(dec, *map(T, rays), z2, T(BOUND))
    assert float(a[0]) == float(b[0])
    for k in a[1]:
        torch.testing.assert_close(a[1][k], b[1][k], rtol=0, atol=0)
    torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)


def test_autograd_function_hands_out_the_same_gradients():
    """fused_vg_loss: loss.backward() fills the decoder's .grad and the
    rays' upstream graph with main's gradients (times the incoming
    gradient)."""
    _, dec, rays = setup(n=70, seed=15)
    prep, main = F.make_fused_vg_split(RCFG, "mapper", **MAPPER)
    ro = T(rays[0]).requires_grad_(True)
    rd = T(rays[1]).requires_grad_(True)
    z2 = prep(dec, ro.detach(), rd.detach(), T(rays[2]), T(BOUND))
    ref = main(dec, ro.detach(), rd.detach(), *map(T, rays[2:]), z2,
               T(BOUND))
    loss, dep, _, _ = F.fused_vg_loss(main, dec, ro, rd, *map(T, rays[2:]),
                                      z2, T(BOUND))
    (2.0 * loss).backward()
    assert float(loss) == float(ref[0])
    torch.testing.assert_close(dep, ref[4][0])
    for k, p in F.params_of(dec).items():
        torch.testing.assert_close(p.grad, 2.0 * ref[1][k])
    torch.testing.assert_close(ro.grad, 2.0 * ref[2])
    torch.testing.assert_close(rd.grad, 2.0 * ref[3])


def test_wrappers_route_by_device_only():
    _, dec, rays = setup(n=20, seed=17)
    pw = F.pack_weights(F.params_of(dec))
    pk = F._pack_rays(*map(T, rays[:3]), T(BOUND))
    torch.testing.assert_close(F.p1_sigma(pw, pk, T(BOUND), 32),
                               F.p1_sigma_reference(pw, pk, T(BOUND), 32))
    with pytest.raises(ValueError):
        F.p1_sigma(pw, pk.to("meta"), T(BOUND), 32)


@pytest.mark.parametrize("mode,kw", [
    ("mapper", dict(MAPPER, w_beyond=1.0, with_ray_grads=False)),
    ("tracker", dict(TRACKER, param_grads=False))])
def test_vg_check_bounds_the_kink_rays(mode, kw):
    """chip_smoke.check_vg judges gradients off the rays whose L1 depth
    residual has opposite signs in the two versions (kinks), and fails
    when they are more than OUT_SHARE of the rays: a kernel depth 2e-5 off
    the plain one across gt on one ray passes, on 6 of 60 rays fails."""
    _, dec, rays = setup(n=60)
    ro, rd, gt_d, gt_c, ray_w, t_reg = map(T, rays)
    b = T(BOUND)
    prep, main = F.make_fused_vg_split(RCFG, mode, **kw)
    z2 = prep(dec, ro, rd, gt_d, b)
    params = F.params_of(dec)
    depth = F.fused_vg_reference(main.spec, params, ro, rd, gt_d, gt_c,
                                 ray_w, t_reg, z2, b)[4][0]
    for m in (1, 6):
        flip = slice(1, m + 1)               # rays 1..6 all have gt_d > 0
        g2 = gt_d.clone()
        g2[flip] = depth[flip] + 1e-5
        args = (ro, rd, g2, gt_c, ray_w, t_reg, z2, b)
        out_p = F.fused_vg_reference(main.spec, params, *args)
        dk = out_p[4][0].clone()
        dk[flip] += 2e-5
        out_k = out_p[:4] + ((dk,) + tuple(out_p[4][1:]),)
        if m / 60 <= S.OUT_SHARE:
            S.check_vg(f"{mode} m={m}", out_k, out_p, main.spec, args,
                       params, 1e-3)
        else:
            with pytest.raises(SystemExit, match="at a kink"):
                S.check_vg(f"{mode} m={m}", out_k, out_p, main.spec, args,
                           params, 1e-3)
