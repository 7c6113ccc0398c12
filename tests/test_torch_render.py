"""Port renderer (pointnerf_slam_torch.render) against the JAX reference
renderer on identical weights and rays, float32 decoder products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.models.decoders import MLPConfig as JCfg
from pointnerf_slam_tpu.models.decoders import init_mlp
from pointnerf_slam_tpu.render import renderer as JR
from pointnerf_slam_torch.models.decoders import (IMAPDecoder, MLPConfig,
                                                  params_from_jax)
from pointnerf_slam_torch.render import renderer as TR
from tests.torch_threads import share_cores

share_cores()

JCFG = JCfg(dim=3, c_dim=0, color=True, hidden_size=32, skips=(), n_blocks=2)
BOUND = np.array([[-2.0, 2.0], [-2.0, 2.0], [-2.0, 2.0]], np.float32)


def setup(seed, n=64):
    tree = jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.PRNGKey(seed), JCFG))
    dec = IMAPDecoder(MLPConfig(hidden_size=32, n_blocks=2))
    dec.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    gt = rng.uniform(0.5, 2.0, n).astype(np.float32)
    gt[::9] = 0.0
    return tree, dec, ro, rd, gt


def T(a):
    return torch.as_tensor(np.array(a))


def test_eval_points_sentinel():
    tree, dec, *_ = setup(0)
    pts = np.random.default_rng(0).uniform(-3, 3, (200, 3)).astype(
        np.float32)
    a = TR.eval_points(dec, T(pts), T(BOUND)).detach().numpy()
    b = np.asarray(JR.eval_points(tree, JCFG, pts, BOUND))
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert (a[:, 3] == 100.0).any()


@pytest.mark.parametrize("seed", [1, 2])
def test_render_rays_matches(seed):
    tree, dec, ro, rd, gt = setup(seed)
    rcfg_j = JR.RenderConfig(N_samples=16, N_surface=0, N_importance=8)
    rcfg_t = TR.RenderConfig(N_samples=16, N_surface=0, N_importance=8)
    out_j = JR.render_rays(tree, JCFG, rcfg_j, ro, rd, BOUND,
                           jax.random.PRNGKey(0), gt, with_zvals=True)
    out_t = TR.render_rays(dec, rcfg_t, T(ro), T(rd), T(BOUND), T(gt),
                           with_zvals=True)
    # the importance z come from an inverse CDF whose cumsum each package
    # sums in its own order; where the CDF is steep that moves a sample by
    # a few mm, so rays match to 2e-4 on >= 90% and to 1e-2 everywhere
    # (the density AT a moved sample is bounded by the share only: the
    # scale-25 Fourier field varies by ~0.1 over a few mm)
    for name, a, b in zip(("depth", "var", "color", "weights", "z", "sig"),
                          out_t, out_j):
        err = np.abs(a.detach().numpy() - np.asarray(b))
        err = err.reshape(err.shape[0], -1).max(1)
        assert name == "sig" or err.max() < 1e-2, (name, err.max())
        assert np.mean(err > 2e-4) <= 0.1, (name, np.mean(err > 2e-4))


def test_render_rays_gradient_matches():
    tree, dec, ro, rd, gt = setup(3)
    rj = JR.RenderConfig(N_samples=16, N_surface=0, N_importance=8)
    rt = TR.RenderConfig(N_samples=16, N_surface=0, N_importance=8)

    def loss_j(o, d):
        dep, _, col, _ = JR.render_rays(tree, JCFG, rj, o, d, BOUND,
                                        jax.random.PRNGKey(0), gt)
        return jnp.sum(jnp.abs(gt - dep)) + jnp.sum(col)

    gj = jax.grad(loss_j, argnums=(0, 1))(ro, rd)
    o = T(ro).clone().requires_grad_(True)
    d = T(rd).clone().requires_grad_(True)
    dep, _, col, _ = TR.render_rays(dec, rt, o, d, T(BOUND), T(gt))
    (torch.sum(torch.abs(T(gt) - dep)) + col.sum()).backward()
    for a, b in ((o.grad, gj[0]), (d.grad, gj[1])):
        a, b = a.numpy().ravel(), np.asarray(b).ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


def test_regulation_matches_with_replayed_uniforms():
    tree, dec, ro, rd, gt = setup(4)
    rj = JR.RenderConfig(N_samples=16, N_surface=0, N_importance=8)
    rt = TR.RenderConfig(N_samples=16, N_surface=0, N_importance=8)
    key = jax.random.PRNGKey(5)
    sig_j = np.asarray(JR.regulation(tree, JCFG, rj, ro, rd, gt, BOUND, key))
    # stratified_zvals(perturb=1) draws uniform(key, z.shape)
    u = np.asarray(jax.random.uniform(key, (ro.shape[0], 16)))
    sig_t = TR.regulation(dec, rt, T(ro), T(rd), T(gt), T(BOUND), T(u))
    np.testing.assert_allclose(sig_t.detach().numpy(), sig_j, atol=1e-4)


def test_unsupported_sampling_raises():
    """Every sampling option renders now; perturbed sampling without the
    caller's uniforms (the port draws nothing itself) is refused."""
    _, dec, ro, rd, gt = setup(5)
    TR.render_rays(dec, TR.RenderConfig(N_surface=4), T(ro), T(rd),
                   T(BOUND), T(gt))
    with pytest.raises(ValueError, match="uniforms"):
        TR.render_rays(dec, TR.RenderConfig(perturb=1.0), T(ro), T(rd),
                       T(BOUND), T(gt))
