"""K5/K6's plain versions (pointnerf_slam_torch/ops/fused_mlp.py) against
the JAX reference's fused_imap_mlp, run as tests/test_fused_mlp.py runs it
(the Pallas kernels in interpret mode on the CPU), and the port's decoder
on its fused path.

Bounds: the forward within 1e-3 * (1 + |raw|) on >= 98% of values and
within 2e-2 * max|raw| on every value (bf16 tie noise: the two packages
sum float32 products in different orders, and a pre-activation within
that difference of a bf16 rounding tie rounds the other way); the
gradients of x and of every parameter by cosine > 0.9999 and norm ratio
within 1e-3, at width 256 on 700 points and at the tile edges N = 1, 63,
64, 65 and 1025 (64-point tiles in the CUDA kernels, 1024 in the TPU
ones)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.models import MLPConfig as JCfg
from pointnerf_slam_tpu.models import init_mlp
from pointnerf_slam_tpu.ops.fused_mlp import fused_imap_mlp as j_fused
from pointnerf_slam_tpu.ops.fused_mlp import supports_fused as j_supports
from pointnerf_slam_torch.models.decoders import (IMAPDecoder, MLPConfig,
                                                  mlp_apply, params_from_jax)
from pointnerf_slam_torch.ops.fused_mlp import (fused_imap_mlp,
                                                fused_mlp_reference,
                                                mlp_backward_reference,
                                                supports_fused)
from pointnerf_slam_torch.ops.fused_vg import PARAM_NAMES
from tests.torch_threads import share_cores

share_cores()

JCFG = JCfg(dim=3, c_dim=0, color=True, hidden_size=256, skips=(),
            n_blocks=4)


def reference_tree(seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(seed), JCFG))


def cos_ratio(a, b):
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return (a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30),
            np.linalg.norm(a) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("n", [700, 1, 63, 64, 65, 1025])
def test_plain_versions_match_the_reference_kernels(n):
    tree = reference_tree()
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    g = rng.normal(size=(n, 4)).astype(np.float32)
    out_j, vjp = jax.vjp(j_fused, tree, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(g))
    gp_j = params_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))

    p = {k: v.requires_grad_(True) for k, v in params_from_jax(tree).items()}
    xt = torch.tensor(x, requires_grad=True)
    out_t = fused_mlp_reference(p, xt)
    out_t.backward(torch.tensor(g))

    ref, got = np.asarray(out_j), out_t.detach().numpy()
    err = np.abs(got - ref)
    share = float((err > 1e-3 * (1 + np.abs(ref))).mean())
    assert share <= 0.02, share
    assert err.max() <= 2e-2 * np.abs(ref).max(), err.max()
    for name, a, b in [("x", xt.grad, gx_j)] + [
            (k, p[k].grad, gp_j[k]) for k in PARAM_NAMES]:
        cos, ratio = cos_ratio(a.numpy(), b)
        assert cos > 0.9999 and abs(ratio - 1) <= 1e-3, (name, cos, ratio)


def test_fused_decoder_on_the_cpu_is_the_plain_version_bit_for_bit():
    """IMAPDecoder with MLPConfig(fused=True) takes fused_imap_mlp, which
    for CPU tensors is fused_mlp_reference: outputs and gradients equal."""
    dec = IMAPDecoder(MLPConfig(fused=True), torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(257, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(257, 4)).astype(np.float32))
    xa = x.clone().requires_grad_(True)
    dec(xa).backward(g)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in dec.named_parameters()}
    xb = x.clone().requires_grad_(True)
    out = fused_mlp_reference(p, xb)
    out.backward(g)
    assert torch.equal(dec(x).detach(), out.detach())
    assert torch.equal(xa.grad, xb.grad)
    named = dict(dec.named_parameters())
    for k in PARAM_NAMES:
        assert torch.equal(named[k].grad, p[k].grad), k
    # fused=False is plain torch (mlp_apply), the reference's own numerics
    plain = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(3))
    assert torch.equal(plain(x), mlp_apply(dict(plain.named_parameters()),
                                            x))


def test_backward_skips_what_no_input_needs():
    """Camera-only callers (the tracker) get dx alone, the mapper without
    bundle adjustment the parameter gradients alone; each equals the full
    backward's."""
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(4))
    p = {k: v.detach() for k, v in dec.named_parameters()}
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(100, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(100, 4)).astype(np.float32))
    dx, dps = mlp_backward_reference(p, x, g)
    dx_only, none = mlp_backward_reference(p, x, g, param_grads=False)
    nothing, dps_only = mlp_backward_reference(p, x, g, x_grad=False)
    assert none is None and nothing is None
    assert torch.equal(dx, dx_only)
    for k in PARAM_NAMES:
        assert torch.equal(dps[k], dps_only[k])
    xa = x.clone().requires_grad_(True)
    fused_imap_mlp(p, xa).backward(g)          # no parameter needs one
    assert torch.equal(xa.grad, dx)


def test_supports_fused_is_the_reference_rule():
    for over in ({}, {"hidden_size": 128}, {"n_blocks": 3},
                 {"skips": (2,)}):
        want = j_supports(dataclasses.replace(JCFG, **over))
        assert supports_fused(dataclasses.replace(MLPConfig(), **over)) \
            == want
    assert supports_fused(MLPConfig())


def test_wrapper_takes_cpu_or_cuda_tensors_only():
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(0))
    p = {k: v.detach().to("meta") for k, v in dec.named_parameters()}
    with pytest.raises(ValueError):
        fused_imap_mlp(p, torch.zeros(4, 3, device="meta"))
