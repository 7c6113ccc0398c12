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
64, 65 and 1025 (1024-point tiles in the TPU kernels). Also the kernel
sources (no WMMA left, the decoder pair on the Hopper tile) and the
wrappers' marshalling on a stub library."""

import dataclasses
import os
import re

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


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pointnerf_slam_torch", "ops", "csrc")


def _includes(name):
    with open(os.path.join(CSRC, name)) as f:
        return re.findall(r'^#include\s+[<"]([^>"]+)[>"]', f.read(), re.M)


@pytest.mark.parametrize("name", sorted(os.listdir(CSRC)))
def test_kernel_sources_hold_no_wmma(name):
    """Every kernel runs on the Hopper tile (wgmma): no source includes
    <mma.h> or names nvcuda::wmma (the WMMA tile is retired)."""
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()
    assert "mma.h" not in _includes(name)
    assert not re.search(r"\bnvcuda\b|\bwmma::", src)


def test_decoder_pair_on_the_hopper_tile_and_k2_forward_only():
    """fused_mlp.cu (K5/K6) includes the Hopper launch sequence and
    through it the forward and backward tiles; p1_sigma.cu (K2) includes
    the forward tile alone, so its library holds no backward kernel."""
    assert _includes("fused_mlp.cu") == ["hopper_vg.cuh"]
    assert set(_includes("hopper_vg.cuh")) == {"hopper_bwd.cuh",
                                               "ray_shared.cuh"}
    assert "hopper_mlp.cuh" in _includes("hopper_bwd.cuh")
    assert _includes("p1_sigma.cu") == ["hopper_mlp.cuh"]
    with open(os.path.join(CSRC, "hopper_mlp.cuh")) as f:
        fwd = f.read()
    for kernel in ("chain_kernel", "wgrad_kernel", "carve"):
        assert kernel not in fwd, kernel


class _StubFn:
    """A C entry of a stub library: records its arguments, returns `ret`."""

    def __init__(self, ret):
        self.ret, self.calls = ret, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


@pytest.mark.parametrize("pg,xg", [(True, True), (True, False),
                                   (False, True)])
def test_launches_pass_the_images_and_size_the_workspace(monkeypatch, pg,
                                                         xg):
    """k5_launch / k6_launch (the wrappers' marshalling, also the kernel
    comparison script's) on a stub library: K5 gets the forward weight
    image and a null chain image, K6 both; K6 sizes its workspace by the
    library's answer for (N, weight gradients) and passes N and its two
    flags; the outputs have the shapes the kernels write."""
    import ctypes

    from pointnerf_slam_torch.ops import fused_mlp as M
    from pointnerf_slam_torch.ops.fused_vg import GRAD_LEN, pack_weights
    monkeypatch.setattr(M, "_check", lambda *a: None)
    monkeypatch.setattr(M, "_stream", lambda t: ctypes.c_void_p(0))
    lib = type("Lib", (), {})()
    lib.mlp_fwd, lib.mlp_bwd = _StubFn(0), _StubFn(0)
    lib.mlp_bwd_workspace_bytes = _StubFn(4096)
    p = {k: v.detach() for k, v in IMAPDecoder(
        MLPConfig(), torch.Generator().manual_seed(6)).named_parameters()}
    n = 77
    x, g = torch.zeros(n, 3), torch.zeros(n, 4)
    launch, out = M.k5_launch(lib, pack_weights(p), x)
    assert launch() is out and out.shape == (n, 4)
    wp = lib.mlp_fwd.calls[-1][0]
    assert len(wp) == 13 and wp[11] is not None and wp[12] is None
    assert lib.mlp_fwd.calls[-1][3].value == n
    launch, (dx, grads) = M.k6_launch(lib, pack_weights(p), x, g, pg, xg)
    launch()
    args = lib.mlp_bwd.calls[-1]
    assert args[0][11] is not None and args[0][12] is not None
    assert [a.value for a in lib.mlp_bwd_workspace_bytes.calls[-1]] \
        == [n, int(pg)]
    assert launch.keep[-1].numel() == 4096
    assert [a.value for a in args[6:9]] == [n, int(pg), int(xg)]
    assert dx.shape == ((n, 3) if xg else (1,))
    assert grads.numel() == (GRAD_LEN if pg else 1)
