"""Port decoder (pointnerf_slam_torch.models) against the JAX reference's
apply_mlp on identical weights (params_from_jax)."""

import jax
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu.models.decoders import MLPConfig as JCfg
from pointnerf_slam_tpu.models.decoders import apply_mlp, init_mlp
from pointnerf_slam_tpu.models.embeddings import apply_fourier
from pointnerf_slam_torch.models.decoders import (IMAPDecoder, MLPConfig,
                                                  get_model, params_from_jax,
                                                  params_to_jax)
from pointnerf_slam_torch.models.embeddings import fourier_project
from tests.torch_threads import share_cores

share_cores()


def jax_params(seed, hidden=256, n_blocks=4):
    cfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=hidden, skips=(),
               n_blocks=n_blocks)
    p = init_mlp(jax.random.PRNGKey(seed), cfg)
    return cfg, jax.tree_util.tree_map(np.asarray, p)


def decoder_from(tree, **kw):
    cfg = MLPConfig(hidden_size=tree["layers"][0]["w"].shape[1],
                    n_blocks=len(tree["layers"]), **kw)
    dec = IMAPDecoder(cfg)
    dec.load_state_dict(params_from_jax(tree))
    return dec


@pytest.mark.parametrize("hidden,n_blocks", [(256, 4), (32, 2)])
def test_decoder_matches_apply_mlp(hidden, n_blocks):
    jcfg, tree = jax_params(0, hidden, n_blocks)
    dec = decoder_from(tree)
    x = np.random.default_rng(0).uniform(-2, 2, (300, 3)).astype(np.float32)
    out_j = np.asarray(apply_mlp(tree, jcfg, x))
    out_t = dec(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(out_t, out_j, atol=2e-4 * np.abs(out_j).max())


def test_decoder_bf16_compute_matches():
    """compute_dtype bfloat16: bf16 operands, f32 accumulation in both.
    Tolerance: a bf16 rounding tie resolved differently after a different
    f32 summation order moves a point by ~0.5% of the output scale."""
    import dataclasses
    jcfg, tree = jax_params(1)
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    dec = decoder_from(tree, compute_dtype="bfloat16")
    x = np.random.default_rng(1).uniform(-2, 2, (400, 3)).astype(np.float32)
    out_j = np.asarray(apply_mlp(tree, jcfg, x))
    out_t = dec(torch.as_tensor(x)).detach().numpy()
    err = np.abs(out_t - out_j)
    scale = np.abs(out_j).max()
    assert err.max() < 1e-2 * scale
    assert np.mean(err > 1e-3 * scale) < 0.05


def test_fourier_projection_bit_identical():
    """x . B in the order XLA's CPU dot uses (an FMA chain): bitwise equal,
    so the bf16 embedding rounds identically in both packages."""
    _, tree = jax_params(2)
    x = np.random.default_rng(2).uniform(-2, 2, (2000, 3)).astype(np.float32)
    xb_j = np.asarray(jax.numpy.dot(x, tree["embedder"]["B"],
                                    precision=jax.lax.Precision.HIGHEST))
    xb_t = fourier_project(torch.as_tensor(x),
                           torch.as_tensor(tree["embedder"]["B"])).numpy()
    assert np.mean(xb_t != xb_j) < 1e-3
    np.testing.assert_allclose(
        np.sin(xb_t), np.asarray(apply_fourier(tree["embedder"], x)),
        atol=1e-5)


def test_params_round_trip_and_names():
    _, tree = jax_params(3)
    sd = params_from_jax(tree)
    assert set(sd) == set(IMAPDecoder(MLPConfig()).state_dict())
    back = params_to_jax(sd)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_get_model_and_init_statistics():
    cfg = {"data": {"dim": 3}, "model": {"pos_embedding_method": "fourier"}}
    mcfg, make = get_model(cfg)
    dec = make(torch.Generator().manual_seed(0))
    assert dec.embedder.B.shape == (3, 93)
    assert abs(float(dec.embedder.B.std()) - 25.0) < 3.0
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (93 + 256))
    assert float(dec.layers[0].w.abs().max()) <= lim
    assert float(dec.layers[0].b.abs().max()) == 0.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(cfg, nice=True)
