"""The JAX reference's random draws, rebuilt from its PRNG keys as the
tensors the port's `Draws(replay=...)` hands out, in the order the port
consumes them.

The reference splits one key per call into the draws of that call; each
helper repeats those splits:
  - `hypotheses`: a RANSAC solve's (n_hyp, 8) match indices
    (frontend/epipolar.py estimate_relative_pose_ransac);
  - `pixel_draws`: the tracker's pixel batches, one per resample round
    (engine/tracker.py round_body) or per iteration (body / loss_fn): the
    first half of each batch key's split, uniform over the edge-cropped
    image or, in weak mode, among the valid (pseudo-depth > 0.01) pixels;
  - `mapper_draws`: the mapper's (frames, pixels per frame) batches and
    its regulation uniforms, per round (mapper.py vg_round) or per
    iteration (body), for one mapper_step or per outer of
    mapper_multi_step.
Used by the parity tests (tests/test_torch_engine.py,
tests/test_torch_frontend.py, tests/test_torch_step_replay.py) and by
scripts/step_replay.py, which imports JAX and the JAX package through
this module on purpose (the port never does).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointnerf_slam_tpu.core.rays import sample_uv_uniform, sample_uv_valid


def T(a):
    return torch.as_tensor(np.array(a))


def hypotheses(key, match_valid, n_hyp=256):
    """The reference's hypothesis indices (epipolar.py:182-188)."""
    logits = jnp.where(match_valid, 0.0, -jnp.inf)
    logits = jnp.where(jnp.any(match_valid), logits, jnp.zeros_like(logits))
    keys = jax.random.split(key, n_hyp)
    return T(jax.vmap(lambda k: jax.random.categorical(
        k, logits, shape=(8,)))(keys)).long()


def _pixels(k, n, W, H, edges, valid):
    if valid is not None:
        return sample_uv_valid(k, jnp.asarray(valid), n)[0]
    He, We = edges
    return sample_uv_uniform(k, W, He, H - He, We, W - We, n)


def pixel_draws(key, n_batches, n, W, H, edges=(0, 0), valid=None):
    """The tracker's pixel indices: per batch key of split(key,
    n_batches), n pixels from the first half of its split; valid (H, W)
    bool draws among those pixels (weak mode), else uniformly inside
    edges (ignore_edge_H, ignore_edge_W)."""
    out = []
    for k in jax.random.split(key, n_batches):
        k_s, _ = jax.random.split(k)
        out.append(T(_pixels(k_s, n, W, H, edges, valid)).long())
    return out


def mapper_draws(key, max_frames, ppf, n_samples, W, H, iters, resample_k,
                 outers=None, depths=None):
    """The mapper's draws in the port's order: per batch, the pixel
    indices (max_frames, ppf), then its regulation uniforms (ppf *
    max_frames, n_samples): resample_k > 1 (the fused rounds, iters a
    multiple of it) gives one batch and resample_k uniforms per round,
    otherwise one batch and one uniform per iteration. outers=None is one
    mapper_step call; outers=O splits key O ways first, as
    mapper_multi_step does. depths (max_frames, H, W), or (O, max_frames,
    H, W) with outers: weak mode's window supervision, whose > 0.01
    pixels each frame draws among."""
    rounds = resample_k > 1 and iters % resample_k == 0
    out = []
    keys = [key] if outers is None else jax.random.split(key, outers)
    for o, k_o in enumerate(keys):
        dep = None if depths is None else np.asarray(
            depths if outers is None else depths[o])
        for k in jax.random.split(k_o, iters // resample_k if rounds
                                  else iters):
            ks = jax.random.split(k, max_frames + 1)
            out.append(torch.stack([
                T(_pixels(ks[f], ppf, W, H, (0, 0),
                          None if dep is None else dep[f] > 0.01)).long()
                for f in range(max_frames)]))
            n = (ppf * max_frames, n_samples)
            if rounds:
                for kk in jax.random.split(ks[-1], resample_k):
                    out.append(T(jax.random.uniform(kk, n)))
            else:
                _, k_reg = jax.random.split(ks[-1])
                out.append(T(jax.random.uniform(k_reg, n)))
    return out
