"""The port's parallel/ and the engine's data-parallel mapper against the
JAX reference (tests/test_parallel.py's semantics).

The reference shards rays over a device mesh (here make_mesh(2) of
conftest's 8 virtual CPU devices) and psums the gradients; the port runs
one process per device in a gloo group (tests/torch_ranks.py: fresh
interpreters, a file:// store in tmp_path) and all-reduces them. The
ranks replay the reference's per-device draws: fold_in(k, d) of each
iteration key before the splits that scripts/replay_draws.py's
mapper_draws reproduces per iteration.

Bounds: (a) the sharded step's loss rtol 1e-3, parameters after one Adam
step within 2e-2 of the update's scale (ROADMAP's kernel tolerances; with
importance samples the field change of (b), see the test);
(b) the engine step's per-iteration losses (and make_shardmap_mapper_step's
last loss) rtol 2e-2 and the change of the learned field cosine > 0.98,
norm ratio in [0.9, 1.1] (the single-device mapper's bounds in
test_torch_engine.py); (c) the ranks' summed gradients
against one process on the union of their pixels within 1e-5 x max|g|
per tensor (only the float32 summation order differs); (d) the reference
TestEngineMultiDevice's three bounds on the field's depth L1, from the
reference's initial decoder at its seed; (e)
multi-scene losses rtol 2e-2; decoders equal bit for bit across ranks
wherever a group ran."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pointnerf_slam_tpu.core.rays import sample_uv_uniform
from pointnerf_slam_tpu.engine.mapper import make_mapper_step as j_mapper
from pointnerf_slam_tpu.engine.state import EngineConfig as JEC
from pointnerf_slam_tpu.models.decoders import MLPConfig as JCfg
from pointnerf_slam_tpu.models.decoders import init_mlp
from pointnerf_slam_tpu.parallel import make_mesh as j_mesh
from pointnerf_slam_tpu.parallel import make_sharded_mapping_step as j_sharded
from pointnerf_slam_tpu.parallel import (
    make_shardmap_mapper_step as j_shardmap)
from pointnerf_slam_tpu.parallel.multiscene import (
    make_multiscene_mapper_step as j_multiscene, stack_scenes as j_stack)
from pointnerf_slam_tpu.render.renderer import RenderConfig as JRC
from pointnerf_slam_torch.engine.mapper import make_mapper_step
from pointnerf_slam_torch.engine.state import Draws, EngineConfig
from pointnerf_slam_torch.models.decoders import (IMAPDecoder, MLPConfig,
                                                  params_from_jax)
from pointnerf_slam_torch.parallel import (DataGroup, data_devices,
                                           make_mesh,
                                           make_multiscene_mapper_step,
                                           resolve_data_devices,
                                           stack_scenes)
from pointnerf_slam_torch.render.renderer import RenderConfig
from tests.test_torch_engine import field_change
from tests.torch_ranks import REPO, run_ranks
from tests.torch_threads import share_cores

share_cores()

H, W, F = 16, 24, 2
BOUND = np.array([[-4.0, 4.0]] * 3, np.float32)
SMALL = dict(hidden=32, n_blocks=2)
SMALL_RC = dict(N_samples=8, N_surface=0, N_importance=4)


def T(a):
    return torch.as_tensor(np.array(a))


def tree_and_params(seed, hidden=256, n_blocks=4):
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=hidden, skips=(),
                n_blocks=n_blocks)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(seed), jcfg))
    params = {f"p.{k}": v.numpy()
              for k, v in params_from_jax(tree).items()}
    return jcfg, tree, params


def decoder_of(out, hidden=256, n_blocks=4):
    dec = IMAPDecoder(MLPConfig(hidden_size=hidden, n_blocks=n_blocks))
    dec.load_state_dict({k[2:]: T(v) for k, v in out.items()
                         if k.startswith("p.")})
    return dec


def assert_ranks_equal(outs, prefix="p."):
    for k in outs[0]:
        if k.startswith(prefix):
            for o in outs[1:]:
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def per_iter_draws(key, ppf, iters, fold=None, n_samples=32, max_frames=F):
    """The reference mapper's per-iteration draws (mapper.py body ->
    loss_fn / vg_loss) on device `fold` of a mesh: per iteration key k,
    fold_in(k, fold), then pixels from split(k, F + 1)[:F] and t_reg from
    the second half of the last key."""
    out = []
    for k in jax.random.split(key, iters):
        if fold is not None:
            k = jax.random.fold_in(k, fold)
        ks = jax.random.split(k, max_frames + 1)
        out.append(np.stack([np.asarray(sample_uv_uniform(
            ks[f], W, 0, H, 0, W, ppf)).astype(np.int64)
            for f in range(max_frames)]))
        _, k_reg = jax.random.split(ks[-1])
        out.append(np.asarray(jax.random.uniform(
            k_reg, (ppf * max_frames, n_samples))))
    return out


def window(seed, max_frames=F):
    rng = np.random.default_rng(seed)
    return dict(
        colors=(rng.uniform(size=(max_frames, H, W, 3)) * 255).astype(
            np.uint8),
        depths=rng.uniform(0.5, 3.0, (max_frames, H, W)).astype(np.float32),
        cams=np.array([[1.0, 0, 0, 0, 0, 0, 2.5],
                       [1.0, 0.01, 0, 0, 0.02, 0, 2.5]], np.float32),
        valid=np.ones(max_frames, bool), ba=np.zeros(max_frames, bool),
        bound=BOUND)


def ecfg_kw(**over):
    kw = dict(H=H, W=W, fx=12.0, fy=12.0, cx=11.5, cy=7.5,
              mapping_pixels=384, weak_depth=False, depth_supervision=True,
              w_beyond_loss=1.0, no_ba_fast=True)
    kw.update(over)
    return kw


# -- (a) ---------------------------------------------------------------

@pytest.mark.parametrize("n_importance", [0, 4])
def test_sharded_mapping_step_matches_reference(tmp_path, n_importance):
    """make_sharded_mapping_step on two gloo ranks against the
    reference's pjit step on make_mesh(2), same rays and regulation
    draws (the reference's uniform(k_reg) over all rays, each rank taking
    its block as P("data") places them; the far clip's max depth over all
    ranks, as the reference renders the whole batch). Loss rtol 1e-3.
    With 8 stratified samples alone the parameters after the Adam step
    are within 2e-2 of the update's scale. With the reference test's 8 +
    4 the importance sampler's u = 1 bin (ROADMAP Queue 3, "Importance
    z") moves the last sample of some rays in either package, which
    flips the sign of Adam's first step on weights whose gradient it
    reaches; there the change of the field along the rays is held as the
    engine tests hold it (cosine > 0.98, norm ratio in [0.9, 1.1])."""
    rc = dict(SMALL_RC, N_importance=n_importance)
    jcfg, tree, params = tree_and_params(0, hidden=32, n_blocks=2)
    rng = np.random.default_rng(1)
    n = 64
    ro = np.zeros((n, 3), np.float32)
    rd = np.concatenate([rng.normal(size=(n, 2)) * 0.3, -np.ones((n, 1))],
                        -1).astype(np.float32)
    gt_d = rng.uniform(1.0, 2.0, n).astype(np.float32)
    gt_c = rng.uniform(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    step, init_opt, shard = j_sharded(jcfg, JRC(**rc), j_mesh(2))
    p0 = jax.tree_util.tree_map(jnp.array, tree)
    p_j, _, loss_j = step(p0, init_opt(p0), shard(ro), shard(rd),
                          shard(gt_d), shard(gt_c), jnp.asarray(BOUND), key)
    _, k_reg = jax.random.split(key)
    t_reg = np.asarray(jax.random.uniform(k_reg, (n, rc["N_samples"])))
    outs = run_ranks(tmp_path, "sharded", 2,
                     dict(params, ro=ro, rd=rd, gt_d=gt_d, gt_c=gt_c,
                          bound=BOUND, t_reg=t_reg),
                     dict(SMALL, rcfg=rc))
    assert_ranks_equal(outs)
    for o in outs:
        np.testing.assert_allclose(float(o["loss"]), float(loss_j),
                                   rtol=1e-3)
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
    if n_importance == 0:
        for k, v in got.items():
            upd = np.abs(v.numpy() - params[f"p.{k}"]).max()
            err = np.abs(outs[0][f"p.{k}"] - v.numpy()).max()
            assert upd > 0, k
            assert err <= 2e-2 * upd, (k, err, upd)
    else:
        z = np.linspace(0.5, 2.5, 16, dtype=np.float32)
        pts = (ro[:, None] + rd[:, None] * z[:, None]).reshape(-1, 3)
        cos, ratio = field_change(tree, p_j, decoder_of(outs[0], 32, 2),
                                  jcfg, pts)
        assert cos > 0.98 and 0.9 <= ratio <= 1.1, (cos, ratio)


# -- (b) ---------------------------------------------------------------

@pytest.mark.parametrize("megakernel", ["on", "off"])
def test_engine_mapper_under_group_matches_reference_mesh(tmp_path,
                                                          megakernel):
    """The engine's make_mapper_step(group=...) on two ranks against the
    reference's make_mapper_step(mesh=make_mesh(2)), 2 iterations on the
    256-wide decoder: the fused value-and-grad branch ("on": the
    reference's Pallas kernels in interpret mode, the port's plain
    versions) and the plain branch ("off")."""
    jcfg, tree, params = tree_and_params(5)
    win = window(5)
    iters = 2
    key = jax.random.PRNGKey(8)
    kw = ecfg_kw(megakernel=megakernel)
    p_j, _, _, ml_j = j_mapper(jcfg, JRC(), JEC(**kw), F, mesh=j_mesh(2))(
        tree, {}, win["colors"], win["depths"], win["cams"], win["valid"],
        win["ba"], win["bound"], key, iters)
    ppf = kw["mapping_pixels"] // F // 2
    per_rank = [{f"draw_{i}": a for i, a in enumerate(
        per_iter_draws(key, ppf, iters, fold=d))} for d in range(2)]
    outs = run_ranks(tmp_path, "mapper", 2, dict(params, **win),
                     dict(hidden=256, n_blocks=4, rcfg={}, ecfg=kw,
                          max_frames=F, iters=iters), per_rank)
    assert_ranks_equal(outs)
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], np.asarray(ml_j),
                               rtol=2e-2)
    cos, ratio = field_change(tree, p_j, decoder_of(outs[0]), jcfg)
    assert cos > 0.98 and 0.9 <= ratio <= 1.1, (cos, ratio)


@pytest.mark.parametrize("megakernel", ["on", "off"])
def test_shardmap_mapper_step_matches_reference(tmp_path, megakernel):
    """parallel.make_shardmap_mapper_step on two ranks against the
    reference's on make_mesh(2) (the adapter over the engine step, BA
    off), 2 iterations on the 256-wide decoder with the reference's
    per-device draws: the returned (last) loss rtol 2e-2 and the change
    of the field as in (b); the adapter's opt_state is the reference's
    None."""
    jcfg, tree, params = tree_and_params(6)
    win = window(6)
    iters = 2
    key = jax.random.PRNGKey(9)
    kw = ecfg_kw(megakernel=megakernel)
    run_j, init_j = j_shardmap(jcfg, JRC(), j_mesh(2), JEC(**kw), F)
    p_j, st_j, loss_j = run_j(tree, init_j(tree), win["colors"],
                              win["depths"], win["cams"], win["valid"],
                              win["bound"], key, iters)
    assert st_j is None
    ppf = kw["mapping_pixels"] // F // 2
    per_rank = [{f"draw_{i}": a for i, a in enumerate(
        per_iter_draws(key, ppf, iters, fold=d))} for d in range(2)]
    outs = run_ranks(tmp_path, "shardmap", 2, dict(params, **win),
                     dict(hidden=256, n_blocks=4, rcfg={}, ecfg=kw,
                          max_frames=F, iters=iters), per_rank)
    assert_ranks_equal(outs)
    np.testing.assert_allclose(float(outs[0]["loss"]), float(loss_j),
                               rtol=2e-2)
    cos, ratio = field_change(tree, p_j, decoder_of(outs[0]), jcfg)
    assert cos > 0.98 and 0.9 <= ratio <= 1.1, (cos, ratio)


# -- (c) ---------------------------------------------------------------

@pytest.mark.parametrize("megakernel", ["on", "off"])
def test_group_sum_equals_one_process_on_the_union(tmp_path, megakernel):
    """Two ranks' summed gradients (one iteration, each rank its own
    pixels) against one process without a group on the union of their
    pixels (twice the pixels per frame, each frame's rows rank 0's then
    rank 1's, the regulation uniforms with them). The far clip reads the
    max depth of the rays a rank renders (per device, as the reference's
    shard_map), so both ranks' first pixel is the window's deepest: each
    rank's max then equals the union's."""
    _, _, params = tree_and_params(2)
    win = window(2)
    kw = ecfg_kw(megakernel=megakernel)
    ppf = kw["mapping_pixels"] // F // 2
    rng = np.random.default_rng(4)
    idx = [rng.integers(0, H * W, (F, ppf)) for _ in range(2)]
    f_max, px_max = divmod(int(win["depths"].argmax()), H * W)
    for i in idx:
        i[f_max, 0] = px_max
    t_reg = [rng.uniform(size=(F * ppf, 32)).astype(np.float32)
             for _ in range(2)]
    per_rank = [{"draw_0": idx[r], "draw_1": t_reg[r]} for r in range(2)]
    outs = run_ranks(tmp_path, "mapper", 2, dict(params, **win),
                     dict(hidden=256, n_blocks=4, rcfg={}, ecfg=kw,
                          max_frames=F, iters=1), per_rank)
    assert_ranks_equal(outs)
    assert_ranks_equal(outs, "g.")
    union_idx = np.concatenate(idx, axis=1)
    union_t = np.concatenate([t.reshape(F, ppf, -1) for t in t_reg],
                             axis=1).reshape(F * 2 * ppf, -1)
    dec = decoder_of(params)
    _, losses = make_mapper_step(MLPConfig(), RenderConfig(),
                                 EngineConfig(**kw), F)(
        dec, *(T(win[k]) for k in ("colors", "depths", "cams", "valid", "ba",
                                   "bound")),
        Draws(replay=[T(union_idx), T(union_t)]), 1)
    np.testing.assert_allclose(outs[0]["losses"], losses.numpy(), rtol=1e-5)
    for name, p in dec.named_parameters():
        g = p.grad.numpy()
        err = np.abs(outs[0][f"g.{name}"] - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (name, err, np.abs(g).max())


# -- (d) ---------------------------------------------------------------

def tiny_slam_cfg(output):
    from tests.test_engine import tiny_cfg
    from pointnerf_slam_torch.io.config import load_config
    cfg = load_config(None)
    ref = tiny_cfg()
    for k in ("scale", "weak_depth", "depth_supervision", "verbose", "cam",
              "model", "rendering", "mapping", "tracking", "data",
              "track_every_frame"):
        if isinstance(ref[k], dict):
            cfg[k].update(ref[k])
        else:
            cfg[k] = ref[k]
    cfg["tracking"]["gt_camera"] = True
    cfg["data"]["output"] = str(output)
    cfg["data"]["frame_cache_dir"] = ""
    return cfg


def depth_probe(slam, dec):
    """Depth L1 (mean, median) of frame 4 rendered every 4th pixel against
    gt (the reference test's probe)."""
    from pointnerf_slam_torch.core.rays import get_rays
    from pointnerf_slam_torch.render.renderer import render_rays
    _, _, depth, c2w = slam.frame_reader[4]
    o, d = get_rays(slam.H, slam.W, slam.fx, slam.fy, slam.cx, slam.cy,
                    T(c2w[:3, :4]).float())
    o, d = o[::4, ::4].reshape(-1, 3), d[::4, ::4].reshape(-1, 3)
    gtd = T(depth)[::4, ::4].reshape(-1).float()
    with torch.no_grad():
        dep = render_rays(dec, slam.rcfg, o, d, slam.bound, gtd)[0]
    err = (dep - gtd).abs().numpy()
    return float(err.mean()), float(np.median(err))


def reference_init(cfg) -> dict:
    """The reference system's initial decoder at cfg's seed (its
    get_model init on PRNGKey(seed)), as "p." arrays of the port's
    state dict: the two packages' generators draw different weights."""
    from pointnerf_slam_tpu.models.decoders import get_model as j_get_model
    _, init_fn = j_get_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray, init_fn(
        jax.random.PRNGKey(cfg.get("seed", 1219))))
    return {f"p.{k}": v.numpy() for k, v in params_from_jax(tree).items()}


def test_engine_two_ranks_against_one(tmp_path):
    """The port's tiny engine (test_engine.tiny_cfg, gt cameras, the
    default seed 1219 of the reference's TestEngineMultiDevice) on two
    gloo ranks against one process, both starting from the reference's
    initial decoder at that seed: the reference test's bounds (mean <
    0.25, median < 0.13, |two - one| < 0.04), both ranks' poses, mapping
    losses and final decoders equal bit for bit."""
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    cfg = tiny_slam_cfg(tmp_path / "out")
    cfg["parallel"] = {"data_devices": "auto"}
    init = reference_init(cfg)
    outs = run_ranks(tmp_path, "engine", 2, init, {"slam": cfg})
    assert_ranks_equal(outs)
    np.testing.assert_array_equal(outs[0]["est"], outs[1]["est"])
    np.testing.assert_array_equal(outs[0]["map_losses"],
                                  outs[1]["map_losses"])
    one = PointNeRFSLAM(dict(cfg, parallel={"data_devices": 1}),
                        device="cpu")
    one.decoder.load_state_dict({k[2:]: T(v) for k, v in init.items()})
    one.run()
    hidden, n_blocks = cfg["model"]["hidden_size"], cfg["model"]["n_blocks"]
    err_multi, med_multi = depth_probe(one, decoder_of(outs[0], hidden,
                                                       n_blocks))
    err_single, _ = depth_probe(one, one.decoder)
    assert np.isfinite(err_multi) and np.isfinite(err_single)
    assert err_multi < 0.25, err_multi
    assert med_multi < 0.13, med_multi
    assert abs(err_multi - err_single) < 0.04, (err_multi, err_single)


def test_engine_ranks_with_outputs_on_rank_zero_stay_equal(tmp_path):
    """The tiny engine with tracking on (no gt cameras) on two gloo ranks,
    outputs.attach_outputs on each into its own directory, the writers at
    every frame: rank 0 alone writes its checkpoints and panels, and the
    ranks' poses, keyframe cameras, mapping losses and final decoders stay
    equal bit for bit though rank 0 alone draws the tracking panels
    (attach_outputs makes every rank commit its tracked poses alike; a
    rank that did not would keep the tracker's camera for its keyframe
    where rank 0 keeps the host table's round trip of it)."""
    cfg = tiny_slam_cfg(tmp_path / "out")
    cfg["tracking"]["gt_camera"] = False
    cfg["data"]["n_frames"] = 5
    cfg["mapping"].update(iters_first=60, vis_freq=1)
    cfg["tracking"]["vis_freq"] = 1
    cfg["meshing"].update(final_mesh=False, eval_rec=False)
    cfg["parallel"] = {"data_devices": "auto"}
    outs = run_ranks(tmp_path, "engine", 2, reference_init(cfg),
                     {"slam": cfg, "outputs": True})
    assert_ranks_equal(outs)
    np.testing.assert_array_equal(outs[0]["est"], outs[1]["est"])
    np.testing.assert_array_equal(outs[0]["map_losses"],
                                  outs[1]["map_losses"])
    np.testing.assert_array_equal(outs[0]["kf_cams"], outs[1]["kf_cams"])
    dirs = {str(w).split(os.sep)[0] for w in outs[0]["written"]}
    assert {"ckpts", "mapping_vis", "tracking_vis"} <= dirs, dirs
    assert outs[1]["written"].size == 0, outs[1]["written"]


# -- (e) ---------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True])
def test_multiscene_matches_reference(stacked):
    """Two scenes (near and far depth) through make_multiscene_mapper_step
    against the reference's vmapped step, each scene on its own replayed
    draws (per_iter_draws of its key): per-scene losses rtol 2e-2, and the
    two scenes' final losses apart as the reference asserts. The decoders
    go in as a list or as stack_scenes' stacks."""
    S, iters = 2, 5
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=32, skips=(),
                n_blocks=2)
    kw = ecfg_kw(mapping_pixels=64, w_beyond_loss=0.0, no_ba_fast=False)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    trees = [init_mlp(k, jcfg) for k in keys]
    rng = np.random.default_rng(6)
    colors = (rng.uniform(size=(S, F, H, W, 3)) * 255).astype(np.uint8)
    depths = np.stack([np.full((F, H, W), 1.0, np.float32),
                       np.full((F, H, W), 3.0, np.float32)])
    cams = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 2.5], np.float32),
                   (S, F, 1))
    valid = np.ones((S, F), bool)
    ba = np.zeros((S, F), bool)
    bounds = np.tile(BOUND, (S, 1, 1))
    _, _, _, l_j = j_multiscene(jcfg, JRC(**SMALL_RC), JEC(**kw), F)(
        j_stack(trees), {}, colors, depths, cams, valid, ba, bounds, keys,
        iters)
    decs = []
    for t in trees:
        d = IMAPDecoder(MLPConfig(hidden_size=32, n_blocks=2))
        d.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, t)))
        decs.append(d)
    draws = [Draws(replay=[T(a) for a in per_iter_draws(
        keys[s], 64 // F, iters, n_samples=SMALL_RC["N_samples"])])
        for s in range(S)]
    step = make_multiscene_mapper_step(MLPConfig(hidden_size=32,
                                                 n_blocks=2),
                                       RenderConfig(**SMALL_RC),
                                       EngineConfig(**kw), F)
    arg = stack_scenes(decs) if stacked else decs
    out, _, cams_t, l_t = step(arg, {}, T(colors), T(depths), T(cams),
                               T(valid), T(ba), T(bounds), draws, iters)
    assert l_t.shape == (S, iters) and cams_t.shape == (S, F, 7)
    assert torch.isfinite(l_t).all()
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=2e-2)
    assert abs(float(l_t[0, -1]) - float(l_t[1, -1])) > 1e-3
    # each scene's decoder moved, and only by its own step
    for s in range(S):
        w0 = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    trees[s]))["out.w"]
        w = out[0]["out.w"][s] if stacked else out[s].out.w.detach()
        assert float((w - w0).abs().max()) > 0, s


# -- (f) ---------------------------------------------------------------

@pytest.mark.parametrize("want,world,n", [
    ("auto", 1, 1), ("auto", 4, 4), (1, 1, 1), (0, 1, 1), (8, 1, 1),
    (2, 2, 2), (8, 4, 4)])
def test_data_devices_resolution(want, world, n):
    """"auto" is the group's world size, an int is clamped to it, 0 and 1
    mean one device."""
    assert data_devices(want, world) == n


@pytest.mark.parametrize("want,world", [(1, 2), (0, 2), (2, 4)])
def test_data_devices_below_the_group_raise(want, world):
    """A group of more ranks than data_devices resolves to would map apart:
    refused, in the system as in the resolution."""
    with pytest.raises(ValueError, match="map apart"):
        data_devices(want, world)


@pytest.mark.parametrize("want,count,n", [
    ("auto", None, 1), (3, None, 3), (0, None, 1), ("auto", 2, 2),
    (4, 2, 2), (1, 8, 1)])
def test_resolve_data_devices_against_a_device_count(want, count, n):
    """One rule resolves parallel.data_devices for the system (against its
    group) and for run.py's launch (against the local cards, or no count
    on the CPU: the int as given, "auto" one)."""
    assert resolve_data_devices(want, count) == n


def test_mesh_without_a_group_is_one_rank():
    g = make_mesh(device="cpu")
    assert g == DataGroup(None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2, device="cpu")


# -- (g) ---------------------------------------------------------------

def test_world_size_one_is_bit_identical(tmp_path):
    """A one-rank gloo group's mapper step equals the step without a group
    bit for bit (no collective, the same draws), on the fused branch."""
    _, _, params = tree_and_params(3)
    win = window(3)
    outs = run_ranks(tmp_path, "world1", 1, dict(params, **win),
                     dict(hidden=256, n_blocks=4, rcfg={}, ecfg=ecfg_kw(),
                          max_frames=F, iters=3))
    o = outs[0]
    assert int(o["world"]) == 1
    for k in o:
        if k.startswith("group."):
            np.testing.assert_array_equal(o[k], o["none." + k[6:]],
                                          err_msg=k)


# -- run.py --------------------------------------------------------------

def test_run_py_starts_one_process_per_data_device(tmp_path):
    """`python -m pointnerf_slam_torch.run CFG --device cpu` with
    parallel.data_devices 2 starts itself again as two gloo ranks through
    torch.distributed.run: the run completes, rank 0 alone prints the frame
    lines and the summary and writes the checkpoints."""
    cfg = {"inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                        "box.yaml"),
           "cam": {"H": 40, "W": 52, "fx": 30.0, "fy": 30.0, "cx": 25.5,
                   "cy": 19.5, "crop_edge": 0},
           "model": {"hidden_size": 32, "n_blocks": 2},
           "mapping": {"pixels": 200, "iters": 6, "iters_first": 10,
                       "every_frame": 2, "color_refine": False},
           "tracking": {"pixels": 100, "iters": 4, "gt_camera": True},
           "meshing": {"final_mesh": False, "eval_rec": False},
           "data": {"frame_cache_dir": ""},
           "parallel": {"data_devices": 2}}
    path = tmp_path / "two.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "pointnerf_slam_torch.run",
                        str(path), "--device", "cpu", "--n_frames", "3",
                        "--output", str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert "parallel.data_devices: 2 processes" in lines
    assert sum(ln.startswith("frame    0") for ln in lines) == 1, p.stdout
    assert sum(ln.startswith("done: frames 0..2") for ln in lines) == 1
    assert (out / "ckpts" / "00002.npz").exists()
