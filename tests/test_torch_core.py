"""Port core math (pointnerf_slam_torch.core) against the JAX reference
(pointnerf_slam_tpu.core) on the same numpy inputs; atol 1e-5 unless a
test says otherwise. Also: config loading parity and the port's import
boundary (no JAX, nothing of the JAX package)."""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_slam_tpu import core as J
from pointnerf_slam_tpu.core import se3_np as Jnp
from pointnerf_slam_tpu.engine.state import EngineConfig as JEngineConfig
from pointnerf_slam_tpu.io.config import load_config as jload
from pointnerf_slam_torch.core import compositing as TC
from pointnerf_slam_torch.core import rays as TR
from pointnerf_slam_torch.core import sampling as TS
from pointnerf_slam_torch.core import se3 as T3
from pointnerf_slam_torch.core import se3_np as Tnp
from pointnerf_slam_torch.engine.state import EngineConfig
from pointnerf_slam_torch.io.config import load_config
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def t(a):
    return torch.as_tensor(np.array(a))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol)


def rand_cams(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    tr = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([q, tr], 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_forward(seed):
    rng = np.random.default_rng(seed)
    cams = rand_cams(rng, 16)
    close(T3.camera_from_tensor(t(cams)), J.camera_from_tensor(cams))
    RT = np.asarray(J.camera_from_tensor(cams))
    close(T3.tensor_from_camera(t(RT)), J.tensor_from_camera(RT))
    close(T3.to_homogeneous(t(RT)), J.to_homogeneous(RT))
    close(T3.tensor_from_camera(t(RT), t_first=True),
          J.tensor_from_camera(RT, t_first=True))


def test_se3_gradient():
    rng = np.random.default_rng(2)
    cam = rand_cams(rng, 1)[0]
    w = rng.normal(size=(3, 4)).astype(np.float32)
    g_j = jax.grad(lambda c: jnp.sum(J.camera_from_tensor(c) * w))(cam)
    c = t(cam).clone().requires_grad_(True)
    (T3.camera_from_tensor(c) * t(w)).sum().backward()
    close(c.grad, g_j, atol=1e-4)


def test_se3_np_copy():
    rng = np.random.default_rng(3)
    cams = rand_cams(rng, 8)
    close(Tnp.camera_from_tensor_np(cams), Jnp.camera_from_tensor_np(cams))
    RT = Jnp.to_homogeneous_np(Jnp.camera_from_tensor_np(cams))
    close(Tnp.tensor_from_camera_np(RT), Jnp.tensor_from_camera_np(RT))
    close(Tnp.interp_c2w_np(RT[0], RT[1], 0.3),
          Jnp.interp_c2w_np(RT[0], RT[1], 0.3))


def test_rays_from_uv():
    rng = np.random.default_rng(4)
    i = rng.uniform(0, 160, 50).astype(np.float32)
    j = rng.uniform(0, 120, 50).astype(np.float32)
    c2w = np.asarray(J.camera_from_tensor(rand_cams(rng, 1)[0]))
    ro_t, rd_t = TR.rays_from_uv(t(i), t(j), t(c2w), 90.0, 91.0, 79.5, 59.5)
    ro_j, rd_j = J.rays_from_uv(i, j, c2w, 90.0, 91.0, 79.5, 59.5)
    close(ro_t, ro_j)
    close(rd_t, rd_j)


def test_gather_pixels():
    rng = np.random.default_rng(5)
    depth = rng.uniform(0, 3, (12, 17)).astype(np.float32)
    color = rng.uniform(size=(12, 17, 3)).astype(np.float32)
    idx = rng.integers(0, 12 * 17, 40)
    for a, b in zip(TR.gather_pixels(t(idx), 17, t(depth), t(color)),
                    J.gather_pixels(jnp.asarray(idx), 17, depth, color)):
        close(a, b, atol=0)


def test_sample_uv_uniform_range_and_crop():
    g = torch.Generator().manual_seed(0)
    idx = TR.sample_uv_uniform(g, 20, 3, 10, 4, 15, 4000).numpy()
    rows, cols = idx // 20, idx % 20
    assert rows.min() == 3 and rows.max() == 9
    assert cols.min() == 4 and cols.max() == 14


def test_sample_uv_valid_replays_jax_ranks():
    """The count-CDF + searchsorted mapping from a rank to a pixel equals
    the reference's on the same ranks; torch draws land on valid pixels."""
    rng = np.random.default_rng(6)
    mask = rng.uniform(size=(9, 11)) > 0.6
    key = jax.random.PRNGKey(3)
    idx_j, n_valid = J.sample_uv_valid(key, jnp.asarray(mask), 64)
    k_rank, _ = jax.random.split(key)
    ranks = jax.random.randint(k_rank, (64,), 0, max(int(mask.sum()), 1))
    idx_t = TR.valid_index_of_rank(t(mask), t(np.asarray(ranks)).long(),
                                   torch.zeros(64, dtype=torch.long))
    close(idx_t, idx_j, atol=0)
    g = torch.Generator().manual_seed(1)
    idx, nv = TR.sample_uv_valid(g, t(mask), 500)
    assert int(nv) == int(n_valid) == mask.sum()
    assert mask.reshape(-1)[idx.numpy()].all()


def test_far_bound_and_stratified():
    rng = np.random.default_rng(7)
    ro = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    rd = rng.normal(size=(30, 3)).astype(np.float32)
    bound = np.array([[-2, 2.5], [-3, 2], [-2.2, 2.2]], np.float32)
    far_t = TS.ray_far_bound(t(ro), t(rd), t(bound))
    close(far_t, J.ray_far_bound(ro, rd, bound))
    near = rng.uniform(0.01, 0.1, (30, 1)).astype(np.float32)
    far = np.asarray(far_t)[:, None]
    close(TS.stratified_zvals(t(near), t(far), 16),
          J.stratified_zvals(None, near, far, 16))
    u = rng.uniform(size=(30, 16)).astype(np.float32)
    z_t = TS.stratified_zvals(t(near), t(far), 16, t(u))
    # the reference draws its own uniforms; replay them through its formula
    z_j = np.asarray(J.stratified_zvals(None, near, far, 16))
    mids = 0.5 * (z_j[:, 1:] + z_j[:, :-1])
    up = np.concatenate([mids, z_j[:, -1:]], 1)
    lo = np.concatenate([z_j[:, :1], mids], 1)
    close(z_t, lo + (up - lo) * u)


def test_sample_pdf_det():
    rng = np.random.default_rng(8)
    z = np.sort(rng.uniform(0.1, 3.0, (25, 32)), 1).astype(np.float32)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    # bins with mass: a cdf step within float noise of the 1e-5 denominator
    # floor is a discontinuity of the sampler itself (in both packages)
    w = rng.uniform(0.1, 1.0, size=(25, 30)).astype(np.float32)
    close(TS.sample_pdf(t(bins), t(w), 12),
          J.sample_pdf(None, bins, w, 12, det=True), atol=1e-4)


def test_raw2outputs_and_gradient():
    rng = np.random.default_rng(9)
    raw = rng.normal(size=(20, 24, 4)).astype(np.float32)
    raw[..., 3] = np.abs(raw[..., 3]) * 3
    z = np.sort(rng.uniform(0.1, 3.0, (20, 24)), 1).astype(np.float32)
    rd = rng.normal(size=(20, 3)).astype(np.float32)
    for a, b in zip(TC.raw2outputs(t(raw), t(z), t(rd)),
                    J.raw2outputs(raw, z, rd)):
        close(a, b, atol=1e-4)
    g_j = jax.grad(lambda r: jnp.sum(J.raw2outputs(r, z, rd)[0]))(raw)
    r = t(raw).clone().requires_grad_(True)
    TC.raw2outputs(r, t(z), t(rd))[0].sum().backward()
    close(r.grad, g_j, atol=1e-4)


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
              recursive=True)))
def test_config_loads_equal(path):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        cfg_t, cfg_j = load_config(path), jload(path)
    finally:
        os.chdir(cwd)
    assert cfg_t == cfg_j
    try:
        ej = JEngineConfig.from_cfg(cfg_j, 10, 12, 1.0, 1.0, 5.0, 6.0)
    except KeyError:
        return
    et = EngineConfig.from_cfg(cfg_t, 10, 12, 1.0, 1.0, 5.0, 6.0)
    import dataclasses
    assert dataclasses.asdict(et) == dataclasses.asdict(ej)


def test_port_imports_no_jax_and_no_reference_package():
    """The port, chip_smoke.py, bench_torch.py and the port's scripts
    (scripts/*_torch.py, scripts/torch_*.py) import torch, never JAX, and
    name nothing of the JAX package. The scripts that compare the two
    packages on purpose (track_compare.py, frame30_rate.py,
    nice_track_witness.py) are not the port's."""
    files = glob.glob(os.path.join(REPO, "pointnerf_slam_torch", "**",
                                   "*.*"), recursive=True)
    files = [f for f in files if f.endswith((".py", ".cu", ".cuh"))]
    scripts = sorted(glob.glob(os.path.join(REPO, "scripts", "*_torch.py"))
                     + glob.glob(os.path.join(REPO, "scripts",
                                              "torch_*.py")))
    assert {os.path.basename(f) for f in scripts} >= {
        "flagship_seeds_torch.py", "prewarm_synth_cache_torch.py",
        "sweep_superpoint_torch.py", "torch_kernel_compare.py",
        "torch_kernel_profile.py"}
    files += scripts
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "bench_torch.py")]
    assert len(files) > 20
    bad_import = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    for f in files:
        src = open(f).read()
        assert not bad_import.search(src), f
        if not f.endswith("chip_smoke.py"):
            assert "pointnerf_slam_tpu" not in src, f
    # chip_smoke names the reference only as the TPU kernel's location
    smoke = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import pointnerf_slam_tpu" not in smoke
    assert "from pointnerf_slam_tpu" not in smoke
