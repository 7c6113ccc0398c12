"""The port's SuperPoint family against the JAX reference on the CPU: the
network forward, the .pth and npz loaders, the extractor, the flagship's
bootstrap decisions with the distilled checkpoint, and two training steps
of tools/train_superpoint.

Bounds: the heatmap within 1e-4 and the coarse descriptors within 1e-5
(float32 convolutions summed in another order; the heatmap is a softmax
of 65 logits); a single corner lands on the same pixel (the cell layout);
loaded parameters bit for bit; the extractor's valid keypoints the same
pixels for at least 98% of them (top-K ties and NMS near-ties at float32
noise, bounded by share as the Harris test is not), and on the shared
keypoints positions within 1e-3 px, descriptors within 1e-4 and angles
within 1e-4 rad; the bootstrap decisions at frames 5, 10, 15 and 20
equal (SP_DECISIONS); the training loss within rtol 1e-4 at both steps
and each gradient within 1e-3 of its largest magnitude; the Adam updates
within 1e-6 on the entries whose gradient is at least 1e-3 of the
largest at every step so far (below it Adam's step of about +-lr follows
float32 noise)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pointnerf_slam_tpu.frontend.features as jfe
import pointnerf_slam_tpu.tools.train_superpoint as jts
import pointnerf_slam_torch.frontend.features as tfe
import pointnerf_slam_torch.tools.train_superpoint as tts
from tests import test_frontend
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "pretrained", "superpoint_synthetic.npz")
WEAK = os.path.join(REPO, "configs", "Synthetic", "room_bench_weak.yaml")
# the flagship's front-end decision at each tracked frame before a
# bootstrap, with the distilled checkpoint (chip_smoke.SP_DECISIONS)
SP_DECISIONS = {5: "refused", 10: "refused", 15: "refused", 20: "refused"}


@pytest.fixture(scope="module")
def room():
    """Frames 0, 5, 10, 15, 20 of the flagship (680x1200)."""
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.io.datasets import get_dataset
    cfg = load_config(WEAK)
    cfg["data"]["frame_cache_dir"] = ""
    ds = get_dataset(cfg, None, cfg["scale"])
    return cfg, ds, {i: ds[i] for i in (0, 5, 10, 15, 20)}


def gray_of(frame):
    return np.asarray(frame[1], np.float32).mean(-1)


def corner_image(H, W):
    img = np.full((H, W), 0.1, np.float32)
    img[H // 2 + 3:, W // 2 + 5:] = 0.9
    return img


@pytest.mark.parametrize("shape,kind", [((120, 160), "noise"),
                                        ((120, 160), "corner"),
                                        ((680, 1200), "noise")])
def test_forward_matches_reference(shape, kind):
    H, W = shape
    img = corner_image(H, W) if kind == "corner" else \
        np.random.default_rng(0).random((H, W), np.float32)
    hj, dj = [np.asarray(a) for a in jfe.superpoint_forward(
        jfe.load_superpoint_npz(NPZ), jnp.asarray(img))]
    net = tfe.SuperPointNet(tfe.load_superpoint_npz(NPZ)).eval()
    with torch.no_grad():
        ht, dt = [a.numpy() for a in tfe.superpoint_forward(
            net, torch.from_numpy(img))]
    assert ht.shape == (H, W) and dt.shape == (256, H // 8, W // 8)
    np.testing.assert_allclose(ht, hj, atol=1e-4)
    np.testing.assert_allclose(dt, dj, atol=1e-5)
    if kind == "corner":
        # a transposed cell layout moves the peak inside its cell
        assert np.argmax(ht) == np.argmax(hj)
        y, x = np.unravel_index(np.argmax(ht), ht.shape)
        assert abs(y - (H // 2 + 3)) <= 3 and abs(x - (W // 2 + 5)) <= 3


def test_pth_converter_and_npz_both_ways(tmp_path):
    """A random-weight SuperPointNet state dict saved as .pth: both
    packages load the same parameters and the port's forward equals the
    torch module's; npz written by either package loads in the other."""
    ref_net = test_frontend.TestSuperPointTorchParity()._torch_net()
    pth = str(tmp_path / "superpoint_rand.pth")
    torch.save(ref_net.state_dict(), pth)
    pt, pj = tfe.load_superpoint_torch(pth), jfe.load_superpoint_torch(pth)
    assert sorted(pt) == sorted(pj)
    for name in pj:
        for kind in ("w", "b"):
            np.testing.assert_array_equal(pt[name][kind].numpy(),
                                          np.asarray(pj[name][kind]))
    img = np.random.default_rng(2).random((48, 64), np.float32)
    with torch.no_grad():
        semi_r, desc_r = ref_net(torch.from_numpy(img)[None, None])
        semi_t, desc_t = tfe.SuperPointNet(pt)(
            torch.from_numpy(img)[None, None])
    np.testing.assert_allclose(semi_t.numpy(), semi_r.numpy(), atol=1e-5)
    np.testing.assert_allclose(desc_t.numpy(), desc_r.numpy(), atol=1e-6)

    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tfe.save_superpoint_npz(a, pt)
    jfe.save_superpoint_npz(b, pj)
    for loaded in (jfe.load_superpoint_npz(a), tfe.load_superpoint_npz(b)):
        for name in pj:
            for kind in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(loaded[name][kind]),
                                              np.asarray(pj[name][kind]))


@pytest.mark.parametrize("which", ["box", "room"])
def test_extractor_matches_reference(room, which):
    if which == "room":
        gray, max_kps = gray_of(room[2][0]), 1000
    else:
        from tests.test_torch_frontend import box_frames
        gray, max_kps = gray_of(box_frames([0])[2][0]), 300
    kj, dj, vj, aj = [np.asarray(x) for x in jfe.SuperPointExtractor(
        NPZ, max_kps=max_kps).extract(jnp.asarray(gray))]
    kt, dt, vt, at = [x.numpy() for x in tfe.SuperPointExtractor(
        NPZ, max_kps=max_kps, device="cpu").extract(torch.from_numpy(gray))]
    assert vj.sum() > 20
    pj = {tuple(p): i for i, p in enumerate(np.round(kj).astype(int))
          if vj[i]}
    pt = {tuple(p): i for i, p in enumerate(np.round(kt).astype(int))
          if vt[i]}
    shared = sorted(set(pj) & set(pt))
    assert len(shared) >= 0.98 * max(len(pj), len(pt)), \
        (len(shared), len(pj), len(pt))
    it = [pt[p] for p in shared]
    ij = [pj[p] for p in shared]
    np.testing.assert_allclose(kt[it], kj[ij], atol=1e-3)
    np.testing.assert_allclose(dt[it], dj[ij], atol=1e-4)
    np.testing.assert_allclose(at[it], aj[ij], atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(dt[vt], axis=1), 1.0,
                               atol=1e-5)


def test_flagship_bootstrap_decisions_with_the_checkpoint(room):
    """The flagship with `superpoint_weights` naming the distilled npz:
    each package's front-end tries the bootstrap against frame 0 at 5, 10,
    15 and 20 in turn (one front-end, as the system does); the decisions
    equal SP_DECISIONS in both, the card's smoke holds the port to the
    same list."""
    import chip_smoke
    from pointnerf_slam_tpu.frontend import SparseFrontend as JFE
    from pointnerf_slam_tpu.io.config import load_config as jload
    from pointnerf_slam_torch.frontend.frontend import SparseFrontend
    cfg, ds, frames = room
    cfg = dict(cfg, superpoint_weights=NPZ)
    jcfg = dict(jload(WEAK), superpoint_weights=NPZ)
    got = {}
    for name, fe in (
            ("jax", JFE(jcfg, ds.H, ds.W, ds.fx, ds.fy, ds.cx, ds.cy)),
            ("torch", SparseFrontend(cfg, ds.H, ds.W, ds.fx, ds.fy, ds.cx,
                                     ds.cy, device="cpu"))):
        assert type(fe.extractor).__name__ == "SuperPointExtractor"
        fe.extractor = chip_smoke.SpMemo(fe.extractor, {})
        # the gate that refuses (too few triangulations, too little
        # parallax) follows each package's own RANSAC draws
        got[name] = chip_smoke.sp_decisions(fe, frames)[0]
    assert got["jax"] == got["torch"] == SP_DECISIONS, got
    assert chip_smoke.SP_DECISIONS == SP_DECISIONS


def test_train_superpoint_two_steps_match_reference():
    """Two Adam steps from the same numpy-initialised parameters on the
    same numpy-drawn batch (crops, homographies, photometric draws): the
    warps and Harris labels agree, and on the reference's warps and
    labels the loss and every gradient agree."""
    rng = np.random.default_rng(0)
    corpus = np.stack([
        np.clip(0.5 + 0.4 * np.sin(np.arange(200)[None] / (5 + k))
                * np.cos(np.arange(150)[:, None] / (7 + k))
                + 0.05 * rng.random((150, 200)), 0, 1)
        for k in range(3)]).astype(np.float32)
    params = {}
    for name, cin, cout, ks in tfe._SP_LAYERS + tfe._SP_HEADS:
        params[name] = {
            "w": (rng.normal(size=(cout, cin, ks, ks))
                  * np.sqrt(2.0 / (cin * ks * ks))).astype(np.float32),
            "b": (0.01 * rng.normal(size=cout)).astype(np.float32)}
    draws = np.random.default_rng(5)
    clean = tts.crop_batch(corpus, draws, 2)
    Hms = np.stack([tts.sample_homography(draws) for _ in range(2)])
    grays = tts.photometric_aug(clean, draws)

    warps_j = np.stack([np.asarray(jts.warp_image(jnp.asarray(c),
                                                  jnp.asarray(h)))
                        for c, h in zip(clean, Hms)])
    warps_t = np.stack([tts.warp_image(torch.from_numpy(c),
                                       torch.from_numpy(h)).numpy()
                        for c, h in zip(clean, Hms)])
    np.testing.assert_allclose(warps_t, warps_j, atol=1e-5)
    la_j = np.stack([np.asarray(jts.detector_labels(jnp.asarray(g)))
                     for g in list(clean) + list(warps_j)])
    la_t = np.stack([tts.detector_labels(torch.from_numpy(g)).numpy()
                     for g in list(clean) + list(warps_j)])
    assert (la_t == la_j).mean() >= 0.99, (la_t != la_j).sum()
    warps = tts.photometric_aug(warps_j, draws)
    la, lb = la_j[:2], la_j[2:]

    loss_fn = jts.make_loss_fn()

    def jloss(p):
        lv, _ = jax.vmap(lambda g, w, h, a, b: loss_fn(p, g, w, h, a, b))(
            jnp.asarray(grays), jnp.asarray(warps), jnp.asarray(Hms),
            jnp.asarray(la), jnp.asarray(lb))
        return lv.mean()

    pj = jax.tree_util.tree_map(jnp.asarray, params)
    opt = optax.adam(1e-3)
    state = opt.init(pj)
    net = tfe.SuperPointNet(params)
    topt = torch.optim.Adam(net.parameters(), lr=1e-3)
    batch = [torch.from_numpy(np.asarray(x)) for x in
             (grays, warps, Hms, la.astype(np.int64), lb.astype(np.int64))]
    big = {}
    for step in range(2):
        lj, gj = jax.value_and_grad(jloss)(pj)
        lt = tts.batch_loss(net, *batch)[0]
        topt.zero_grad()
        lt.backward()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
        for name, p in net.params().items():
            for kind in ("w", "b"):
                g_ref = np.asarray(gj[name][kind])
                err = np.abs(p[kind].grad.numpy() - g_ref).max()
                assert err <= 1e-3 * np.abs(g_ref).max(), (step, name, kind)
        upd, state = opt.update(gj, state)
        pj = optax.apply_updates(pj, upd)
        topt.step()
        # the Adam steps agree where the gradient, now and at every earlier
        # step (Adam's moments carry it), is above float32 noise (there
        # Adam's step is about +-lr whatever the gradient's size); the
        # second step starts both from the reference's parameters
        for name, p in net.params().items():
            for kind in ("w", "b"):
                g_ref = np.abs(np.asarray(gj[name][kind]))
                d = np.abs(p[kind].detach().numpy()
                           - np.asarray(pj[name][kind]))
                big[name, kind] = big.get((name, kind), True) \
                    & (g_ref >= 1e-3 * g_ref.max())
                assert d[big[name, kind]].max() <= 1e-6, (step, name, kind)
        net.load_params(jax.tree_util.tree_map(np.asarray, pj))
