"""Distill a SuperPoint checkpoint on the synthetic corpus (the JAX
reference's tools/train_superpoint.py).

The public MagicLeap weights (superpoint_v1.pth) are not in the
repository, so this trains a checkpoint of the same architecture on
procedurally rendered synthetic frames:

  - detector head: distilled from the Harris teacher, per 8x8 cell a
    65-way cross-entropy (64 in-cell positions + dustbin); a cell's label
    is the position of the strongest NMS'd Harris corner in it, else the
    dustbin.
  - descriptor head: the SuperPoint paper's homography hinge loss: cell
    pairs related by a known random homography are positives (margin 1),
    all others negatives (margin 0.2), positives weighted lambda_d.

The corpus, crops, homographies and photometric draws are numpy from one
seed, so both packages see the same batches; the optimiser is
torch.optim.Adam on the device the caller names. Output: the shared npz
(frontend.features.save_superpoint_npz), by default
pretrained/superpoint_synthetic.npz.

  python -m pointnerf_slam_torch.tools.train_superpoint [--steps 2000]
      [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..frontend.features import (SuperPointNet, _maxpool_nms, harris_score,
                                 init_superpoint, save_superpoint_npz)

H_IMG, W_IMG = 120, 160
HC, WC = H_IMG // 8, W_IMG // 8


# --------------------------------------------------------------------------
# corpus (numpy)
# --------------------------------------------------------------------------

def render_corpus(n_images: int, seed: int = 0,
                  match_run_scale: bool = True) -> np.ndarray:
    """(N, H', W') gray synthetic room renders from random in-room views;
    training crops H_IMG x W_IMG windows from them. match_run_scale renders
    at the run's angular resolution (fx/W = 600/1200) at half size (340x600,
    fx 300); otherwise full 120x160 frames at fx 100."""
    from ..io.synthetic import SyntheticDataset, _lookat_c2w

    if match_run_scale:
        Hr, Wr, f = 340, 600, 300.0
    else:
        Hr, Wr, f = H_IMG, W_IMG, 100.0
    cfg = {"cam": {"H": Hr, "W": Wr, "fx": f, "fy": f,
                   "cx": (Wr - 1) / 2, "cy": (Hr - 1) / 2,
                   "crop_edge": 0},
           "data": {"n_frames": 2, "output": "/tmp/sp_corpus"}}
    ds = SyntheticDataset(cfg)
    rng = np.random.default_rng(seed)
    out = np.empty((n_images, Hr, Wr), np.float32)
    for i in range(n_images):
        eye = rng.uniform(-1.2, 1.2, 3)
        target = rng.uniform(-1.8, 1.8, 3)
        while np.linalg.norm(target - eye) < 0.5:
            target = rng.uniform(-1.8, 1.8, 3)
        color, _ = ds.render_frame(_lookat_c2w(eye, target))
        out[i] = np.asarray(color, np.float32).mean(-1)
    return out


def crop_batch(corpus: np.ndarray, rng, batch: int) -> np.ndarray:
    """(B, H_IMG, W_IMG) random windows; whole images for a full-frame
    corpus."""
    N, Hr, Wr = corpus.shape
    if (Hr, Wr) == (H_IMG, W_IMG):
        return corpus[rng.integers(0, N, batch)]
    out = np.empty((batch, H_IMG, W_IMG), corpus.dtype)
    for b in range(batch):
        i = rng.integers(0, N)
        y = rng.integers(0, Hr - H_IMG + 1)
        x = rng.integers(0, Wr - W_IMG + 1)
        out[b] = corpus[i, y:y + H_IMG, x:x + W_IMG]
    return out


def photometric_aug(imgs: np.ndarray, rng) -> np.ndarray:
    """Per-image gain and bias and gaussian noise, clipped to [0, 1]."""
    gain = rng.uniform(0.7, 1.3, (len(imgs), 1, 1)).astype(np.float32)
    bias = rng.uniform(-0.08, 0.08, (len(imgs), 1, 1)).astype(np.float32)
    noise = rng.normal(0.0, rng.uniform(0.0, 0.02),
                       imgs.shape).astype(np.float32)
    return np.clip(imgs * gain + bias + noise, 0.0, 1.0)


def sample_homography(rng, mag: float = 0.15) -> np.ndarray:
    """Random perspective homography by 4-corner jitter (output pixel ->
    source pixel), solved by DLT."""
    W, H = float(W_IMG), float(H_IMG)
    src = np.array([[0, 0], [W, 0], [0, H], [W, H]], np.float64)
    dst = src + rng.uniform(-mag, mag, (4, 2)) * [W, H]
    A = []
    for (x, y), (u, v) in zip(dst, src):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    Hm = Vt[-1].reshape(3, 3)
    return (Hm / Hm[2, 2]).astype(np.float32)


# --------------------------------------------------------------------------
# warps, labels and losses (torch)
# --------------------------------------------------------------------------

def warp_image(img: torch.Tensor, Hm: torch.Tensor) -> torch.Tensor:
    """Inverse warp: output pixel p samples the source at Hm @ p
    (bilinear, zeros outside)."""
    Hh, Ww = img.shape
    dev = img.device
    j, i = torch.meshgrid(torch.arange(Hh, dtype=torch.float32, device=dev),
                          torch.arange(Ww, dtype=torch.float32, device=dev),
                          indexing="ij")
    p = torch.stack([i, j, torch.ones_like(i)], 0).reshape(3, -1)
    q = Hm @ p
    x = q[0] / q[2]
    y = q[1] / q[2]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < Ww) & (yy >= 0) & (yy < Hh)
        v = img[yy.clamp(0, Hh - 1), xx.clamp(0, Ww - 1)]
        return torch.where(ok, v, torch.zeros_like(v))

    v = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
         + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)
    return v.reshape(Hh, Ww)


def detector_labels(gray: torch.Tensor, top_k: int = 300) -> torch.Tensor:
    """(Hc, Wc) labels in [0, 64]: the in-cell position (row-major 8x8) of
    the strongest NMS'd Harris corner among the top_k, or 64 (dustbin)."""
    score = harris_score(gray)
    ninf = torch.full_like(score, -float("inf"))
    nms = torch.where(_maxpool_nms(score, 4), score, ninf)
    vals = torch.sort(nms.reshape(-1), descending=True, stable=True)[0]
    vals = vals[:top_k]
    floor = torch.clamp(vals[0] * 1e-3, min=1e-12)
    nms = torch.where((nms >= vals[-1]) & (nms > floor), nms, ninf)
    blocks = nms.reshape(HC, 8, WC, 8).permute(0, 2, 1, 3).reshape(
        HC, WC, 64)
    pos = torch.argmax(blocks, dim=-1)
    has = blocks.max(dim=-1)[0] > -float("inf")
    return torch.where(has, pos, torch.full_like(pos, 64))


def _detector_ce(semi: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """semi (B, 65, Hc, Wc) logits, labels (B, Hc, Wc) -> (B,) mean CE."""
    logp = torch.log_softmax(semi, dim=1)
    lp = torch.gather(logp, 1, labels[:, None])[:, 0]
    return -lp.mean(dim=(1, 2))


def _cell_pairs(Hm: torch.Tensor):
    """For each homography (B, 3, 3): s (B, src, warp) 1 where the warp
    cell's centre lands within 8 px of the source cell's, and inb (B, 1,
    warp) 1 where it lands inside the source image."""
    dev = Hm.device
    j, i = torch.meshgrid(
        torch.arange(HC, dtype=torch.float32, device=dev) * 8 + 3.5,
        torch.arange(WC, dtype=torch.float32, device=dev) * 8 + 3.5,
        indexing="ij")
    p = torch.stack([i, j, torch.ones_like(i)], 0).reshape(3, -1)
    q = Hm @ p                                           # (B, 3, cells)
    qx = q[:, 0] / q[:, 2]
    qy = q[:, 1] / q[:, 2]
    sx = i.reshape(-1)
    sy = j.reshape(-1)
    d2 = (qx[:, None, :] - sx[None, :, None]) ** 2 \
        + (qy[:, None, :] - sy[None, :, None]) ** 2
    s = (d2 <= 64.0).to(torch.float32)
    inb = ((qx >= 0) & (qx < W_IMG) & (qy >= 0) & (qy < H_IMG)
           ).to(torch.float32)[:, None, :]
    return s, inb


def _descriptor_hinge(da, db, Hm, m_pos: float = 1.0, m_neg: float = 0.2,
                      lambda_d: float = 250.0) -> torch.Tensor:
    """da, db (B, 256, Hc, Wc) unit descriptors of the source and its
    warp; Hm (B, 3, 3) maps warp pixels to source pixels -> (B,) mean
    hinge over all (source cell, warp cell) pairs."""
    s, inb = _cell_pairs(Hm)
    B = da.shape[0]
    dot = da.reshape(B, 256, -1).transpose(1, 2) @ db.reshape(B, 256, -1)
    loss = (lambda_d * s * torch.relu(m_pos - dot)
            + (1.0 - s) * torch.relu(dot - m_neg)) * inb
    return loss.mean(dim=(1, 2))


def batch_loss(net: SuperPointNet, grays, warps, Hms, la, lb,
               lambda_desc: float = 1.0, m_pos: float = 1.0,
               m_neg: float = 0.2, lambda_d: float = 250.0):
    """The batch's mean loss (detector CE of both images + lambda_desc x
    descriptor hinge) and the mean detector and descriptor terms. grays,
    warps (B, H_IMG, W_IMG); Hms (B, 3, 3); la, lb (B, Hc, Wc) labels."""
    semi_a, da = net(grays[:, None])
    semi_b, db = net(warps[:, None])
    det = _detector_ce(semi_a, la) + _detector_ce(semi_b, lb)
    desc = _descriptor_hinge(da, db, Hms, m_pos, m_neg, lambda_d)
    return (det + lambda_desc * desc).mean(), det.mean(), desc.mean()


def make_batch(corpus, rng, batch: int, mag: float, augment: bool, device):
    """One training batch from the numpy draws: crops, homographies, their
    warps, the clean images' Harris labels, then the photometric
    augmentation of both. Returns (grays, warps, Hms, la, lb) on
    device."""
    clean = crop_batch(corpus, rng, batch)
    Hms = torch.as_tensor(np.stack([sample_homography(rng, mag)
                                    for _ in range(batch)]), device=device)
    clean_t = torch.as_tensor(clean, device=device)
    warps_clean = torch.stack([warp_image(clean_t[b], Hms[b])
                               for b in range(batch)])
    # labels from the clean images: the teacher sees no noise
    la = torch.stack([detector_labels(clean_t[b]) for b in range(batch)])
    lb = torch.stack([detector_labels(warps_clean[b])
                      for b in range(batch)])
    if augment:
        grays = torch.as_tensor(photometric_aug(clean, rng), device=device)
        warps = torch.as_tensor(photometric_aug(
            warps_clean.cpu().numpy(), rng), device=device)
    else:
        grays, warps = clean_t, warps_clean
    return grays, warps, Hms, la, lb


def train(steps: int = 2000, batch: int = 4, n_images: int = 64,
          lr: float = 1e-3, seed: int = 0, out: str | None = None,
          log_every: int = 100, match_run_scale: bool = True,
          augment: bool = True, m_pos: float = 1.0, m_neg: float = 0.2,
          lambda_d: float = 250.0, mag: float = 0.15,
          corpus: np.ndarray | None = None, device=None):
    """Adam steps on numpy-drawn batches from a random init seeded `seed`
    on `device` (the card unless the caller asks for the CPU); returns
    (net, corpus)."""
    from ..utils.device import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if corpus is None:
        print(f"rendering {n_images} synthetic views...")
        corpus = render_corpus(n_images, seed, match_run_scale)
    net = SuperPointNet(init_superpoint(
        torch.Generator().manual_seed(seed))).to(device)
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    t0 = time.time()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for it in range(steps):
            b = make_batch(corpus, rng, batch, mag, augment, device)
            loss, det, desc = batch_loss(net, *b, m_pos=m_pos, m_neg=m_neg,
                                         lambda_d=lambda_d)
            opt.zero_grad()
            loss.backward()
            opt.step()
            if it % log_every == 0 or it == steps - 1:
                print(f"step {it}: loss {float(loss):.4f} (det "
                      f"{float(det):.4f} desc {float(desc):.4f}) "
                      f"[{time.time() - t0:.0f}s]")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        save_superpoint_npz(out, net.params())
        print(f"saved {out}")
    return net, corpus


@torch.no_grad()
def evaluate(net: SuperPointNet, corpus, n_pairs: int = 8, seed: int = 1):
    """Match precision across known homographies: the share of two-way
    descriptor matches whose warp-mapped distance is under 4 px."""
    from ..frontend.features import (_sample_desc, _topk_keypoints,
                                     superpoint_forward)
    from ..frontend.matching import match_two_way

    rng = np.random.default_rng(seed)
    dev = next(net.parameters()).device

    def extract(gray):
        heat, desc_c = superpoint_forward(net, gray)
        score = torch.where(_maxpool_nms(heat, 4), heat,
                            torch.zeros_like(heat))
        kps, valid, _ = _topk_keypoints(score, 300, 4, 0.015)
        return kps, _sample_desc(desc_c, kps, H_IMG, W_IMG), valid

    ok = tot = 0
    for _ in range(n_pairs):
        g = torch.as_tensor(crop_batch(corpus, rng, 1)[0], device=dev)
        Hm = sample_homography(rng)
        w = warp_image(g, torch.as_tensor(Hm, device=dev))
        k1, d1, v1 = extract(g)
        k2, d2, v2 = extract(w)
        idx2, mvalid, _ = match_two_way(d2, v2, d1, v1, 0.7)
        m = mvalid.cpu().numpy()
        if m.sum() == 0:
            continue
        k2n = k2.cpu().numpy()[m]
        p = np.concatenate([k2n, np.ones((len(k2n), 1))], 1) @ Hm.T
        src = p[:, :2] / p[:, 2:3]
        k1m = k1.cpu().numpy()[idx2.cpu().numpy()[m]]
        d = np.linalg.norm(src - k1m, axis=1)
        ok += int((d < 4).sum())
        tot += len(d)
    return ok / max(tot, 1), tot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--n_images", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--m_pos", type=float, default=1.0)
    p.add_argument("--m_neg", type=float, default=0.2)
    p.add_argument("--lambda_d", type=float, default=250.0)
    p.add_argument("--mag", type=float, default=0.15)
    p.add_argument("--legacy_scale", action="store_true",
                   help="the coarse-texture 120x160 full-frame corpus")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", type=str,
                   default=os.path.join(os.path.dirname(__file__), "..", "..",
                                        "pretrained",
                                        "superpoint_synthetic.npz"))
    args = p.parse_args(argv)
    net, corpus = train(args.steps, args.batch, args.n_images, args.lr,
                        out=args.out,
                        match_run_scale=not args.legacy_scale,
                        augment=not args.no_augment, m_pos=args.m_pos,
                        m_neg=args.m_neg, lambda_d=args.lambda_d,
                        mag=args.mag, device=args.device)
    acc, tot = evaluate(net, corpus)
    print(f"homography match precision: {acc:.3f} over {tot} matches")


if __name__ == "__main__":
    main()
