#!/usr/bin/env python3
"""Where the card's and the CPU's RANSAC part ways in one bootstrap solve
given the same hypotheses.

  python scripts/ransac_card_vs_cpu.py --seed 14 --frame 15 --out DIR
  python scripts/ransac_card_vs_cpu.py --compare DIR/ransac_s14_f15.npz

Both forms run the SuperPoint front-end's bootstrap attempts of
configs/Synthetic/room_bench_weak.yaml (pretrained/superpoint_synthetic.npz;
frames 5, 10, 15 and 20 against frame 0, as chip_smoke.sp_decisions; the
RANSAC hypotheses drawn from a CPU generator seeded --seed, as
scripts/twoview_draws_probe.py --cpu_draws does) and keep the inputs of
frame --frame's RANSAC: the matched normalized keypoints, the valid mask,
the hypotheses and the threshold. The first form runs on the card and
saves those inputs with the card's stage outputs. The second runs the
same attempts on the CPU, prints how far the CPU's inputs are from the
card's, then recomputes every stage on the CPU from the card's inputs and
prints how far each stage is from the card's: the 256 hypotheses' E (up
to sign), their MSAC scores, the 8 diverse starts, and the final pose and
inlier count.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KEYS = ("kpn_ref", "kpn_cur", "match_valid", "hyp_idx")


def capture(device: str, seed: int, frame: int) -> dict:
    """The inputs of frame `frame`'s RANSAC on `device` (numpy)."""
    import numpy as np
    import torch
    import chip_smoke as S
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.frontend import fused_twoview as TV
    from pointnerf_slam_torch.frontend.frontend import SparseFrontend
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.io.datasets import get_dataset
    cfg = load_config("configs/Synthetic/room_bench_weak.yaml")
    cfg["superpoint_weights"] = S.SP_NPZ
    reader = get_dataset(cfg)
    frames = {i: reader[i] for i in (0,) + tuple(S.SP_DECISIONS)}
    c = cfg["cam"]
    fe = SparseFrontend(cfg, c["H"], c["W"], c["fx"], c["fy"], c["cx"],
                        c["cy"], device=device, draws=Draws(
                            torch.Generator(device="cpu").manual_seed(seed)))
    calls = []
    ransac, draw = TV.estimate_relative_pose_ransac, TV.draw_hypotheses

    def recording(kpn_ref, kpn_cur, match_valid, hyp_idx, thresh=3e-4):
        calls.append({"kpn_ref": kpn_ref, "kpn_cur": kpn_cur,
                      "match_valid": match_valid, "hyp_idx": hyp_idx,
                      "thresh": thresh})
        return ransac(kpn_ref, kpn_cur, match_valid, hyp_idx, thresh)

    TV.estimate_relative_pose_ransac = recording
    TV.draw_hypotheses = lambda g, mv: draw(g, mv.cpu()).to(mv.device)
    try:
        got, _ = S.sp_decisions(fe, frames)
    finally:
        TV.estimate_relative_pose_ransac, TV.draw_hypotheses = ransac, draw
    print(f"{device}, seed {seed}: decisions {got}", flush=True)
    k = list(S.SP_DECISIONS).index(frame)
    if k >= len(calls):
        raise SystemExit(f"no RANSAC ran at frame {frame}: {got}")
    out = {key: calls[k][key].detach().cpu().numpy() for key in KEYS}
    out["thresh"] = np.float64(calls[k]["thresh"])
    return out


def stages(inp: dict, device: str) -> dict:
    """Each stage of epipolar.estimate_relative_pose_ransac on `device`."""
    import torch
    from pointnerf_slam_torch.frontend import epipolar as E
    kr, kc, mv, hyp = (torch.as_tensor(inp[k], device=device) for k in KEYS)
    thresh = float(inp["thresh"])
    th2 = thresh ** 2
    Es = E._eight_point(kc[hyp], kr[hyp])
    d2 = E._sampson(Es, kc, kr)
    msac = torch.where(mv[None, :], torch.relu(th2 - d2),
                       torch.zeros_like(d2)).sum(1)
    # the diverse starts, as estimate_relative_pose_ransac picks them
    t_all = torch.linalg.svd(Es)[0][:, :, 2]
    score, top = msac.clone(), []
    for _ in range(E.TOPK):
        b = torch.argmax(score)
        top.append(int(b))
        close = (t_all @ t_all[b]).abs() > math.cos(math.radians(25.0))
        score = torch.where(close, torch.full_like(score, -float("inf")),
                            score)
    Trc, inl, n = E.estimate_relative_pose_ransac(kr, kc, mv, hyp, thresh)
    return {"E": Es.cpu().numpy(), "msac": msac.cpu().numpy(),
            "top": top, "Trc": Trc.cpu().numpy(), "n_inliers": int(n)}


def compare(path: str) -> int:
    import numpy as np
    z = np.load(path)
    inp = {k: z[k] for k in KEYS + ("thresh",)}
    seed, frame = int(z["seed"]), int(z["frame"])
    cpu_in = capture("cpu", seed, frame)
    for k in KEYS:
        a, b = inp[k], cpu_in[k]
        same = a.shape == b.shape and np.array_equal(a, b)
        d = float(np.abs(a.astype(np.float64) - b).max()) \
            if a.shape == b.shape else float("nan")
        print(f"inputs {k}: card {a.shape}, CPU {b.shape}, "
              f"{'identical' if same else f'max abs diff {d:.3e}'}")
    card = {"E": z["E"], "msac": z["msac"],
            "top": [int(i) for i in z["top"]], "Trc": z["Trc"],
            "n_inliers": int(z["n_inliers"])}
    cpu = stages(inp, "cpu")
    dE = np.minimum(np.abs(card["E"] - cpu["E"]).max((1, 2)),
                    np.abs(card["E"] + cpu["E"]).max((1, 2)))
    print(f"E of {len(dE)} hypotheses (up to sign): max diff "
          f"{dE.max():.3e}, median {np.median(dE):.3e}; beyond 1e-4: "
          f"{int((dE > 1e-4).sum())}, beyond 1e-2: {int((dE > 1e-2).sum())}")
    dm = np.abs(card["msac"] - cpu["msac"])
    print(f"MSAC scores: max diff {dm.max():.3e} (largest score "
          f"{card['msac'].max():.3e}); best hypothesis card "
          f"{int(np.argmax(card['msac']))}, CPU {int(np.argmax(cpu['msac']))}")
    print(f"diverse starts: card {card['top']}, CPU {cpu['top']}")
    print(f"final: inliers card {card['n_inliers']}, CPU {cpu['n_inliers']};"
          f" pose max diff {np.abs(card['Trc'] - cpu['Trc']).max():.3e}")
    return 0


def main() -> int:
    import numpy as np
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--frame", type=int, default=15)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    inp = capture("cuda", args.seed, args.frame)
    res = stages(inp, "cuda")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"ransac_s{args.seed}_f{args.frame}.npz")
    np.savez(path, seed=args.seed, frame=args.frame, top=np.array(
        res.pop("top")), **inp, **res)
    print(f"card: {res['n_inliers']} inliers; wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
