"""scripts/flagship_seeds_torch.py's --steps series and --ckpt_freq.

- The step series on hand-made front-end and scale telemetry: the true
  step's arithmetic, step_d's ratio to it, the gate's median over the
  last 10 accepted steps (none below 3), a rejected solve kept as
  rejected with its step (not dropped, and not entering the history),
  and the prior / solve / refined steps from the previous tracked
  frame's refined centre.
- --ckpt_freq sets the logger's frequency in memory: the YAML and the
  loaded config keep theirs."""

import os
import sys

import numpy as np
import pytest
import yaml

from tests.test_weak_pipeline import weak_cfg
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import flagship_seeds_torch as seeds  # noqa: E402


def telemetry(steps, reject_at=None):
    """Front-end and scale telemetry of tracked frames 20, 25, ... (a
    bootstrap at 15), frame f's solve step_d = steps[i]; at reject_at the
    step gate rejects a 0.5 m step. Centres move along x."""
    fe = [{"idx": 15, "n_matches": 300, "n_inliers": 250}]
    st, c = [], 0.0
    for i, s in enumerate(steps):
        idx = 20 + 5 * i
        fe.append({"idx": idx, "ref_idx": 15, "n_inliers": 100})
        if idx == reject_at:
            fe.append({"idx": idx, "rejected_step": 0.5,
                       "step_median": 0.01})
            st.append({"idx": idx, "ref_idx": 15, "c_prior": [c, 0, 0],
                       "c_solve": None, "c_refined": [c + 0.002, 0, 0]})
            c += 0.002
            continue
        fe[-1]["step_d"] = s
        st.append({"idx": idx, "ref_idx": 15, "c_prior": [c + 0.01, 0, 0],
                   "c_solve": [c + s, 0, 0],
                   "c_refined": [c + 0.9 * s, 0, 0]})
        c += 0.9 * s
    return fe, st


def test_step_series_arithmetic():
    gt = np.zeros((100, 3))
    gt[:, 0] = 0.01 * np.arange(100)          # 0.05 m per tracked frame
    gt[:, 1] = 0.002 * np.arange(100) ** 1.5
    steps = [0.01 * (i + 1) for i in range(13)]
    fe, st = telemetry(steps, reject_at=50)
    rows = seeds.step_series(fe, st, gt, 5)
    assert [r["idx"] for r in rows] == [20 + 5 * i for i in range(13)]
    for r in rows:
        true = float(np.linalg.norm(gt[r["idx"]] - gt[r["idx"] - 5]))
        assert r["true_step"] == pytest.approx(true)
    accepted = [r for r in rows if r["rejected"] is None]
    for r in accepted:
        assert r["ratio"] == pytest.approx(r["step_d"] / r["true_step"])
    rej = next(r for r in rows if r["idx"] == 50)
    assert rej["rejected"] == "rejected_step" and rej["step_d"] is None
    assert rej["rejected_step"] == 0.5 and rej["ratio"] is None
    # the gate's median: none below three accepted steps, then the median
    # of the last ten accepted (the rejected 0.5 m never enters)
    hist = []
    for r in rows:
        want = float(np.median(hist[-10:])) if len(hist) >= 3 else None
        assert r["gate_median"] == (pytest.approx(want) if want is not None
                                    else None), r["idx"]
        if r["step_d"] is not None:
            hist.append(r["step_d"])
    assert rows[0]["gate_median"] is None and rows[2]["gate_median"] is None
    assert rows[12]["gate_median"] == pytest.approx(
        np.median([s for s in steps[:12] if s != steps[6]][-10:]))
    # prior / solve / refined steps from the previous refined centre
    prev = {r["idx"]: r for r in st}
    for r in rows[1:]:
        c0 = np.asarray(prev[r["idx"] - 5]["c_refined"])
        for k in ("prior", "solve", "refined"):
            c = prev[r["idx"]][f"c_{k}"]
            if c is None:
                assert r[f"{k}_step"] is None
                continue
            d = float(np.linalg.norm(np.asarray(c) - c0))
            assert r[f"{k}_step"] == pytest.approx(d)
            assert r[f"{k}_ratio"] == pytest.approx(d / r["true_step"])
    assert rows[0]["prior_step"] is None       # no tracked frame before
    lines = seeds.step_lines(3, rows)
    assert len(lines) == 1 + len(rows)
    assert "REJECTED rejected_step 500.00" in lines[1 + 6]


def test_ckpt_freq_leaves_the_yaml_alone(tmp_path, monkeypatch):
    cfg = weak_cfg()
    cfg["data"].update(frame_cache_dir="", n_frames=12)
    cfg["mapping"]["ckpt_freq"] = 2
    path = tmp_path / "weak.yaml"
    path.write_text(yaml.safe_dump(cfg))
    before = path.read_text()
    monkeypatch.chdir(tmp_path)
    slam, out = seeds.seed_system(str(path), 3, "cpu", None, ckpt_freq=5)
    assert slam.logger.ckpt_freq == 5
    assert slam.cfg["mapping"]["ckpt_freq"] == 2
    assert path.read_text() == before
    assert out == os.path.join("output", "flagship_seed3")
    slam2, _ = seeds.seed_system(str(path), 3, "cpu", None)
    assert slam2.logger.ckpt_freq == 2
