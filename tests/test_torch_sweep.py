"""scripts/sweep_superpoint_torch.py, the port's SuperPoint sweep, on the
CPU: its own copy of the weak pipeline's config equals
tests/test_weak_pipeline.py's (which the script may not import: it
imports the JAX package), and a one-candidate run at a handful of steps
writes the scores' JSON and the candidate under --out_dir while
pretrained/superpoint_synthetic.npz stays byte for byte as it was."""

import hashlib
import json
import os
import sys

from tests.test_weak_pipeline import weak_cfg
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import sweep_superpoint_torch as S  # noqa: E402


def digest(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_weak_cfg_equals_the_weak_pipeline_test():
    assert S.weak_cfg() == weak_cfg()


def test_one_candidate_run(tmp_path, monkeypatch, capsys):
    """One candidate, 1 training step on 2 corpus images, its bootstrap
    metric on frames 0..5 (the bootstrap falls at 5)."""
    pinned = os.path.join(REPO, S.PROMOTE_TO)
    before = digest(pinned)
    monkeypatch.setattr(S, "GRID", S.GRID[:1])
    monkeypatch.setattr(S, "SIZES", {True: (1, 2), False: (1, 2)})
    monkeypatch.setattr(S, "BOOT_FRAMES", 6)
    out = tmp_path / "sweep"
    assert S.main(["--quick", "--device", "cpu", "--out_dir", str(out)]) == 0
    with open(out / "sp_sweep.json") as fh:
        rows = json.load(fh)
    assert len(rows) == 1
    row = rows[0]
    assert {"name", "homography", "tri", "ckpt"} <= set(row)
    assert row["name"] == "run_scale"
    assert 0.0 <= row["homography"] <= 1.0
    assert row["tri"] >= 0.0
    assert os.path.exists(row["ckpt"])
    assert os.path.dirname(row["ckpt"]) == str(out)
    assert f"promote with: cp {row['ckpt']} {S.PROMOTE_TO}" in \
        capsys.readouterr().out
    assert digest(pinned) == before
