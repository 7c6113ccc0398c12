"""The port's dataset readers against the JAX reference's readers, on
small sequences each test writes in the dataset's own layout with cv2
(JPEG colour, 16-bit PNG depth, the pose files).

Bound: the readers' index, colour, depth and pose bit for bit."""

import os
import sys

import cv2
import numpy as np
import pytest

from pointnerf_slam_tpu.io.datasets import get_dataset as j_get_dataset
from pointnerf_slam_torch.io.datasets import get_dataset
from tests.torch_threads import share_cores

share_cores()

H, W = 24, 32
CAM = {"H": H, "W": W, "fx": 30.0, "fy": 31.0, "cx": 15.5, "cy": 11.5,
       "png_depth_scale": 1000.0, "crop_edge": 0}


def cfg_for(name, folder, scale=1.0, **cam):
    return {"data": {"dataset": name, "input_folder": str(folder)},
            "cam": dict(CAM, **cam), "scale": scale}


def frames(n, seed=0):
    """n (BGR u8 colour, u16 depth) pairs with smooth structure (JPEG)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        base = np.stack([np.sin(x / (3 + c) + i) * np.cos(y / (4 + c))
                         for c in range(3)], -1)
        color = np.clip(128 + 100 * base + rng.normal(0, 3, base.shape),
                        0, 255).astype(np.uint8)
        depth = (1500 + 400 * np.sin(x / 7.0 + y / 5.0 + i)
                 + rng.integers(0, 50, (H, W))).astype(np.uint16)
        depth[0, :3] = 0                       # holes stay holes
        out.append((color, depth))
    return out


def poses(n, seed=1):
    """n c2w poses (rotation about a tilted axis, drifting translation)."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(
            [0.1 * i, 0.05 + 0.02 * i, -0.03 * i]).as_matrix()
        T[:3, 3] = [0.3 * i, -0.1 * i, 1.0] + rng.normal(0, 0.01, 3)
        out.append(T)
    return out


def assert_same_reader(cfg, n_expected):
    ours, ref = get_dataset(cfg), j_get_dataset(cfg)
    assert len(ours) == len(ref) == n_expected
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a[0] == b[0] == i
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    return ours


def write_replica(root, n=3):
    res = root / "results"
    res.mkdir(parents=True)
    for i, (c, d) in enumerate(frames(n)):
        cv2.imwrite(str(res / f"frame{i:06d}.jpg"), c)
        cv2.imwrite(str(res / f"depth{i:06d}.png"), d)
    with open(root / "traj.txt", "w") as f:
        for T in poses(n):
            f.write(" ".join(f"{v:.10f}" for v in T.reshape(-1)) + "\n")


@pytest.mark.parametrize("cam", [
    {}, {"crop_edge": 3}, {"crop_size": [16, 20]},
    {"distortion": [0.05, -0.02, 0.001, 0.002, 0.0]},
    {"crop_size": [16, 20], "crop_edge": 2,
     "distortion": [0.1, 0.0, 0.0, 0.0, 0.0]}])
def test_replica_reader_matches_reference(tmp_path, cam):
    write_replica(tmp_path)
    ds = assert_same_reader(cfg_for("replica", tmp_path, 2.0, **cam), 3)
    # the pose preprocessing: columns 1 and 2 negated, translation scaled
    T = poses(3)[1].copy()
    T[:3, 1:3] *= -1
    T[:3, 3] *= 2.0
    np.testing.assert_allclose(ds[1][3], T.astype(np.float32), atol=1e-6)


def test_scannet_reader_matches_reference(tmp_path):
    fr = tmp_path / "frames"
    for sub in ("color", "depth", "pose"):
        (fr / sub).mkdir(parents=True)
    # numeric order, not lexicographic: 10 sorts after 2
    for k, ((c, d), T) in enumerate(zip(frames(4), poses(4))):
        i = (0, 1, 2, 10)[k]
        cv2.imwrite(str(fr / "color" / f"{i}.jpg"), c)
        cv2.imwrite(str(fr / "depth" / f"{i}.png"), d)
        with open(fr / "pose" / f"{i}.txt", "w") as f:
            f.write("\n".join(" ".join(f"{v:.9f}" for v in row)
                              for row in T))
    assert_same_reader(cfg_for("scannet", tmp_path), 4)


@pytest.mark.parametrize("with_log", [True, False])
def test_azure_reader_matches_reference(tmp_path, with_log):
    for sub in ("color", "depth", "scene"):
        (tmp_path / sub).mkdir()
    for i, (c, d) in enumerate(frames(3)):
        cv2.imwrite(str(tmp_path / "color" / f"{i:05d}.jpg"), c)
        cv2.imwrite(str(tmp_path / "depth" / f"{i:05d}.png"), d)
    if with_log:
        with open(tmp_path / "scene" / "trajectory.log", "w") as f:
            for i, T in enumerate(poses(3)):
                f.write(f"{i} {i} {i + 1}\n")
                for row in T:
                    f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
    ds = assert_same_reader(cfg_for("azure", tmp_path), 3)
    if not with_log:
        np.testing.assert_array_equal(ds[2][3], np.eye(4, dtype=np.float32))


def test_cofusion_exr_depth_raises_as_the_reference(tmp_path):
    (tmp_path / "colour").mkdir()
    (tmp_path / "depth_noise").mkdir()
    for i, (c, _) in enumerate(frames(2)):
        cv2.imwrite(str(tmp_path / "colour" / f"Color{i:04d}.png"), c)
        (tmp_path / "depth_noise" / f"Depth{i:04d}.exr").write_bytes(b"")
    cfg = cfg_for("cofusion", tmp_path)
    ours, ref = get_dataset(cfg), j_get_dataset(cfg)
    assert len(ours) == len(ref) == 2
    np.testing.assert_array_equal(np.stack(ours.poses), np.stack(ref.poses))
    errs = []
    for ds in (ours, ref):
        with pytest.raises(ImportError) as e:
            ds[0]
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def write_tum(root, n=6, drop=3, jitter=0.004, seed=0):
    """TUM layout at 30 Hz: rgb/, depth/ (16-bit), rgb.txt, depth.txt
    (three comment lines each) and groundtruth.txt at 100 Hz with
    quaternions; frame `drop` has no depth within 0.08 s."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    t0 = 1305031102.175304
    rgb, dep = [], []
    for i, (c, d) in enumerate(frames(n)):
        t = t0 + i / 30.0 + rng.uniform(-jitter, jitter)
        td = t + rng.uniform(-0.01, 0.01) + (0.2 if i == drop else 0.0)
        cv2.imwrite(str(root / "rgb" / f"{t:.6f}.png"), c)
        cv2.imwrite(str(root / "depth" / f"{td:.6f}.png"), d)
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
    head = "# list\n# file: 'x.bag'\n# timestamp filename\n"
    (root / "rgb.txt").write_text(head + "\n".join(rgb) + "\n")
    (root / "depth.txt").write_text(head + "\n".join(dep) + "\n")
    lines = ["# ground truth trajectory", "# file: 'x.bag'",
             "# timestamp tx ty tz qx qy qz qw"]
    for k in range(int(n / 30.0 * 100) + 10):
        t = t0 - 0.03 + k / 100.0
        q = Rotation.from_rotvec([0.02 * k, 0.5 - 0.01 * k, 0.1]).as_quat()
        p = [1.0 + 0.01 * k, -0.5 + 0.003 * k, 1.4]
        lines.append(f"{t:.4f} " + " ".join(f"{v:.6f}" for v in [*p, *q]))
    (root / "groundtruth.txt").write_text("\n".join(lines) + "\n")


def test_tum_reader_matches_reference(tmp_path):
    write_tum(tmp_path)
    cfg = cfg_for("tumrgbd", tmp_path, png_depth_scale=5000.0)
    ds = assert_same_reader(cfg, len(j_get_dataset(cfg)))
    # the dropped frame is gone; poses are relative to the first, which
    # is the identity seen through the y/z flip
    assert 3 <= len(ds) <= 5
    np.testing.assert_array_equal(
        ds[0][3], np.diag([1, -1, -1, 1]).astype(np.float32))
    assert all("rgb/" in p for p in ds.color_paths)


def test_reader_without_cv2_raises_naming_the_file(tmp_path, monkeypatch):
    write_tum(tmp_path)
    ds = get_dataset(cfg_for("tumrgbd", tmp_path, png_depth_scale=5000.0))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=f"{ds.color_paths[0]}.*cv2"):
        ds[0]


def test_real_data_configs_get_past_the_reader():
    """Every shipped real-data config names a dataset the port reads."""
    from pointnerf_slam_torch.io.config import load_config
    from pointnerf_slam_torch.io.datasets import dataset_dict
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seen = set()
    for sub in ("Replica", "ScanNet", "TUM_RGBD", "CoFusion", "Apartment",
                "Own"):
        for fn in sorted(os.listdir(os.path.join(root, "configs", sub))):
            cfg = load_config(os.path.join(root, "configs", sub, fn))
            assert cfg["data"]["dataset"] in dataset_dict, fn
            seen.add(cfg["data"]["dataset"])
    assert seen == {"replica", "scannet", "tumrgbd", "cofusion", "azure"}


@pytest.mark.parametrize("bound", ["args", "mesh", "default"])
def test_prep_own_data_matches_reference(tmp_path, monkeypatch, bound):
    """The own-data config emitter writes the reference's YAML, and the
    YAML's `azure` dataset reads."""
    import json
    import sys
    from pointnerf_slam_tpu.tools import prep_own_data as j_prep
    from pointnerf_slam_torch.outputs.mesher import write_ply
    from pointnerf_slam_torch.tools import prep_own_data as t_prep
    intr = tmp_path / "intr.json"
    intr.write_text(json.dumps({"width": W, "height": H,
                                "intrinsic_matrix": [30.0, 0, 0, 0, 31.0, 0,
                                                     15.5, 11.5, 1]}))
    extra = []
    if bound == "args":
        extra = ["--bound", "-1.5", "2.25", "-3", "3", "0.123", "4.5"]
    elif bound == "mesh":
        v = np.random.default_rng(0).uniform(-2, 3, (50, 3))
        write_ply(str(tmp_path / "m.ply"), v.astype(np.float32),
                  np.array([[0, 1, 2]], np.int32))
        extra = ["--mesh", str(tmp_path / "m.ply")]
    out = {}
    for name in ("port", "ref"):
        argv = ["--intrinsic_json", str(intr), "--input_folder",
                str(tmp_path / "seq"), "--output", str(tmp_path / "run"),
                "--config_out", str(tmp_path / f"{name}.yaml")] + extra
        if name == "port":
            t_prep.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["prep_own_data"] + argv)
            j_prep.main()
        out[name] = (tmp_path / f"{name}.yaml").read_text()
    assert out["port"] == out["ref"]
    assert "dataset: azure" in out["port"]
