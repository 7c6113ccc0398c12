"""RGB-D sequence readers (the JAX reference's io/datasets.py): Replica,
ScanNet, Azure (own data), CoFusion and TUM RGB-D, with the reference's
pose preprocessing (c2w[:3, 1] and c2w[:3, 2] negated, translation times
scale; TUM poses relative to the first, colour, depth and pose lists
associated by timestamp) and per-frame preprocessing (BGR to RGB / 255
colour, depth / png_depth_scale * scale, colour-only undistortion,
crop_size resize, crop_edge crop), plus the procedural `synthetic` room.

Host numpy + cv2, as in the reference; frames are handed over as numpy.
cv2 is imported at the first frame read (an ImportError naming the file
when it is missing). CoFusion's EXR depth needs OpenEXR, imported on
demand as in the reference.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from .synthetic import SyntheticDataset


def get_dataset(cfg: dict, args=None, scale: Optional[float] = None):
    scale = cfg["scale"] if scale is None else scale
    name = cfg["data"]["dataset"]
    return dataset_dict[name](cfg, args, scale)


def as_intrinsics_matrix(intr):
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intr
    return K


def require_cv2(path: str):
    """cv2, or an ImportError naming the file being read."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading a dataset frame needs cv2 "
                          f"(opencv-python), which is not installed") from e
    return cv2


class BaseDataset:
    def __init__(self, cfg, args, scale):
        self.name = cfg["data"]["dataset"]
        self.scale = scale
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        c = cfg["cam"]
        self.H, self.W = c["H"], c["W"]
        self.fx, self.fy, self.cx, self.cy = c["fx"], c["fy"], c["cx"], c["cy"]
        self.distortion = (np.array(c["distortion"])
                           if "distortion" in c else None)
        self.crop_size = c.get("crop_size")
        self.crop_edge = c["crop_edge"]
        input_folder = cfg["data"]["input_folder"]
        if args is not None and getattr(args, "input_folder", None):
            input_folder = args.input_folder
        self.input_folder = input_folder
        self.poses: List[np.ndarray] = []

    def __len__(self):
        return self.n_img

    def __getitem__(self, index):
        color_path = self.color_paths[index]
        depth_path = self.depth_paths[index]
        cv2 = require_cv2(color_path)
        color_data = cv2.imread(color_path)
        if ".png" in depth_path:
            depth_data = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
        elif ".exr" in depth_path:
            depth_data = read_exr_depth(depth_path)
        if self.distortion is not None:
            K = as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy])
            # undistortion applies to colour only (reference behaviour)
            color_data = cv2.undistort(color_data, K, self.distortion)

        color_data = cv2.cvtColor(color_data, cv2.COLOR_BGR2RGB)
        color_data = color_data.astype(np.float32) / 255.0
        depth_data = depth_data.astype(np.float32) / self.png_depth_scale
        H, W = depth_data.shape
        color_data = cv2.resize(color_data, (W, H))
        depth_data = depth_data * self.scale

        if self.crop_size is not None:
            ch, cw = self.crop_size
            color_data = cv2.resize(color_data, (cw, ch),
                                    interpolation=cv2.INTER_LINEAR)
            depth_data = cv2.resize(depth_data, (cw, ch),
                                    interpolation=cv2.INTER_NEAREST)

        edge = self.crop_edge
        if edge > 0:
            color_data = color_data[edge:-edge, edge:-edge]
            depth_data = depth_data[edge:-edge, edge:-edge]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return index, color_data, depth_data, pose.astype(np.float32)


def read_exr_depth(path):
    """CoFusion EXR depth (the Y channel); OpenEXR imported on demand."""
    import Imath
    import OpenEXR
    f = OpenEXR.InputFile(path)
    dw = f.header()["dataWindow"]
    size = (dw.max.x - dw.min.x + 1, dw.max.y - dw.min.y + 1)
    if "Y" not in f.header()["channels"]:
        raise RuntimeError(f"EXR at {path} has no Y (depth) channel")
    y = np.frombuffer(f.channel("Y", Imath.PixelType(Imath.PixelType.FLOAT)),
                      dtype=np.float32)
    return np.reshape(y, (size[1], size[0]))


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


class Replica(BaseDataset):
    def __init__(self, cfg, args, scale):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self._load_poses(f"{self.input_folder}/traj.txt")

    def _load_poses(self, path):
        with open(path) as f:
            lines = f.readlines()
        for i in range(self.n_img):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            self.poses.append(_flip_yz(c2w).astype(np.float32))


class Azure(BaseDataset):
    def __init__(self, cfg, args, scale):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        self.n_img = len(self.color_paths)
        self._load_poses(
            os.path.join(self.input_folder, "scene", "trajectory.log"))

    def _load_poses(self, path):
        if os.path.exists(path):
            with open(path) as f:
                content = f.readlines()
            for i in range(0, len(content), 5):
                c2w = np.array(list(map(
                    float,
                    ("".join(content[i + 1:i + 5])).strip().split()))
                ).reshape(4, 4)
                self.poses.append(_flip_yz(c2w).astype(np.float32))
        else:
            self.poses = [np.eye(4, dtype=np.float32)
                          for _ in range(self.n_img)]


class ScanNet(BaseDataset):
    def __init__(self, cfg, args, scale):
        super().__init__(cfg, args, scale)
        self.input_folder = os.path.join(self.input_folder, "frames")

        def by_num(x):
            return int(os.path.basename(x)[:-4])

        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "color", "*.jpg")),
            key=by_num)
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth", "*.png")),
            key=by_num)
        self._load_poses(os.path.join(self.input_folder, "pose"))
        self.n_img = len(self.color_paths)

    def _load_poses(self, path):
        pose_paths = sorted(glob.glob(os.path.join(path, "*.txt")),
                            key=lambda x: int(os.path.basename(x)[:-4]))
        for p in pose_paths:
            with open(p) as f:
                c2w = np.array([list(map(float, ln.split(" ")))
                                for ln in f.readlines()]).reshape(4, 4)
            self.poses.append(_flip_yz(c2w).astype(np.float32))


class CoFusion(BaseDataset):
    def __init__(self, cfg, args, scale):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "colour", "*.png")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth_noise", "*.exr")))
        self.n_img = len(self.color_paths)
        # coordinate frame unalignable -> identity proxies (ATE aligns anyway)
        self.poses = [np.eye(4, dtype=np.float32) for _ in range(self.n_img)]


class TUM_RGBD(BaseDataset):
    def __init__(self, cfg, args, scale):
        super().__init__(cfg, args, scale)
        self.color_paths, self.depth_paths, self.poses = self._loadtum(
            self.input_folder, frame_rate=32)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    def _loadtum(self, datapath, frame_rate=-1):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        else:
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = self._pose_from_quat(pose_vecs[k])
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(_flip_yz(c2w).astype(np.float32))
        return images, depths, poses

    @staticmethod
    def _pose_from_quat(pvec):
        from scipy.spatial.transform import Rotation
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "cofusion": CoFusion,
    "azure": Azure,
    "tumrgbd": TUM_RGBD,
    "synthetic": SyntheticDataset,
}
