"""Mesh extraction (the JAX reference's outputs/mesher.py, itself the
capability of upstream src/utils/Mesher.py).

Pipeline (get_mesh):
  1. a uniform grid over marching_cubes_bound, `resolution` cells on the
     longest axis (numpy axes as the reference's, points on the device)
  2. the field at the grid in `points_batch_size` chunks through
     render.renderer.eval_points on the system's device (density 100
     outside the AABB); the decoder is evaluated by
     models.decoders.decoder_apply under the snapshot's model config, so
     MLPConfig.fused runs K5 (room_bench's 257^3 grid: 34 launches).
     Grid nodes outside the TSDF hull get 100; with show_forecast
     (mesh_coarse_level) the grid is split seen / forecast / unseen by
     point_masks instead: forecast + 0.2, unseen -100
  3. the level set at meshing.level_set by the native marching-tetrahedra
     library (native/libmarching_tets.so through ctypes, built with make
     when absent), on the host as in the reference
  4. cleaning, on the host: faces whose three vertices no keyframe frustum
     sees are dropped (point_masks on the device: the forecast edge, the
     optional per-pixel depth_test, and the use-all-frames variant of the
     eval mesh), then connected components (the largest, or those above
     remove_small_geometry_threshold)
  5. vertex colours: 'direct_point_query' (the decoder at the vertices) or
     'render_ray_along_normal' (a short render through each vertex along
     its normal, the default); forecast vertices cyan
  6. vertices / scale; binary PLY in the reference's format, which its
     read_ply, tools/eval_recon.py and tools/cull_mesh.py read unchanged.

Periodic meshes are built by a MeshJob, a generator advanced a few device
chunks per frame, from a MeshSnapshot of the system; the final frame
builds `{idx}_mesh.ply`, `final_mesh.ply` and (meshing.eval_rec)
`final_mesh_eval_rec.ply` synchronously. write_ply, read_ply,
filter_mesh, cull_faces, clean_components and vertex_normals are copies
of the reference's numpy pieces (the port imports nothing of the JAX
package).
The reference pads each chunk to a power of two and the keyframe axis to
16 to bound its jit retraces; eager torch needs neither (the padded
chunk's zero points do enter depth_test's forecast gate, the maximum
sampled depth of the chunk, and are kept there).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.se3 import camera_from_tensor, to_homogeneous
from ..models.decoders import decoder_apply
from ..render.renderer import eval_points, render_rays
from .tsdf import scene_bound_hull

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "native")


def _load_native():
    lib_path = os.path.join(_NATIVE_DIR, "libmarching_tets.so")
    if not os.path.exists(lib_path):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.mt_extract.restype = ctypes.c_void_p
    lib.mt_extract.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mt_num_vertices.restype = ctypes.c_long
    lib.mt_num_vertices.argtypes = [ctypes.c_void_p]
    lib.mt_num_triangles.restype = ctypes.c_long
    lib.mt_num_triangles.argtypes = [ctypes.c_void_p]
    lib.mt_copy.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_long)]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None


def marching_tets(grid: np.ndarray, level: float):
    """The level set of a (Nx, Ny, Nz) scalar grid: (verts (V, 3) in
    grid-index coordinates, tris (T, 3) int64)."""
    global _LIB
    if _LIB is None:
        _LIB = _load_native()
    g = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = g.shape
    h = _LIB.mt_extract(g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        nx, ny, nz, ctypes.c_float(level))
    try:
        nv = _LIB.mt_num_vertices(h)
        nt = _LIB.mt_num_triangles(h)
        verts = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int64)
        if nv:
            _LIB.mt_copy(h, verts.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
                tris.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    finally:
        _LIB.mt_free(h)
    return verts, tris


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Binary little-endian PLY with optional uint8 vertex colours."""
    nv, nt = len(verts), len(tris)
    hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {nv}",
           "property float x", "property float y", "property float z"]
    if colors is not None:
        hdr += ["property uchar red", "property uchar green",
                "property uchar blue"]
    hdr += [f"element face {nt}", "property list uchar int vertex_indices",
            "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is not None:
            rec = np.empty(nv, np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
            rec["xyz"] = verts
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(np.asarray(verts, "<f4").tobytes())
        face = np.empty((nt, 13), np.uint8)
        face[:, 0] = 3
        face[:, 1:] = np.asarray(tris, "<i4").view(np.uint8).reshape(nt, 12)
        f.write(face.tobytes())


def read_ply(path: str):
    """Read back the PLYs write_ply writes: (verts, tris, colors | None)."""
    with open(path, "rb") as f:
        nv = nt = 0
        has_color = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nt = int(line.split()[-1])
            elif line == "property uchar red":
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            rec = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            data = np.frombuffer(f.read(nv * rec.itemsize), rec)
            verts, colors = data["xyz"].copy(), data["rgb"].copy()
        else:
            verts = np.frombuffer(f.read(nv * 12), "<f4").reshape(nv, 3).copy()
            colors = None
        frec = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        tris = np.frombuffer(f.read(nt * frec.itemsize), frec)["idx"].copy()
    return verts, tris, colors


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    n = np.zeros_like(verts)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(b - a, c - a)
    for k in range(3):
        np.add.at(n, tris[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def _drop_unreferenced(verts, tris):
    used = np.zeros(len(verts), bool)
    used[tris.reshape(-1)] = True
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(used.sum())
    return verts[used], remap[tris]


def filter_mesh(verts, tris, keep_verts):
    """Keep the faces whose three vertices survive; reindex."""
    remap = -np.ones(len(verts), np.int64)
    remap[keep_verts] = np.arange(keep_verts.sum())
    face_ok = keep_verts[tris].all(axis=1)
    return verts[keep_verts], remap[tris[face_ok]]


def cull_faces(verts, tris, drop_verts):
    """Remove faces whose three vertices are ALL in the drop set, then the
    unreferenced vertices."""
    face_drop = drop_verts[tris].all(axis=1)
    return _drop_unreferenced(verts, tris[~face_drop])


def face_areas(verts, tris):
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


def clean_components(verts, tris, get_largest: bool, area_threshold: float):
    """Connected components over vertex-shared faces: keep the largest by
    area (get_largest) or those with area > area_threshold."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    V = len(verts)
    if V == 0 or len(tris) == 0:
        return verts, tris
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], 0)
    adj = sp.coo_matrix((np.ones(len(e), np.int8), (e[:, 0], e[:, 1])),
                        shape=(V, V))
    n_comp, labels = connected_components(adj, directed=False)
    f_label = labels[tris[:, 0]]
    comp_area = np.bincount(f_label, weights=face_areas(verts, tris),
                            minlength=n_comp)
    if get_largest:
        keep = f_label == int(comp_area.argmax())
    else:
        keep = comp_area[f_label] > area_threshold
    return _drop_unreferenced(verts, tris[keep])


def _drain(gen):
    """Run a work generator to completion, returning its return value."""
    while True:
        try:
            next(gen)
        except StopIteration as s:
            return s.value


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _KFView:
    """The keyframes a mesh reads: their count, a copy of their camera
    tensors (bundle adjustment rewrites them in place) and their depth
    slots (written once, at insertion)."""

    def __init__(self, kf):
        self._n = len(kf)
        self.est_c2w = kf.est_c2w[: self._n].clone()
        self.depth = kf.depth[: self._n]

    def __len__(self):
        return self._n


class MeshSnapshot:
    """Everything a mesh build reads from the system, taken when the job
    starts, so a mesh built a few chunks per frame reflects the field and
    poses of its trigger frame while the system advances. `model_cfg`
    replaces the system's (MLPConfig.fused selects K5)."""

    def __init__(self, slam, model_cfg=None):
        self.model_cfg = model_cfg if model_cfg is not None else slam.model_cfg
        self.params = {k: v.detach().clone()
                       for k, v in slam.decoder.named_parameters()}
        self.rcfg = slam.rcfg
        self.bound = slam.bound.clone()
        self.device = slam.bound.device
        self.H, self.W = slam.H, slam.W
        self.fx, self.fy, self.cx, self.cy = slam.fx, slam.fy, slam.cx, slam.cy
        self.keyframes = _KFView(slam.keyframes)
        self.estimate_c2w_list = np.array(slam.estimate_c2w_list)

    def field(self, x: torch.Tensor) -> torch.Tensor:
        return decoder_apply(self.model_cfg, self.params, x)


class MeshJob:
    """An in-flight mesh build: a generator that yields after each bounded
    unit of work, advanced by Mesher.maybe_mesh from the frame loop."""

    def __init__(self, gen, out_file: str):
        self.gen = gen
        self.out_file = out_file
        self.done = False
        self.result = None

    def tick(self, budget: int = 1) -> bool:
        """Advance up to `budget` units; True when the job finished."""
        for _ in range(budget):
            try:
                next(self.gen)
            except StopIteration as s:
                self.done = True
                self.result = s.value
                return True
        return False


class Mesher:
    def __init__(self, cfg, slam=None, points_batch_size: int = 500000):
        m = cfg["meshing"]
        self.resolution = m["resolution"]
        self.level_set = m["level_set"]
        self.clean_mesh = m["clean_mesh"]
        self.clean_mesh_bound_scale = m["clean_mesh_bound_scale"]
        self.color_method = m["color_mesh_extraction_method"]
        self.mesh_freq = cfg["mapping"]["mesh_freq"]
        self.eval_rec = m["eval_rec"]
        self.depth_test = m.get("depth_test", False)
        self.get_largest_components = m.get("get_largest_components", False)
        self.remove_small_geometry_threshold = m.get(
            "remove_small_geometry_threshold", 0.2)
        self.mesh_coarse_level = m.get("mesh_coarse_level", False)
        self.points_batch_size = points_batch_size
        self.bound = np.array(cfg["mapping"]["marching_cubes_bound"],
                              np.float32) * cfg["scale"]
        self.scale = cfg["scale"]
        self.verbose = cfg["verbose"]
        # periodic meshes advance `chunks_per_frame` units per frame;
        # `async: false` builds them inline; `final_mesh: false` skips the
        # end-of-run mesh (as the reference)
        self.async_mesh = m.get("async", True)
        self.chunks_per_frame = m.get("chunks_per_frame", 4)
        self.final_mesh = m.get("final_mesh", True)
        self._job: Optional[MeshJob] = None
        # one record per build: its file and seconds by stage (grid,
        # masks_hull, extract, color), device work synchronised at each
        # stage's end
        self.builds: list = []

    # -- grid ---------------------------------------------------------------
    def get_grid_uniform(self):
        """Axes of the uniform grid over the marching-cubes bound."""
        b = self.bound
        step = float((b[:, 1] - b[:, 0]).max()) / self.resolution
        return [np.arange(b[i, 0], b[i, 1] + 1e-6, step, dtype=np.float32)
                for i in range(3)]

    @staticmethod
    def grid_points(axes, device) -> torch.Tensor:
        ax = [torch.as_tensor(a, device=device) for a in axes]
        return torch.stack(torch.meshgrid(*ax, indexing="ij"),
                           -1).reshape(-1, 3)

    def _eval_grid_gen(self, view, pts: torch.Tensor):
        """Density at (N, 3) points, one yield per chunk."""
        out = torch.empty(pts.shape[0], device=pts.device)
        for i in range(0, pts.shape[0], self.points_batch_size):
            with torch.no_grad():
                out[i:i + self.points_batch_size] = eval_points(
                    view.field, pts[i:i + self.points_batch_size],
                    view.bound)[:, 3]
            yield
        return out

    def eval_grid(self, view, pts: torch.Tensor) -> torch.Tensor:
        return _drain(self._eval_grid_gen(view, pts))

    # -- masks --------------------------------------------------------------
    def point_masks(self, slam, points, use_all_frames: bool = False,
                    cur_idx: int = None):
        """Synchronous wrapper over _point_masks_gen (numpy bool masks)."""
        seen, forecast, unseen = _drain(self._point_masks_gen(
            slam, torch.as_tensor(np.asarray(points, np.float32)),
            use_all_frames, cur_idx))
        return seen.cpu().numpy(), forecast.cpu().numpy(), \
            unseen.cpu().numpy()

    def _point_masks_gen(self, view, points: torch.Tensor,
                         use_all_frames: bool = False, cur_idx: int = None):
        """(seen, forecast, unseen) of the points by the keyframe frustums
        (reference point_masks: seen = projection inside the image in
        front of the camera, forecast = inside a 1000-pixel extended edge;
        depth constraint: with depth_test |proj - bilinear depth| < 2.4 for
        seen and proj < the chunk's largest sampled depth for forecast,
        otherwise proj < 1.1 * the keyframe's largest depth). With
        use_all_frames the poses are every estimated pose up to cur_idx and
        no depth constraint applies (the eval mesh). One yield per chunk."""
        n = points.shape[0]
        if use_all_frames:
            end = (cur_idx + 1) if cur_idx is not None else len(
                view.estimate_c2w_list)
            c2ws = np.asarray(view.estimate_c2w_list[:end], np.float32)
            c2ws = c2ws[np.abs(c2ws).sum(axis=(1, 2)) > 0]
            use_depth = False
        else:
            n_kf = len(view.keyframes)
            c2ws = to_homogeneous(camera_from_tensor(
                view.keyframes.est_c2w[:n_kf])).cpu().numpy()
            use_depth = True
        dev = view.keyframes.depth.device
        points = points.to(dev)
        if len(c2ws) == 0:
            z = torch.zeros(n, dtype=torch.bool, device=dev)
            return ~z, z, z
        w2c = torch.as_tensor(np.linalg.inv(c2ws).astype(np.float32),
                              device=dev)
        if use_depth:
            depths = view.keyframes.depth[:len(c2ws)]
            max_depths = depths.reshape(len(c2ws), -1).amax(1) * 1.1
        depth_test = use_depth and self.depth_test
        H, W = view.H, view.W
        fx, fy, cx, cy = view.fx, view.fy, view.cx, view.cy

        def project(p, T):
            cam = p @ T[:3, :3].T + T[:3, 3]
            z = cam[:, 2] + 1e-8
            u = (fx * (-cam[:, 0]) + cx * z) / z
            v = (fy * cam[:, 1] + cy * z) / z
            return cam, u, v

        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        forecast = torch.zeros(n, dtype=torch.bool, device=dev)
        chunk = self.points_batch_size
        for i in range(0, n, chunk):
            p = points[i:i + chunk]
            m = p.shape[0]
            padded = (1 << max(m - 1, 1).bit_length()) > m
            s_acc = torch.zeros(m, dtype=torch.bool, device=dev)
            f_acc = torch.zeros(m, dtype=torch.bool, device=dev)
            for k in range(w2c.shape[0]):
                cam, u, v = project(p, w2c[k])
                front = cam[:, 2] + 1e-8 < 0
                s = (u > 0) & (u < W) & (v > 0) & (v < H) & front
                f = ((u > -1000) & (u < W + 1000) & (v > -1000)
                     & (v < H + 1000) & front)
                if use_depth:
                    proj = -cam[:, 2]
                    if depth_test:
                        ds = _bilinear_zeros(depths[k], u, v)
                        dmax = ds.max()
                        if padded:      # the reference's zero padding
                            _, u0, v0 = project(p[:1] * 0, w2c[k])
                            dmax = torch.maximum(dmax, _bilinear_zeros(
                                depths[k], u0, v0)[0])
                        f = f & (proj < dmax)
                        s = s & (proj < ds + 2.4) & (ds - 2.4 < proj)
                    else:
                        s = s & (proj < max_depths[k])
                        f = f & (proj < max_depths[k])
                s_acc |= s
                f_acc |= f
            seen[i:i + m] = s_acc
            forecast[i:i + m] = f_acc
            yield
        forecast &= ~seen
        return seen, forecast, ~(seen | forecast)

    def bound_hull(self, view):
        """The TSDF-fused convex-hull scene bound: a containment test, or
        None without keyframes or hull."""
        n_kf = len(view.keyframes)
        if n_kf == 0:
            return None
        c2ws = to_homogeneous(camera_from_tensor(
            view.keyframes.est_c2w[:n_kf]))
        return scene_bound_hull(view.keyframes.depth[:n_kf], c2ws, view.fx,
                                view.fy, view.cx, view.cy,
                                view.bound.cpu().numpy(),
                                scale=self.clean_mesh_bound_scale)

    # -- colour -------------------------------------------------------------
    def _color_gen(self, view, verts: np.ndarray, tris: np.ndarray):
        n = len(verts)
        dev = view.bound.device
        rgb = torch.zeros(n, 3, device=dev)
        if self.color_method == "direct_point_query":
            pts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
            for i in range(0, n, self.points_batch_size):
                with torch.no_grad():
                    rgb[i:i + self.points_batch_size] = eval_points(
                        view.field, pts[i:i + self.points_batch_size],
                        view.bound)[:, :3]
                yield
        else:               # render_ray_along_normal (the iMAP* default)
            normals = vertex_normals(verts, tris)
            ro = torch.as_tensor((verts - 0.1 * normals).astype(np.float32),
                                 device=dev)
            rd = torch.as_tensor(normals.astype(np.float32), device=dev)
            chunk = 65536
            for i in range(0, n, chunk):
                o, d = ro[i:i + chunk], rd[i:i + chunk]
                with torch.no_grad():
                    rgb[i:i + chunk] = render_rays(
                        view.field, view.rcfg, o, d, view.bound,
                        torch.full((o.shape[0],), 0.1 * 1.2, device=dev))[2]
                yield
        return np.clip(rgb.cpu().numpy() * 255, 0, 255).astype(np.uint8)

    # -- main ---------------------------------------------------------------
    def get_mesh(self, slam, out_file: str, clean: Optional[bool] = None,
                 show_forecast: Optional[bool] = None,
                 use_all_frames: bool = False, cur_idx: int = None):
        """Build a mesh synchronously (from slam, or from a MeshSnapshot)."""
        view = slam if isinstance(slam, MeshSnapshot) else MeshSnapshot(slam)
        return _drain(self._mesh_gen(view, out_file, clean, show_forecast,
                                     use_all_frames, cur_idx))

    def _mesh_gen(self, view: MeshSnapshot, out_file: str,
                  clean: Optional[bool] = None,
                  show_forecast: Optional[bool] = None,
                  use_all_frames: bool = False, cur_idx: int = None):
        """The mesh pipeline as a generator; each yield is one bounded unit
        of work (a device chunk, or one poll of the extraction thread)."""
        show_forecast = (self.mesh_coarse_level if show_forecast is None
                         else show_forecast)
        dev = view.device
        timings = {"grid": 0.0, "masks_hull": 0.0, "extract": 0.0,
                   "color": 0.0}
        self.builds.append(dict(file=out_file, seconds=timings))
        t0 = time.time()
        axes = self.get_grid_uniform()
        pts = self.grid_points(axes, dev)
        if show_forecast:
            seen, forecast, _ = yield from self._point_masks_gen(
                view, pts, use_all_frames=use_all_frames, cur_idx=cur_idx)
            _sync(dev)
            t1 = time.time()
            timings["masks_hull"] += t1 - t0
            occ = torch.full((pts.shape[0],), -100.0, device=dev)
            occ[seen] = yield from self._eval_grid_gen(view, pts[seen])
            occ[forecast] = (yield from self._eval_grid_gen(
                view, pts[forecast])) + 0.2
            _sync(dev)
            timings["grid"] += time.time() - t1
        else:
            occ = yield from self._eval_grid_gen(view, pts)
            _sync(dev)
            t1 = time.time()
            timings["grid"] += t1 - t0
            hull = self.bound_hull(view)
            yield
            if hull is not None:
                # out-of-hull nodes become the occupied sentinel: no
                # free-space surface forms there
                occ[~hull(pts)] = 100.0
            _sync(dev)
            timings["masks_hull"] += time.time() - t1
        t2 = time.time()
        occ = occ.cpu().numpy().reshape(len(axes[0]), len(axes[1]),
                                        len(axes[2]))
        del pts
        mc_out = {}

        def _mc():
            mc_out["vt"] = marching_tets(occ, self.level_set)

        th = threading.Thread(target=_mc, daemon=True)
        th.start()
        while th.is_alive():
            th.join(timeout=0.05)
            yield
        verts_idx, tris = mc_out["vt"]
        timings["extract"] += time.time() - t2
        if len(verts_idx) == 0:
            print(f"Mesher: no surface extracted at level {self.level_set}")
            return None
        origin = np.array([axes[0][0], axes[1][0], axes[2][0]])
        verts = origin + verts_idx * (axes[0][1] - axes[0][0])

        t3 = time.time()
        if clean if clean is not None else self.clean_mesh:
            if show_forecast:
                hull = self.bound_hull(view)
                yield
                if hull is not None:
                    inside = hull(torch.as_tensor(verts, device=dev))
                    verts, tris = cull_faces(verts, tris,
                                             ~inside.cpu().numpy())
            else:
                seen, _, _ = yield from self._point_masks_gen(
                    view, torch.as_tensor(verts, device=dev),
                    use_all_frames=use_all_frames, cur_idx=cur_idx)
                verts, tris = cull_faces(verts, tris, ~seen.cpu().numpy())
            t4 = time.time()
            timings["masks_hull"] += t4 - t3
            if len(tris):
                verts, tris = clean_components(
                    verts, tris, self.get_largest_components,
                    self.remove_small_geometry_threshold * self.scale
                    * self.scale)
            timings["extract"] += time.time() - t4
        if len(verts) == 0 or len(tris) == 0:
            print("Mesher: all vertices culled")
            return None

        t5 = time.time()
        colors = yield from self._color_gen(view, verts, tris)
        if show_forecast:
            _, forecast_v, _ = yield from self._point_masks_gen(
                view, torch.as_tensor(verts, device=dev),
                use_all_frames=use_all_frames, cur_idx=cur_idx)
            colors[forecast_v.cpu().numpy()] = np.array([0, 255, 255],
                                                        np.uint8)
        timings["color"] += time.time() - t5
        verts_out = verts / self.scale
        write_ply(out_file, verts_out.astype(np.float32), tris, colors)
        if self.verbose:
            print(f"Mesher: wrote {out_file} ({len(verts)} verts, "
                  f"{len(tris)} tris)")
        return verts_out, tris, colors

    # -- scheduling ---------------------------------------------------------
    def flush(self, slam=None):
        """Drain any in-flight mesh job to completion."""
        if self._job is not None:
            while not self._job.tick(64):
                pass
            self._job = None

    def maybe_mesh(self, slam, idx: int):
        """Frame-loop hook: start a mesh job at the mesh cadence and
        advance any in-flight one by a bounded budget; the final frame
        builds synchronously (the reference's cadence)."""
        final = idx == slam.n_img - 1 and self.final_mesh
        mesh_frame = (idx % self.mesh_freq == 0 and idx != 0
                      and idx % slam.ecfg.every_frame == 0)
        mesh_dir = os.path.join(slam.output, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        if mesh_frame and not final:
            self.flush(slam)
            out = os.path.join(mesh_dir, f"{idx:05d}_mesh.ply")
            job = MeshJob(self._mesh_gen(MeshSnapshot(slam), out,
                                         cur_idx=idx), out)
            if self.async_mesh:
                self._job = job
                job.tick(self.chunks_per_frame)
            else:
                while not job.tick(64):
                    pass
        elif self._job is not None:
            if self._job.tick(self.chunks_per_frame):
                self._job = None
        if final:
            self.flush(slam)
            out = os.path.join(mesh_dir, f"{idx:05d}_mesh.ply")
            self.get_mesh(slam, out, cur_idx=idx)
            if os.path.exists(out):
                shutil.copy(out, os.path.join(mesh_dir, "final_mesh.ply"))
            if self.eval_rec:
                # eval mesh: all-frame masks, no forecast
                self.get_mesh(slam, os.path.join(
                    mesh_dir, "final_mesh_eval_rec.ply"), clean=True,
                    show_forecast=False, use_all_frames=True, cur_idx=idx)


def _bilinear_zeros(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample of img (H, W) at (u, v), zeros outside."""
    H, W = img.shape
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i, v0i = u0.long(), v0.long()
    flat = img.reshape(-1)

    def tap(vi, ui):
        ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        idx = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
        return torch.where(ok, flat[idx], torch.zeros_like(fu))

    return (tap(v0i, u0i) * (1 - fu) * (1 - fv)
            + tap(v0i, u0i + 1) * fu * (1 - fv)
            + tap(v0i + 1, u0i) * (1 - fu) * fv
            + tap(v0i + 1, u0i + 1) * fu * fv)
