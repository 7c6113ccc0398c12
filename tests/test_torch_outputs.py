"""The port's run outputs against the JAX reference: the drawing
functions bit for bit, the writers' files pixel for pixel on a scripted
loss log and trajectory (and their cv2 drawing where matplotlib is
absent), the render panels, render_img, the printer and logger, the live
window without a GUI, the offline replay viewer, the writers wired into
a run, and run.py's flags through the supervisor."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pointnerf_slam_tpu.outputs import draw as JDR
from pointnerf_slam_torch.outputs import draw as TDR
from tests.torch_threads import share_cores

share_cores()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


# ---------------------------------------------------------------- drawing

@pytest.mark.parametrize("seed", [0, 1])
def test_drawing_functions_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(30, 40, 3))
    img2 = (rng.uniform(size=(26, 35, 3)) * 255).astype(np.uint8)
    gray = rng.uniform(size=(30, 40))
    pts = rng.uniform(-3, 43, (25, 2))
    lines = rng.uniform(-5, 45, (9, 4))
    cols = (rng.uniform(size=(25, 3)) * 255).astype(np.uint8)
    trails = [rng.uniform(0, 40, (k, 2)) for k in (0, 1, 4, 13)]
    for name, args in [
            ("draw_points", (img, pts, 2)), ("draw_points", (gray, pts)),
            ("draw_lines", (img2, lines, 2)), ("draw_lines", (img, lines)),
            ("combine_images_horizontally", (img, img2)),
            ("combine_images_vertically", (img2, gray)),
            ("draw_feature_matches", (img, img2, pts[:9], pts[9:18])),
            ("draw_feature_matches", (img, img2, pts[:9], pts[9:18], False)),
            ("draw_feature_trails", (img, trails))]:
        a = getattr(TDR, name)(*args)
        b = getattr(JDR, name)(*args)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(
        TDR.draw_points(img, pts, colors=cols),
        JDR.draw_points(img, pts, colors=cols))


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_save_image_equals_the_reference_file(tmp_path, ext):
    img = (np.random.default_rng(2).uniform(size=(20, 33, 3)) * 255).astype(
        np.uint8)
    TDR.save_image(str(tmp_path / f"t.{ext}"), img)
    JDR.save_image(str(tmp_path / f"j.{ext}"), img)
    np.testing.assert_array_equal(pixels(tmp_path / f"t.{ext}"),
                                  pixels(tmp_path / f"j.{ext}"))
    if ext == "jpg":
        assert (tmp_path / "t.jpg").read_bytes() == \
            (tmp_path / "j.jpg").read_bytes()


# ---------------------------------------------------------------- writers

class MP:
    def __init__(self, p, bad=False):
        self.pt = np.asarray(p, float)
        self.is_bad = bad


def scripted(n=16):
    """The same run history for both packages: the reference's loss_log,
    and the port's frame_log (map_losses concatenated per frame with their
    event lengths; tracking first / best)."""
    rng = np.random.default_rng(3)
    est = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    est[:, 0, 3] = np.linspace(0, 1, n)
    est[:, 2, 3] = np.sin(np.linspace(0, 3, n))
    gt = est.copy()
    gt[:, 2, 3] += 0.1
    fe = SimpleNamespace(map=SimpleNamespace(points=[
        MP([0, 0, 1]), MP([1, 0, 2]), MP([0.5, 1, 1.5], bad=True)]))
    mapping, tracking, frame_log = [], [], []
    for idx in range(n):
        rec = {"idx": idx}
        if idx % 5 == 0:
            evs = [np.sort(rng.uniform(1, 100, k))[::-1].astype(np.float32)
                   for k in (3, 4)]
            mapping += [(idx, jnp.asarray(e)) for e in evs]
            rec["map_losses"] = torch.as_tensor(np.concatenate(evs))
            rec["map_sizes"] = [len(e) for e in evs]
        if idx > 0:
            f, b = rng.uniform(10, 20), rng.uniform(1, 10)
            tracking.append((idx, jnp.float32(f), jnp.float32(b)))
            rec["track_first"] = torch.tensor(f, dtype=torch.float32)
            rec["track_best"] = torch.tensor(b, dtype=torch.float32)
        frame_log.append(rec)
    j = SimpleNamespace(estimate_c2w_list=est, gt_c2w_list=gt, frontend=fe,
                        loss_log={"mapping": mapping, "tracking": tracking})
    t = SimpleNamespace(estimate_c2w_list=est, gt_c2w_list=gt, frontend=fe,
                        frame_log=frame_log)
    return j, t


def test_loss_log_maps_the_frame_log_onto_the_reference_layout():
    j, t = scripted()
    got = TDR.loss_log(t)
    assert [(i, list(l)) for i, l in got["mapping"]] == \
        [(i, list(np.asarray(l))) for i, l in j.loss_log["mapping"]]
    assert got["tracking"] == [(i, float(f), float(b))
                               for i, f, b in j.loss_log["tracking"]]


def test_trajectory_and_loss_writers_pixel_for_pixel(tmp_path):
    j, t = scripted()
    for pkg, mod, slam in (("j", JDR, j), ("t", TDR, t)):
        tw = mod.TrajectoryWriter(5, str(tmp_path / pkg / "traj_vis"))
        lw = mod.LossCurveWriter(5, str(tmp_path / pkg / "loss_vis"))
        for idx in range(16):
            tw.vis(slam, idx)
            lw.vis(slam, idx)
    for sub in ("traj_vis", "loss_vis"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub))
        assert names == (["00005.png", "00010.png", "00015.png"]
                         if sub == "traj_vis" else ["loss_curves.png"])
        for n in names:
            np.testing.assert_array_equal(pixels(tmp_path / "t" / sub / n),
                                          pixels(tmp_path / "j" / sub / n))


def test_match_visualizer_pixel_for_pixel(tmp_path):
    H, W = 24, 32
    imgs = {0: np.random.default_rng(0).uniform(size=(H, W, 3)),
            5: np.random.default_rng(1).uniform(size=(H, W, 3))}

    class Reader:
        def __getitem__(self, i):
            return i, imgs[i], None, None

    fe = SimpleNamespace(last_debug={
        "ref_idx": 0, "cur_idx": 5,
        "kps_ref": np.array([[3.0, 4.0], [8.0, 9.0], [20.0, 2.0]]),
        "kps_cur": np.array([[4.0, 5.0], [9.0, 10.0], [22.0, 3.0]]),
        "accept": np.array([True, False, True])})
    slam = SimpleNamespace(frontend=fe, frame_reader=Reader())
    for pkg, mod in (("j", JDR), ("t", TDR)):
        mv = mod.MatchVisualizer(5, str(tmp_path / pkg))
        mv.vis(slam, 4)
        mv.vis(slam, 5)
    assert os.listdir(tmp_path / "t") == ["00005.jpg"]
    assert (tmp_path / "t" / "00005.jpg").read_bytes() == \
        (tmp_path / "j" / "00005.jpg").read_bytes()


def test_writers_draw_with_cv2_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed the writers draw the same data
    with cv2 into the same files."""
    monkeypatch.setattr(TDR, "pyplot", lambda: None)
    _, t = scripted()
    TDR.TrajectoryWriter(5, str(tmp_path / "traj_vis")).vis(t, 10)
    TDR.LossCurveWriter(5, str(tmp_path / "loss_vis")).vis(t, 10)
    a = pixels(tmp_path / "traj_vis" / "00010.png")
    b = pixels(tmp_path / "loss_vis" / "loss_curves.png")
    assert a.shape == (424, 400, 3) and b.shape == (424, 800, 3)
    assert (a != 255).any() and (b != 255).any()


# ------------------------------------------------------- render panels

def small_field(seed=0):
    from pointnerf_slam_tpu.models.decoders import MLPConfig as JCfg
    from pointnerf_slam_tpu.models.decoders import init_mlp
    from pointnerf_slam_torch.models.decoders import (IMAPDecoder,
                                                      MLPConfig,
                                                      params_from_jax)
    jcfg = JCfg(dim=3, c_dim=0, color=True, hidden_size=32, skips=(),
                n_blocks=2)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_mlp(jax.random.PRNGKey(seed), jcfg))
    dec = IMAPDecoder(MLPConfig(hidden_size=32, n_blocks=2))
    dec.load_state_dict(params_from_jax(tree))
    return jcfg, tree, dec


CAM = dict(H=12, W=16, fx=10.0, fy=10.0, cx=7.5, cy=5.5)
BOUND = np.array([[-2.0, 2.0]] * 3, np.float32)
C2W = np.array([[1, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, 1.0],
                [0, 0, 0, 1]], np.float32)


@pytest.mark.parametrize("with_depth,chunk,n_imp", [
    (True, 50, 0), (False, 64, 0), (True, 16384, 8), (False, 50, 8)])
def test_render_img_matches_reference(with_depth, chunk, n_imp):
    """render_img against the reference's at 12 x 16 (float32 decoder), in
    ray chunks that do not divide the image: depth, variance and colour
    rtol 1e-4 on every pixel without importance samples; with them on
    >= 95% of the pixels and 1e-2 of the image's scale everywhere (the
    inverse CDF's cumsum
    is summed in each package's order, and where the CDF is steep a
    sample moves by a few mm, as tests/test_torch_render.py bounds it)."""
    from pointnerf_slam_tpu.render import renderer as JR
    from pointnerf_slam_torch.render import renderer as TR
    jcfg, tree, dec = small_field()
    gt = np.random.default_rng(4).uniform(0.5, 2.5, (12, 16)).astype(
        np.float32) if with_depth else None
    rj = JR.RenderConfig(N_samples=16, N_importance=n_imp)
    rt = TR.RenderConfig(N_samples=16, N_importance=n_imp)
    dj, vj, cj = JR.render_img(tree, jcfg, rj, **CAM, c2w=C2W, bound=BOUND,
                               gt_depth=gt, chunk=chunk)
    dt, vt, ct = TR.render_img(dec, rt, **CAM, c2w=C2W,
                               bound=torch.as_tensor(BOUND), gt_depth=gt,
                               chunk=chunk)
    assert dt.shape == (12, 16) and ct.shape == (12, 16, 3)
    assert not dt.requires_grad
    for a, b in ((dt, dj), (vt, vj), (ct, cj)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).reshape(192, -1).max(1)
        tol = (1e-4 * np.abs(b).reshape(192, -1).max(1)
               + 1e-4 * np.abs(b).max())
        if n_imp == 0:
            assert (err <= tol).all(), err.max()
        else:
            assert np.mean(err > tol) <= 0.05
            assert err.max() < 1e-2 * np.abs(b).max()


@pytest.mark.parametrize("plain", [False, True])
def test_visualizer_writes_its_panel(tmp_path, monkeypatch, plain):
    from pointnerf_slam_torch.outputs.visualizer import Visualizer
    from pointnerf_slam_torch.render.renderer import RenderConfig
    if plain:
        monkeypatch.setattr(TDR, "pyplot", lambda: None)
    _, _, dec = small_field(1)
    slam = SimpleNamespace(decoder=dec, rcfg=RenderConfig(N_samples=8,
                                                          N_importance=4),
                           bound=torch.as_tensor(BOUND), nice=False,
                           c_grid={}, **CAM)
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.5, 2.5, (12, 16)).astype(np.float32)
    color = rng.uniform(size=(12, 16, 3)).astype(np.float32)
    v = Visualizer(5, str(tmp_path / "mapping_vis"))
    v.vis(slam, 3, depth, color, C2W)
    v.vis(slam, 5, torch.as_tensor(depth), torch.as_tensor(color), C2W)
    assert os.listdir(tmp_path / "mapping_vis") == ["00005.jpg"]
    img = pixels(tmp_path / "mapping_vis" / "00005.jpg")
    if plain:       # 2 x 3 tiles of 12 x 16 under 24-pixel titles
        assert img.shape == (2 * (24 + 12), 3 * 16, 3)
    else:           # the reference's 12 x 6 inch figure at 100 dpi, cropped
        assert img.shape[0] > 300 and img.shape[1] > 600


# ------------------------------------------------------------ utilities

def test_timer_printer_and_logger(tmp_path, capsys):
    from pointnerf_slam_torch.utils import Printer, get_logger
    Printer.green("printer ok")
    assert "\033[92mprinter ok\033[0m" in capsys.readouterr().out
    log = get_logger("port-test", file=str(tmp_path / "x.log"))
    log.info("hello")
    assert "port-test - INFO - hello" in (tmp_path / "x.log").read_text()


def test_live_viewer_disables_itself_headless(tmp_path, monkeypatch):
    from pointnerf_slam_torch.outputs.live_view import LiveViewer
    monkeypatch.delenv("DISPLAY", raising=False)
    v = LiveViewer(str(tmp_path), freq=1)
    assert not v.enabled
    est = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    v.vis(SimpleNamespace(estimate_c2w_list=est, gt_c2w_list=est), 2)


def test_replay_viewer_matches_the_reference(tmp_path):
    """python -m pointnerf_slam_torch.visualizer against the root
    visualizer.py on the same run directory: the same vis_replay frames,
    pixel for pixel."""
    from pointnerf_slam_torch.outputs.mesher import write_ply
    from pointnerf_slam_torch.visualizer import main
    rng = np.random.default_rng(6)
    n = 12
    est = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    est[:, :3, 3] = rng.normal(size=(n, 3)).cumsum(0) * 0.1
    verts = rng.uniform(-1, 1, (40, 3))
    for pkg in ("j", "t"):
        d = tmp_path / pkg
        os.makedirs(d / "ckpts")
        os.makedirs(d / "mesh")
        np.savez(d / "ckpts" / "00011.npz", idx=11, estimate_c2w_list=est,
                 gt_c2w_list=est + 0.01)
        write_ply(str(d / "mesh" / "00005_mesh.ply"), verts,
                  np.array([[0, 1, 2]]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    subprocess.run([sys.executable, os.path.join(REPO, "visualizer.py"),
                    "--output", str(tmp_path / "j"), "--every", "5"],
                   check=True, env=env, capture_output=True)
    main(["--output", str(tmp_path / "t"), "--every", "5"])
    names = sorted(os.listdir(tmp_path / "t" / "vis_replay"))
    assert names == ["00000.png", "00005.png", "00010.png"]
    for nm in names:
        np.testing.assert_array_equal(
            pixels(tmp_path / "t" / "vis_replay" / nm),
            pixels(tmp_path / "j" / "vis_replay" / nm))


# --------------------------------------------------------------- wiring

def test_run_writes_the_output_folders(tmp_path):
    """A sensor-depth run with outputs.attach_outputs at vis_freq 2 writes
    mapping_vis, tracking_vis, traj_vis and loss_vis (matches_vis is weak
    mode's: test_match_visualizer_pixel_for_pixel), and the loss curves
    read the run's own losses."""
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.outputs import attach_outputs
    from tests.test_engine import tiny_cfg
    cfg = tiny_cfg(data={"n_frames": 5, "output": str(tmp_path)},
                   mapping={"vis_freq": 2, "iters": 6, "iters_first": 10,
                            "ckpt_freq": 500},
                   tracking={"vis_freq": 2, "iters": 3},
                   meshing={"resolution": 32})
    slam = PointNeRFSLAM(cfg, device="cpu")
    attach_outputs(slam)
    assert slam.match_visualizer is None      # no front-end
    slam.run()
    assert sorted(os.listdir(tmp_path / "mapping_vis")) == \
        ["00002.jpg", "00004.jpg"]
    assert sorted(os.listdir(tmp_path / "tracking_vis")) == \
        ["00002.jpg", "00004.jpg"]
    assert sorted(os.listdir(tmp_path / "traj_vis")) == \
        ["00002.png", "00004.png"]
    assert os.listdir(tmp_path / "loss_vis") == ["loss_curves.png"]
    log = TDR.loss_log(slam)
    assert [i for i, _ in log["mapping"]] == [0, 2, 2, 2, 4, 4, 4]
    assert [i for i, _, _ in log["tracking"]] == [1, 2, 3, 4]


def test_run_flags_reach_the_supervised_attempts(tmp_path, monkeypatch):
    """--input_folder, --n_frames (and its alias --max_frames), --profile
    and --live_vis are threaded through the supervisor's child attempts."""
    from pointnerf_slam_torch import run as R
    cmds = []
    ck = str(tmp_path / "ckpts" / "00004.npz")

    def fake_run(cmd, env=None):
        cmds.append(cmd)
        return SimpleNamespace(returncode=0)

    monkeypatch.setattr(R.subprocess, "run", fake_run)
    monkeypatch.setattr(R, "latest_checkpoint", lambda out: ck if cmds
                        else None)
    args = SimpleNamespace(
        config=os.path.join(REPO, "configs/Synthetic/room_bench_weak.yaml"),
        input_folder=str(tmp_path / "in"), n_frames=5, device="cpu",
        output=str(tmp_path), profile=str(tmp_path / "trace"),
        live_vis=True, frames_per_attempt=0, max_restarts=1, no_eval=True,
        resume=None)
    assert R.supervise(args) == 0
    cmd = cmds[0]
    for flag, val in (("--input_folder", args.input_folder),
                      ("--n_frames", "5"), ("--profile", args.profile)):
        assert cmd[cmd.index(flag) + 1] == val
    assert "--live_vis" in cmd
    for alias in ("--n_frames", "--max_frames"):
        a = R.build_parser().parse_args(["c.yaml", alias, "7"])
        assert a.n_frames == 7 and a.input_folder is None
