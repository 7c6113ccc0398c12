"""2D diagnostic drawing and the run's offline writers.

Drawing (numpy only, so a headless run needs neither cv2 nor a GUI): filled
circles, line segments by dense parametric sampling, side-by-side and
stacked canvases, two-view match panels and keypoint trails, in a fixed
12-colour palette cycled per match. The same functions as the JAX
reference's outputs/draw.py, pixel for pixel.

Writers, each called from the engine loop as `vis(slam, idx)`:
  - MatchVisualizer: {output}/matches_vis/{idx:05d}.jpg, the front-end's
    two-view matches (its last_debug record) at tracking.vis_freq;
  - TrajectoryWriter: {output}/traj_vis/{idx:05d}.png, a top-down (x, z)
    view of the estimated and gt camera trails and the front-end's map
    points, at mapping.vis_freq;
  - LossCurveWriter: {output}/loss_vis/loss_curves.png, the mapping loss
    per mapper event (start, end) and the tracking loss per tracked frame
    (first, best), at mapping.vis_freq.
Figures are drawn as the reference draws them, with matplotlib's Agg
backend, where matplotlib is installed. Where it is not (a GPU host
need not have it), the same data are drawn with cv2 instead
(plain_image_panel, plain_line_plot: colour-mapped tiles and polylines
with titles, same file names), and the first figure says so once. Images
are written with PIL, as matplotlib's imsave writes them.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [170, 110, 40],
], np.uint8)


def _as_u8_rgb(img: np.ndarray) -> np.ndarray:
    """Accept float [0,1] or uint8, gray or rgb; return (H, W, 3) uint8."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return np.ascontiguousarray(a[..., :3])


def draw_points(img, pts, radius: int = 3, colors=None) -> np.ndarray:
    """Filled circles at (N, 2) pixel coords (x, y)."""
    out = _as_u8_rgb(img).copy()
    H, W = out.shape[:2]
    pts = np.asarray(pts)
    if len(pts) == 0:
        return out
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (dx * dx + dy * dy) <= radius * radius
    offs = np.stack([dx[disk], dy[disk]], -1)  # (M, 2) x,y offsets
    for k, (x, y) in enumerate(pts[:, :2]):
        c = _PALETTE[k % len(_PALETTE)] if colors is None \
            else np.asarray(colors[k], np.uint8)
        xx = np.clip(int(round(x)) + offs[:, 0], 0, W - 1)
        yy = np.clip(int(round(y)) + offs[:, 1], 0, H - 1)
        out[yy, xx] = c
    return out


def draw_lines(img, line_edges, radius: int = 1, colors=None) -> np.ndarray:
    """Line segments ((N, 4): x1,y1,x2,y2) by dense parametric sampling."""
    out = _as_u8_rgb(img).copy()
    H, W = out.shape[:2]
    edges = np.asarray(line_edges, np.float32).reshape(-1, 4)
    for k, (x1, y1, x2, y2) in enumerate(edges):
        c = _PALETTE[k % len(_PALETTE)] if colors is None \
            else np.asarray(colors[k], np.uint8)
        n = int(max(abs(x2 - x1), abs(y2 - y1), 1)) * 2 + 1
        t = np.linspace(0.0, 1.0, n)
        xs = np.clip(np.round(x1 + (x2 - x1) * t).astype(int), 0, W - 1)
        ys = np.clip(np.round(y1 + (y2 - y1) * t).astype(int), 0, H - 1)
        for r in range(-radius + 1, radius):
            out[np.clip(ys + r, 0, H - 1), xs] = c
            out[ys, np.clip(xs + r, 0, W - 1)] = c
        out[ys, xs] = c
    return out


def combine_images_horizontally(img1, img2) -> np.ndarray:
    """Side-by-side canvas, height-padded."""
    a = _as_u8_rgb(img1)
    b = _as_u8_rgb(img2)
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    return canvas


def combine_images_vertically(img1, img2) -> np.ndarray:
    """Stacked canvas, width-padded."""
    a = _as_u8_rgb(img1)
    b = _as_u8_rgb(img2)
    W = max(a.shape[1], b.shape[1])
    canvas = np.zeros((a.shape[0] + b.shape[0], W, 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[a.shape[0]:, : b.shape[1]] = b
    return canvas


def draw_feature_matches(img1, img2, kps1, kps2, horizontal: bool = True,
                         radius: int = 3) -> np.ndarray:
    """Match panel: both images combined, matched keypoints circled and
    connected, one palette color per match."""
    kps1 = np.asarray(kps1, np.float32).reshape(-1, 2)
    kps2 = np.asarray(kps2, np.float32).reshape(-1, 2)
    if horizontal:
        canvas = combine_images_horizontally(img1, img2)
        off = np.array([_as_u8_rgb(img1).shape[1], 0], np.float32)
    else:
        canvas = combine_images_vertically(img1, img2)
        off = np.array([0, _as_u8_rgb(img1).shape[0]], np.float32)
    k2 = kps2 + off
    edges = np.concatenate([kps1, k2], -1)
    canvas = draw_lines(canvas, edges)
    canvas = draw_points(canvas, kps1, radius)
    canvas = draw_points(canvas, k2, radius)
    return canvas


def draw_feature_trails(img, trails, radius: int = 2,
                        trail_max_length: int = 9) -> np.ndarray:
    """Keypoint motion trails: for each track, a
    circle at the newest position and a fading polyline through up to
    trail_max_length previous positions."""
    out = _as_u8_rgb(img).copy()
    for k, trail in enumerate(trails):
        t = np.asarray(trail, np.float32).reshape(-1, 2)
        if len(t) == 0:
            continue
        t = t[-(trail_max_length + 1):]
        color = _PALETTE[k % len(_PALETTE)]
        if len(t) > 1:
            segs = np.concatenate([t[:-1], t[1:]], -1)
            cols = [np.clip(color.astype(int) * (0.4 + 0.6 * (i + 1)
                                                 / len(segs)), 0,
                            255).astype(np.uint8)
                    for i in range(len(segs))]
            out = draw_lines(out, segs, colors=cols)
        out = draw_points(out, t[-1:][:, :2], radius,
                          colors=[color])
    return out


def save_image(path: str, img: np.ndarray):
    """Write an RGB image as matplotlib's imsave writes it (PIL, JPEG at
    100 dpi for .jpg), so the files equal the reference's byte for byte."""
    from PIL import Image
    fmt = os.path.splitext(path)[1].lower().lstrip(".")
    fmt = "jpeg" if fmt in ("jpg", "jpeg") else fmt
    Image.fromarray(_as_u8_rgb(img), "RGB").save(path, format=fmt,
                                                 dpi=(100, 100))


@functools.lru_cache(maxsize=None)
def _say_cv2():
    print("outputs: matplotlib is not installed; the render panels, "
          "trajectory views and loss curves are drawn with cv2", flush=True)


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed (then the writers draw with cv2; said once)."""
    try:
        import matplotlib
    except ImportError:
        _say_cv2()
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _title(tile: np.ndarray, text: str) -> np.ndarray:
    """tile (H, W, 3) u8 under a white 24-pixel band holding `text`."""
    import cv2
    band = np.full((24, tile.shape[1], 3), 255, np.uint8)
    cv2.putText(band, text, (4, 17), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (0, 0, 0), 1, cv2.LINE_AA)
    return np.concatenate([band, tile], 0)


def plain_image_panel(tiles, cols: int) -> np.ndarray:
    """A grid of titled tiles [(image, title, vmax or None)]: 2-D images
    colour-mapped (plasma, 0..vmax), RGB images as they are."""
    import cv2
    out = []
    for img, title, vmax in tiles:
        a = np.asarray(img, np.float32)
        if a.ndim == 2:
            u8 = np.clip(a / max(vmax, 1e-12) * 255, 0, 255).astype(np.uint8)
            a = cv2.applyColorMap(u8, cv2.COLORMAP_PLASMA)[..., ::-1]
        out.append(_title(_as_u8_rgb(a), title))
    rows = [np.concatenate(out[i:i + cols], 1)
            for i in range(0, len(out), cols)]
    return np.concatenate(rows, 0)


_COLORS = {"g": (0, 160, 0), "r": (220, 0, 0), "b": (0, 0, 220),
           "0.7": (178, 178, 178), "0.75": (191, 191, 191)}


def plain_line_plot(series, title: str, log_y: bool = False,
                    equal: bool = False, size=(400, 400)) -> np.ndarray:
    """One plot (H, W, 3) u8: series [(x, y, colour key, label, marker)]
    as polylines (marker '.': dots) on a white canvas scaled to their
    range, y on a log scale with log_y, equal axis scales with equal."""
    import cv2
    W, H = size
    img = np.full((H, W, 3), 255, np.uint8)
    pad = 30
    pts = [(np.asarray(x, np.float64),
            np.log10(np.maximum(np.asarray(y, np.float64), 1e-12))
            if log_y else np.asarray(y, np.float64), c, lab, mk)
           for x, y, c, lab, mk in series if len(x)]
    if pts:
        xs = np.concatenate([p[0] for p in pts])
        ys = np.concatenate([p[1] for p in pts])
        x0, x1 = xs.min(), max(xs.max(), xs.min() + 1e-9)
        y0, y1 = ys.min(), max(ys.max(), ys.min() + 1e-9)
        sx, sy = (W - 2 * pad) / (x1 - x0), (H - 2 * pad) / (y1 - y0)
        if equal:
            sx = sy = min(sx, sy)
        for k, (x, y, c, lab, mk) in enumerate(pts):
            col = _COLORS.get(c, (0, 0, 0))
            q = np.stack([pad + (x - x0) * sx, H - pad - (y - y0) * sy],
                         -1).round().astype(np.int32)
            if mk == ".":
                for u, v in q:
                    cv2.circle(img, (int(u), int(v)), 1, col, -1)
            else:
                cv2.polylines(img, [q.reshape(-1, 1, 2)], False, col, 1,
                              cv2.LINE_AA)
            cv2.putText(img, lab, (W - 120, 14 + 14 * k),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, col, 1, cv2.LINE_AA)
    cv2.rectangle(img, (pad, pad), (W - pad, H - pad), (0, 0, 0), 1)
    return _title(img, title + (" (log y)" if log_y else ""))


def loss_log(slam) -> dict:
    """The engine's losses in the JAX reference's `loss_log` layout:
    {"mapping": [(idx, losses), ...] one per mapper event, "tracking":
    [(idx, first, best), ...] one per tracked frame}.

    The port keeps them in slam.frame_log: a frame's record holds the
    concatenated losses of all its mapper events under "map_losses" and
    each event's length under "map_sizes" (one event per mapper call:
    per outer and stage, or one for a fused-outer call, as the reference
    appends them), and "track_first" / "track_best" of its tracking. The
    device tensors are pulled here, at the writer's cadence."""
    mapping, tracking = [], []
    for rec in slam.frame_log:
        if "map_losses" in rec:
            ls = rec["map_losses"].detach().cpu().numpy()
            start = 0
            for n in rec.get("map_sizes", [len(ls)]):
                mapping.append((rec["idx"], ls[start:start + n]))
                start += n
        if "track_first" in rec:
            tracking.append((rec["idx"], float(rec["track_first"]),
                             float(rec["track_best"])))
    return {"mapping": mapping, "tracking": tracking}


class MatchVisualizer:
    """Writes the front-end's two-view match panels (its last_debug record:
    both frames, the accepted matches) at a fixed cadence."""

    def __init__(self, freq: int, out_dir: str, verbose: bool = False):
        self.freq = max(int(freq), 1)
        self.out_dir = out_dir
        self.verbose = verbose
        os.makedirs(out_dir, exist_ok=True)

    def vis(self, slam, idx: int):
        fe = getattr(slam, "frontend", None)
        dbg = getattr(fe, "last_debug", None) if fe is not None else None
        if dbg is None or idx % self.freq != 0 or dbg.get("cur_idx") != idx:
            return
        _, img_ref, _, _ = slam.frame_reader[dbg["ref_idx"]]
        _, img_cur, _, _ = slam.frame_reader[dbg["cur_idx"]]
        acc = np.asarray(dbg["accept"], bool)
        panel = draw_feature_matches(img_ref, img_cur,
                                     np.asarray(dbg["kps_ref"])[acc],
                                     np.asarray(dbg["kps_cur"])[acc])
        path = os.path.join(self.out_dir, f"{idx:05d}.jpg")
        save_image(path, panel)
        if self.verbose:
            print(f"MatchVisualizer: wrote {path} ({int(acc.sum())} "
                  f"matches)")


class TrajectoryWriter:
    """Top-down trajectory and map view: estimated and gt camera trails in
    the x-z plane, the current camera marked, the front-end's live map
    points overlaid. Writes {out_dir}/{idx:05d}.png at the cadence."""

    def __init__(self, freq: int, out_dir: str, verbose: bool = False):
        self.freq = max(int(freq), 1)
        self.out_dir = out_dir
        self.verbose = verbose
        os.makedirs(out_dir, exist_ok=True)

    def vis(self, slam, idx: int):
        if idx % self.freq != 0 or idx == 0:
            return
        est = np.asarray(slam.estimate_c2w_list[: idx + 1])
        gt = np.asarray(slam.gt_c2w_list[: idx + 1])
        fe = getattr(slam, "frontend", None)
        p = None
        if fe is not None and getattr(fe, "map", None) is not None:
            pts = [mp.pt for mp in fe.map.points if not mp.is_bad]
            if pts:
                p = np.stack(pts)
        path = os.path.join(self.out_dir, f"{idx:05d}.png")
        plt = pyplot()
        if plt is None:
            series = [] if p is None else [
                (p[:, 0], p[:, 2], "0.75", f"map ({len(p)} pts)", ".")]
            series += [(gt[:, 0, 3], gt[:, 2, 3], "g", "gt", "-"),
                       (est[:, 0, 3], est[:, 2, 3], "r", "estimate", "-")]
            save_image(path, plain_line_plot(series, f"frame {idx}",
                                             equal=True))
            return
        fig, ax = plt.subplots(figsize=(5, 5))
        if p is not None:
            ax.scatter(p[:, 0], p[:, 2], s=1, c="0.75",
                       label=f"map ({len(p)} pts)")
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "g-", lw=1, label="gt")
        ax.plot(est[:, 0, 3], est[:, 2, 3], "r-", lw=1, label="estimate")
        ax.plot(est[idx, 0, 3], est[idx, 2, 3], "r^", ms=8)
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=7)
        ax.set_title(f"frame {idx}")
        fig.savefig(path, dpi=90)
        plt.close(fig)
        if self.verbose:
            print(f"TrajectoryWriter: wrote {path}")


class LossCurveWriter:
    """Loss curves in one PNG, rewritten at the cadence: start and end
    mapping loss per mapper event and first and best tracking loss per
    tracked frame, over frames (from loss_log(slam))."""

    def __init__(self, freq: int, out_dir: str, verbose: bool = False):
        self.freq = max(int(freq), 1)
        self.out_dir = out_dir
        self.verbose = verbose
        os.makedirs(out_dir, exist_ok=True)

    def vis(self, slam, idx: int):
        if idx % self.freq != 0 or idx == 0:
            return
        log = loss_log(slam)
        path = os.path.join(self.out_dir, "loss_curves.png")
        plt = pyplot()
        if plt is None:
            m, t = log["mapping"], log["tracking"]
            panels = [plain_line_plot(
                [([i for i, _ in m], [l[0] for _, l in m], "0.7", "start",
                  "-"), ([i for i, _ in m], [l[-1] for _, l in m], "b",
                         "end", "-")], "mapping loss / event", log_y=True),
                plain_line_plot(
                [([i for i, _, _ in t], [f for _, f, _ in t], "0.7",
                  "first", "-"), ([i for i, _, _ in t],
                                  [b for _, _, b in t], "b", "best", "-")],
                "tracking loss / frame", log_y=True)]
            save_image(path, np.concatenate(panels, 1))
            return
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
        if log["mapping"]:
            fr = [i for i, _ in log["mapping"]]
            first = [float(l[0]) for _, l in log["mapping"]]
            last = [float(l[-1]) for _, l in log["mapping"]]
            axes[0].plot(fr, first, "0.7", label="start")
            axes[0].plot(fr, last, "b", label="end")
            axes[0].set_yscale("log")
            axes[0].set_title("mapping loss / event")
            axes[0].legend(fontsize=7)
        if log["tracking"]:
            fr = [i for i, _, _ in log["tracking"]]
            first = [f for _, f, _ in log["tracking"]]
            best = [b for _, _, b in log["tracking"]]
            axes[1].plot(fr, first, "0.7", label="first")
            axes[1].plot(fr, best, "b", label="best")
            axes[1].set_yscale("log")
            axes[1].set_title("tracking loss / frame")
            axes[1].legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(path, dpi=90)
        plt.close(fig)
        if self.verbose:
            print(f"LossCurveWriter: wrote {path}")
