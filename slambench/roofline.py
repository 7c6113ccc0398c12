"""Roofline arithmetic of the decoder kernels, from the algorithm's shapes.

The least time a call could take on one NVIDIA H100 SXM is the larger of
its operations over the dense bf16 peak and its bytes over the HBM peak
(NVIDIA's data sheet, 700 W). Operations and bytes are counted from the
shapes of the work, whatever implements it: every decoder point costs
FLOP_FWD forward (the 93 -> 4 x 256 -> 4 iMAP* MLP); a value-and-grad
point costs a forward, the dh chain and, with parameter gradients, the
weight-gradient products (x 3), or without them x 2. Each input byte is
counted once read and each output byte once written.

  K1 (fused value-and-grad, `ops/fused_vg.py` `main`): rays x (S1 + SI)
     composited points, plus SR regulation points in the mapper.
  K2 (pass-1 sigma, `ops/fused_vg.py` `prepare`): rays x S1 points,
     forward only.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12       # dense bf16 FLOP/s
PEAK_HBM_BYTES = 3.35e12       # HBM3 bytes/s

EMB, HID, OUT = 93, 256, 4
EMB_PAD = 128                  # the kernels' padded Fourier width
FLOP_FWD = 2 * (EMB * HID + 3 * HID * HID + HID * OUT)   # per point

# the packed decoder the kernels read: B (3, 128) f32, W0 (128, 256) and
# W1..W3 (256, 256) and Wo (256, 4) bf16, biases f32
WEIGHT_BYTES = (3 * EMB_PAD * 4 + (EMB_PAD * HID + 3 * HID * HID
                                   + HID * OUT) * 2
                + (4 * HID + OUT) * 4)


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(ms, "operations" | "bytes"): the roofline time and what sets it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k1_call(rays: int, s1: int, si: int, sr: int, param_grads: bool
            ) -> tuple:
    """(flops, bytes) of one K1 call: rays x (s1 + si) composited points
    and rays x sr regulation points (sr 0 for the tracker). Reads the rays
    (8 floats), colour and ray weight (4), the merged z and the regulation
    uniforms, and the weights; writes 16 floats a ray and, with parameter
    gradients, a weight-sized gradient twice over (f32)."""
    pts = rays * (s1 + si + sr)
    mult = 3 if param_grads else 2
    in_bytes = rays * (8 + 4 + s1 + si + sr) * 4 + WEIGHT_BYTES
    out_bytes = rays * 16 * 4 + (2 * WEIGHT_BYTES if param_grads else 0)
    return pts * FLOP_FWD * mult, in_bytes + out_bytes


def k2_call(rays: int, s1: int) -> tuple:
    """(flops, bytes) of one K2 call: rays x s1 points forward; reads the
    rays and the weights, writes one sigma a point."""
    pts = rays * s1
    return pts * FLOP_FWD, rays * 8 * 4 + WEIGHT_BYTES + pts * 4


def shapes(cfg: dict) -> dict:
    """The configuration's per-call shapes: mapper and tracker rays, the
    sample counts, and each loop's resample period K (one K2 call per K
    iterations)."""
    r = cfg["rendering"]
    m, t = cfg["mapping"], cfg["tracking"]
    frames = m["mapping_window_size"] + 1
    map_iters = max(m["iters"] // 3, 1)
    k_map = max(int(m.get("resample_every", 1)), 1)
    k_trk = max(int(t.get("resample_every", 1)), 1)
    return {
        "map_rays": m["pixels"] // frames * frames,
        "track_rays": t["pixels"],
        "s1": r["N_samples"], "si": r["N_importance"], "sr": r["N_samples"],
        "k_map": k_map if map_iters % k_map == 0 else 1,
        "k_track": k_trk if t["iters"] % k_trk == 0 else 1,
    }


def window_work(cfg: dict, map_iters: int, track_iters: int) -> dict:
    """FLOPs and bound seconds of the K1 and K2 calls of a window that ran
    map_iters mapper and track_iters tracker iterations (one K1 call an
    iteration, one K2 call a resample round)."""
    s = shapes(cfg)
    k1m = k1_call(s["map_rays"], s["s1"], s["si"], s["sr"], True)
    k1t = k1_call(s["track_rays"], s["s1"], s["si"], 0, False)
    k2m = k2_call(s["map_rays"], s["s1"])
    k2t = k2_call(s["track_rays"], s["s1"])
    map_rounds = map_iters / s["k_map"]
    track_rounds = track_iters / s["k_track"]

    def sec(call, n):
        return bound_ms(*call)[0] / 1e3 * n

    return {
        "k1_flops": k1m[0] * map_iters + k1t[0] * track_iters,
        "k2_flops": k2m[0] * map_rounds + k2t[0] * track_rounds,
        "k1_bound_s": sec(k1m, map_iters) + sec(k1t, track_iters),
        "k2_bound_s": sec(k2m, map_rounds) + sec(k2t, track_rounds),
    }
