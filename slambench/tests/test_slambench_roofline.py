"""The roofline arithmetic reproduces the kernel table's bound times
(decoder FLOPs at 989 TFLOP/s) and counts a window's work from its
iterations."""

import pytest

from slambench import roofline as R
from slambench.registry import config


def test_flop_fwd_is_the_decoder_per_point():
    assert R.FLOP_FWD == 442_880


@pytest.mark.parametrize("call,ms", [
    (R.k1_call(4998, 32, 12, 32, True), 0.5103),      # K1 mapper
    (R.k1_call(5000, 32, 12, 0, False), 0.1970),      # K1 tracker
    (R.k2_call(4998, 32), 0.0716),                    # K2
])
def test_bound_times(call, ms):
    t, by = R.bound_ms(*call)
    assert by == "operations"
    assert t == pytest.approx(ms, abs=5e-5)


def test_window_work_counts_calls():
    cfg = config("pointnerf_weak_room")
    s = R.shapes(cfg)
    assert (s["map_rays"], s["track_rays"], s["k_map"], s["k_track"]) == \
        (4998, 5000, 4, 5)
    w = R.window_work(cfg, 300, 50)
    k1m = R.k1_call(4998, 32, 12, 32, True)[0]
    k1t = R.k1_call(5000, 32, 12, 0, False)[0]
    assert w["k1_flops"] == pytest.approx(300 * k1m + 50 * k1t)
    assert w["k2_flops"] == pytest.approx(
        75 * R.k2_call(4998, 32)[0] + 10 * R.k2_call(5000, 32)[0])
    assert w["k1_bound_s"] == pytest.approx(
        (300 * 0.5103 + 50 * 0.1970) / 1e3, rel=1e-3)
    assert R.shapes(config("imap_rgbd_room"))["k_map"] == 1
