"""A configuration with another scene field enters the harness as files
only. NICE-SLAM (configs/nice_slam.yaml over the iMAP* room: feature grids
with the coarse level, occupancy, BA, overlap windows, frustum grid masks,
handle_dynamic) at a reduced size goes into a copy of the tree with a
traffic mix, a cell and a stand-in reference (standin_reference.py, which
hands back what the program recorded), and runs through slambench.run.run
on the CPU with no file the harness had changed. The capture holds the
field's whole state (decoder and grids); the mapper's capture names its
stage, one call a stage of the armed frame, and holds the gradients of the
leaves that got one; the tally counts the iterations the system plans. A
reference whose leaves differ from the program's by one leaf is not
correct: that number reads inf."""

import json
import os
import shutil
import types

import pytest
import torch
import yaml

import slambench.run as run_mod
from pointnerf_slam_torch.engine.state import EngineConfig
from pointnerf_slam_torch.engine.system import PointNeRFSLAM
from slambench import check, registry
from slambench.tests.test_slambench_registry import HERE, _digest
from slambench.tests.test_slambench_run import SEED, SMALL

ROOT = os.path.dirname(HERE)
CELL = "nice_rgbd_small.orbit_ba"
GRIDS = {"grid_coarse", "grid_middle", "grid_fine", "grid_color"}
# iterations and pixels cut, not features; mapping every second frame
# with a keyframe each, and three warm-up cycles, so that the window's
# mapped frame has five keyframes and bundle-adjusts
CUT = {"cam": SMALL["cam"],
       "mapping": {"pixels": 240, "iters": 12, "iters_first": 12,
                   "every_frame": 2, "keyframe_every": 2},
       "tracking": {"pixels": 96, "iters": 6}}
LIMITS = {"init_gap": 0.0, "map_loss1": 0.0, "map_grad_med": 0.0,
          "map_change1": 0.0, "track_loss1": 0.0, "track_grad_med": 0.0,
          "track_change1": 0.0, "pose_pick": 1e-4}


def nice_config(cut=None) -> dict:
    """The iMAP* room's resolved configuration with configs/nice_slam.yaml
    laid over it (upstream NICE has no termination band), then `cut`."""
    cfg = registry.config("imap_rgbd_room")
    with open(os.path.join(ROOT, "configs",
                           "nice_slam.yaml")) as fh:
        cfg = registry.merge(cfg, yaml.safe_load(fh))
    cfg["mapping"]["w_beyond_loss"] = 0.0
    return registry.merge(cfg, cut)


def _write(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


@pytest.fixture(scope="module")
def nice(tmp_path_factory):
    base = tmp_path_factory.mktemp("nice")
    tree = str(base / "slambench")
    shutil.copytree(HERE, tree, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"),
                base / "BENCHMARK.json")
    before = _digest(tree)
    cfg = nice_config(CUT)
    cfg.update({
        "source": "https://github.com/cvg/nice-slam/blob/master/configs/"
                  "nice_slam.yaml",
        "reference": "standin",
        "precision": {"field": "float32"},
        "reduced": ["cam", "mapping", "tracking"],
        "assumed": {"cut": "the harness tests' size"}})
    _write(os.path.join(tree, "configs", "nice_rgbd_small.json"), cfg)
    orbit = registry.traffic("orbit")
    _write(os.path.join(tree, "traffic", "orbit_ba.json"),
           dict(orbit, warm_cycles=3, render_frames=12))
    _write(os.path.join(tree, "workloads", f"{CELL}.json"),
           {"config": "nice_rgbd_small", "traffic": "orbit_ba",
            "limits": LIMITS})
    shutil.copy(os.path.join(HERE, "tests", "standin_reference.py"),
                os.path.join(tree, "reference", "standin.py"))

    seen = {}
    numbers, tally = check.numbers, run_mod.window_tally

    def keep_numbers(captured, cfg, seed, ref, **kw):
        seen.setdefault("captured", captured)
        seen.update(cfg=cfg, ref=ref)
        return numbers(captured, cfg, seed, ref, **kw)

    def keep_tally(slam, *a):
        seen.update(planned=run_mod.planned_map_iters(slam),
                    ba={r["idx"]: r.get("ba") for r in slam.frame_log})
        return tally(slam, *a)

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(
        os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(check, "numbers", keep_numbers)
        mp.setattr(run_mod, "window_tally", keep_tally)
        res = run_mod.run(CELL, SEED, 0.0, False, device="cpu", root=tree)
    return types.SimpleNamespace(tree=tree, before=before, res=res, **seen)


def _window_map_caps(nice):
    """The captured calls of the window's mapped frame (the first
    captures are frame 0's)."""
    idx = nice.captured["map_caps"][-1]["idx"]
    return [c for c in nice.captured["map_caps"] if c["idx"] == idx]


def test_mapper_capture_names_its_stage_and_gradient_leaves(nice):
    caps = _window_map_caps(nice)
    assert [c["stage"] for c in caps] == ["coarse", "middle", "fine",
                                          "color"]
    assert nice.ba[caps[0]["idx"]] is True  # the frame bundle-adjusts
    colour = {k for k in caps[0]["params0"] if k.startswith("color.")}
    # the Adam holds the grids and the unfixed colour decoder; a stage's
    # gradients reach the grids it samples (fine occupancy adds to the
    # middle level's, colour samples both and its own grid) and the
    # colour decoder where colour is rendered; never the cameras, whose
    # Adam under BA is not the mapper's
    want = {"coarse": {"grid_coarse"}, "middle": {"grid_middle"},
            "fine": {"grid_middle", "grid_fine"},
            "color": {"grid_middle", "grid_fine", "grid_color"} | colour}
    for cap in caps:
        assert cap["lr_factor"] == 1.0
        assert set(cap["params1"]) == set(cap["params3"]) == GRIDS | colour
        assert set(cap["grads1"]) == want[cap["stage"]], cap["stage"]
        assert set(cap["further"]["grid_masks"]) == GRIDS
    assert bool(caps[-1]["ba"].any())      # BA at the colour stage only
    assert not any(bool(c["ba"].any()) for c in caps[:-1])


def test_tracker_capture_holds_the_grids(nice):
    caps = nice.captured["track_caps"]
    assert caps
    for cap in caps:
        assert set(cap["params"]) == set(nice.captured["init"])
        # a pose the mapper bundle-adjusted after the tracker is not the
        # tracker's pick: pose_pick leaves that call out
        assert (cap["committed"] is None) == bool(nice.ba.get(cap["idx"]))
    assert any(cap["committed"] is not None for cap in caps)


def _drop_init_leaf(ref):
    def init(seed, cfg, quant):
        out = ref.init(seed, cfg, quant)
        del out["grid_fine"]
        return out
    return {"init": init}, "init_gap"


def _extra_map_grad(ref):
    def follow_map(cap, c, steps, quant):
        out = dict(ref.follow_map(cap, c, steps, quant))
        g = dict(out["grads1"])
        g["grid_middle"] = torch.zeros_like(cap["params0"]["grid_middle"])
        return dict(out, grads1=g)
    return {"follow_map": follow_map}, "map_grad_med"


def _renamed_map_leaf(ref):
    def follow_map(cap, c, steps, quant):
        out = dict(ref.follow_map(cap, c, steps, quant))
        p = dict(out["params1"])
        p["grid_colour"] = p.pop("grid_color")
        return dict(out, params1=p)
    return {"follow_map": follow_map}, "map_change1"


@pytest.mark.parametrize("fault", [_drop_init_leaf, _extra_map_grad,
                                   _renamed_map_leaf])
def test_a_reference_with_other_leaves_fails_closed(nice, fault):
    ref = nice.ref
    over, name = fault(ref)
    other = types.SimpleNamespace(**{k: getattr(ref, k)
                                     for k in registry.REFERENCE_API})
    other.__dict__.update(over)
    nums = check.numbers(nice.captured, nice.cfg, SEED, other)
    assert nums[name] == float("inf")
    ok, lines = check.judge(nums, LIMITS)
    assert not ok
    assert any(ln.startswith(name + " inf") and ln.endswith("FAILED")
               for ln in lines), lines


@pytest.mark.parametrize("cfg,want", [
    (registry.config("pointnerf_weak_room"), 300),
    (registry.config("imap_rgbd_room"), 300),
    (nice_config(), 80),          # coarse 20, middle 24, fine 12, colour 24
])
def test_the_tally_counts_the_iterations_the_system_plans(cfg, want):
    cam = cfg["cam"]
    slam = types.SimpleNamespace(
        nice=bool(cfg.get("nice")), cfg=cfg,
        ecfg=EngineConfig.from_cfg(cfg, cam["H"], cam["W"], cam["fx"],
                                   cam["fy"], cam["cx"], cam["cy"]),
        c_grid=dict.fromkeys(GRIDS) if cfg.get("nice") else {})
    slam._stage_schedule = types.MethodType(PointNeRFSLAM._stage_schedule,
                                            slam)
    assert run_mod.planned_map_iters(slam) == want
