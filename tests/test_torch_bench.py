"""bench_torch.py, the port's counterpart of bench.py, on the CPU.

(a) Its workload is bench.py's: bench.py is parsed with `ast`, never
    imported (its import loads JAX and creates .jax_cache), and the
    literal values and keywords of its main() are held against
    bench_torch's constants and configs.
(b) One cycle through bench_torch.run at a tiny size (24x32 frame, a
    32-wide decoder, 8 + 4 samples, 5 tracker and 3 x 4 mapper iterations)
    gives, bit for bit, the losses of the port's make_tracking_step and
    make_mapper_step called directly on the same inputs and draws from the
    initial decoder (the warm-up cycle's training is thrown away).
(c) main() at that size prints one last line with bench.py's four keys.
Without a card, run() on the default device raises.
"""

import ast
import json
import math
import os

import pytest
import torch

import bench_torch as B
from pointnerf_slam_torch.engine.mapper import make_mapper_step
from pointnerf_slam_torch.engine.state import Draws, EngineConfig
from pointnerf_slam_torch.engine.tracker import make_tracking_step
from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
from pointnerf_slam_torch.render.renderer import RenderConfig
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(H=24, W=32, hidden=32, samples=(8, 4), pixels=240,
            track_iters=5, map_inner=4)


class _Recorder:
    """Stands in for a config class: records the keywords it is built
    with."""

    def __init__(self, **kw):
        self.kw = kw


class _Environ:
    """os.environ with no variable set: os.environ.get gives the default."""

    environ: dict = {}


def bench_py() -> dict:
    """bench.py's main() evaluated as far as it is plain Python: every
    assignment whose right side needs no JAX, with BENCH_* unset and the
    config classes recorded; plus cam0's literal, the result line's
    constant strings and BASELINE_FPS."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    ns = {"os": _Environ, "int": int, "MLPConfig": _Recorder,
          "RenderConfig": _Recorder, "EngineConfig": _Recorder}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                node.targets[0].id == "BASELINE_FPS":
            exec(compile(ast.Module([node], []), "bench.py", "exec"), ns)
    got = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign):
            try:
                exec(compile(ast.Module([node], []), "bench.py", "exec"), ns)
            except NameError:           # needs JAX: read literals instead
                if getattr(node.targets[0], "id", None) == "cam0":
                    got["cam0"] = ast.literal_eval(node.value.args[0])
        elif isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            got["line"] = {ast.literal_eval(k): (
                ast.literal_eval(v) if isinstance(v, ast.Constant) else None)
                for k, v in zip(node.keys, node.values)}
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "make_mapper_step":
            got["outer_fused"] = next(k.value.id for k in node.keywords
                                      if k.arg == "outer_fused")
    return {**ns, **got}


def test_constants_and_configs_equal_bench_py():
    b = bench_py()
    assert (B.H, B.W, B.FX, B.FY, B.CX, B.CY) == \
        (b["H"], b["W"], b["fx"], b["fy"], b["cx"], b["cy"])
    assert B.model_config() == MLPConfig(**b["model_cfg"].kw)
    assert B.render_config() == RenderConfig(**b["rcfg"].kw)
    assert B.engine_config() == EngineConfig(**b["ecfg"].kw)
    assert B.engine_config().w_beyond_loss == 0.0
    assert (B.F, B.MAP_INNER, B.N_CYCLES, B.K, B.KT) == \
        (b["F"], b["MAP_INNER"], b["n_cycles"], b["K"], b["KT"])
    assert b[b["outer_fused"]] is True and b["NO_BA_FAST"] is True
    assert B.make_steps(B.model_config(), B.render_config(),
                        B.engine_config())[1].__name__ == \
        "mapper_multi_step"
    assert list(B.CAM0) == b["cam0"]
    assert B.BASELINE_FPS == b["BASELINE_FPS"]
    assert round(B.BASELINE_FPS, 4) == 0.3315
    assert b["line"] == {"metric": B.METRIC, "value": None,
                         "unit": "frames/s", "vs_baseline": None}


def test_cycle_equals_direct_steps():
    res = B.run("cpu", n_cycles=1, **TINY)
    mcfg = MLPConfig(dim=3, c_dim=0, color=True, hidden_size=32, skips=(),
                     n_blocks=4)
    rcfg = RenderConfig(N_samples=8, N_surface=0, N_importance=4)
    ecfg = EngineConfig(H=24, W=32, fx=600.0, fy=600.0, cx=15.5, cy=11.5,
                        tracking_pixels=240, num_cam_iters=5, cam_lr=1e-3,
                        mapping_pixels=240, mapping_window_size=5,
                        weak_depth=False, depth_supervision=True,
                        no_ba_fast=True, map_resample_every=4,
                        track_resample_every=5)
    g = torch.Generator().manual_seed(1)
    color = torch.rand(24, 32, 3, generator=g)
    depth = 0.5 + 2.5 * torch.rand(24, 32, generator=g)
    u8 = (color * 255).to(torch.uint8)
    cam = torch.tensor([1.0, 0, 0, 0, 0, 0, 2.5])
    bound = torch.tensor([[-3.5, 3.5]] * 3)
    dec = IMAPDecoder(mcfg, torch.Generator().manual_seed(0))
    draws = Draws(torch.Generator().manual_seed(3))     # the timed cycle's
    _, _, _, tl = make_tracking_step(mcfg, rcfg, ecfg)(
        dec, cam, color, depth, bound, draws)
    _, ml = make_mapper_step(mcfg, rcfg, ecfg, 6, outer_fused=True)(
        dec, u8.expand(3, 6, 24, 32, 3), depth.expand(3, 6, 24, 32),
        cam.expand(3, 6, 7).contiguous(), torch.ones(3, 6, dtype=torch.bool),
        torch.zeros(3, 6, dtype=torch.bool), bound, draws, 4)
    assert tl.shape == (5,) and ml.shape == (12,)
    assert torch.equal(res["tracker_losses"], tl)
    assert torch.equal(res["mapper_losses"], ml)


def test_main_prints_the_result_line(capsys):
    assert B.main(device="cpu", n_cycles=1, **TINY) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "replica_room0_budget_tracking_mapping_fps"
    assert line["unit"] == "frames/s"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / B.BASELINE_FPS, 2)


def test_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.run()
