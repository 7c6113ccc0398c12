"""What the harness loads: never JAX, jaxlib, flax or the JAX package
(compared by whole top-level name: the port's name begins with the JAX
package's), and the reference nothing of the program either."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = """
import importlib, json, sys
for m in {mods!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""

HARNESS = ["slambench.run", "slambench.check", "slambench.capture",
           "slambench.trace", "slambench.frames", "slambench.registry",
           "slambench.roofline", "slambench.calibrate",
           "pointnerf_slam_torch.engine.system",
           "pointnerf_slam_torch.frontend.fused_twoview",
           "pointnerf_slam_torch.ops.build"]
REFERENCE = ["slambench.reference", "slambench.reference.imap",
             "slambench.reference.camera", "slambench.reference.frontend"]


def _loaded(mods):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE.format(mods=mods)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded(HARNESS)
    assert "pointnerf_slam_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pointnerf_slam_tpu"}


def test_reference_loads_nothing_of_the_program():
    top = _loaded(REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "pointnerf_slam_tpu",
                      "pointnerf_slam_torch"}


def test_forbidden_check_compares_whole_names(monkeypatch):
    from slambench import run
    monkeypatch.setitem(sys.modules, "pointnerf_slam_tpu_extra", sys)
    assert "pointnerf_slam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pointnerf_slam_tpu.engine", sys)
    assert "pointnerf_slam_tpu" in run.forbidden_modules()
