"""Adding a configuration, a traffic mix, a cell, a metric, a kernel list
or a plain reference is adding a file: the harness finds it by name and no
file it had changes. A configuration names its plain reference, with no
default; the meta keys leave the system's resolved configuration as it
is."""

import hashlib
import json
import os
import shutil

import pytest

from slambench import registry
from slambench.run import build_cell, cell_parts

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.fixture
def tree(tmp_path):
    root = tmp_path / "slambench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    return str(root)


def test_dropped_files_are_found(tree):
    before = _digest(tree)
    cfg = json.load(open(os.path.join(tree, "configs",
                                      "imap_rgbd_room.json")))
    cfg["mapping"]["iters"] = 150
    json.dump(cfg, open(os.path.join(tree, "configs", "new_room.json"),
                        "w"))
    json.dump({"sequence": {"n_frames": 100, "orbit": 0.1},
               "render_frames": 50, "warm_cycles": 2},
              open(os.path.join(tree, "traffic", "slow_orbit.json"), "w"))
    json.dump({"config": "new_room", "traffic": "slow_orbit",
               "limits": {"map_loss": 1.0}},
              open(os.path.join(tree, "workloads",
                                "new_room.slow_orbit.json"), "w"))
    with open(os.path.join(tree, "metrics", "cycles_run.py"), "w") as fh:
        fh.write("def read(ctx):\n    return float(ctx.cycles)\n")
    with open(os.path.join(tree, "kernels", "k9.txt"), "w") as fh:
        fh.write("# a new kernel\nfoo_kernel\n")
    after = _digest(tree)
    assert {k: v for k, v in after.items() if k in before} == before

    spec, c, traffic = cell_parts("new_room.slow_orbit", tree)
    assert spec["limits"] == {"map_loss": 1.0}
    assert c["mapping"]["iters"] == 150 and "source" not in c
    assert traffic["warm_cycles"] == 2
    ctx = type("Ctx", (), {"cycles": 7})()
    assert registry.metric("cycles_run", tree).read(ctx) == 7.0
    assert [p.pattern for p in registry.kernel_patterns("k9", tree)] == \
        ["foo_kernel"]


def test_metric_listed_for_a_cell_is_reported_there(tree):
    bench_path = os.path.join(os.path.dirname(tree), "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["per_layer"].append({
        "name": "cycles_run", "unit": "cycles", "better": "higher",
        "source": "program_counter", "layer": "entry",
        "moves": "device_ms_per_frame", "workloads": ["imap_rgbd_room.orbit"]})
    json.dump(bench, open(bench_path, "w"))
    assert "cycles_run" in registry.cell_metrics("imap_rgbd_room.orbit",
                                                 True, tree)
    assert "cycles_run" not in registry.cell_metrics(
        "pointnerf_weak_room.orbit", True, tree)
    assert registry.cell_metrics("imap_rgbd_room.orbit", False, tree) == \
        ["device_ms_per_frame", "setup_s"]


def test_every_listed_part_has_its_file():
    bench = registry.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(os.path.dirname(HERE),
                                           c["file"]))
    for w in bench["workloads"]:
        spec = registry.workload(w["name"])
        assert (spec["config"], spec["traffic"]) == (w["config"],
                                                     w["traffic"])
        registry.traffic(spec["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.metric(m["name"]).read)
    for k in ("k1", "k2"):
        assert registry.kernel_patterns(k)
    for c in bench["configs"]:
        ref = registry.reference(c["name"])
        assert all(hasattr(ref, a) for a in registry.REFERENCE_API)


# sha256 of each cell's resolved system configuration, as the harness
# resolved it before configurations named their reference
RESOLVED = {
    "pointnerf_weak_room.orbit":
        "de5c265a53fa578e25eafb290c7481f5ec5e0bc95166b6de83f0c1fd530f6a2a",
    "imap_rgbd_room.orbit":
        "19b04ad38866a6e9a0f5ce5fef46a28824260469507eece6ef7636cd718b8487",
    "imap_rgbd_room.gt_camera":
        "f46c600a678acda8f3d115d720e3f7bf6191a61847fa6a082d65f105763e6bf5",
}


@pytest.mark.parametrize("cell", sorted(RESOLVED))
def test_the_resolved_configuration_is_unchanged(cell):
    _, cfg, _ = cell_parts(cell)
    assert "reference" not in cfg
    assert hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()
                          ).hexdigest() == RESOLVED[cell]


@pytest.mark.parametrize("name,error", [(None, ValueError),
                                        ("", ValueError),
                                        ("../imap", ValueError),
                                        ("absent", FileNotFoundError),
                                        ("frontend", AttributeError)])
def test_a_cell_without_its_reference_is_refused(tree, name, error):
    cfg = json.load(open(os.path.join(tree, "configs",
                                      "imap_rgbd_room.json")))
    cfg.pop("reference")
    if name is not None:
        cfg["reference"] = name
    json.dump(cfg, open(os.path.join(tree, "configs", "bare_room.json"),
                        "w"))
    json.dump({"config": "bare_room", "traffic": "orbit", "limits": {}},
              open(os.path.join(tree, "workloads", "bare_room.orbit.json"),
                   "w"))
    with pytest.raises(error):
        build_cell("bare_room.orbit", 1, "cpu", tree)
