"""Where the benchmark's parts live, found by name.

Every configuration, traffic mix, cell, metric and kernel-name list is a
file of its own under the benchmark's folder; adding one is adding a file:

  configs/<config>.json     the configuration as it is run, with its
                            source, precision, `reduced` and `assumed`
  traffic/<traffic>.json    the traffic's parameters (frame sequence,
                            frames cast, warm-up cycles, what the frames
                            carry), read by the one generator in frames.py
  workloads/<cell>.json     a cell: its configuration, its traffic, the
                            limits of the numbers that decide `correct` and
                            those judged only where a window produces them
  metrics/<metric>.py       a reader: read(ctx) -> number | None
  kernels/<kernel>.txt      regular expressions of a kernel's CUDA names,
                            one a line
  reference/<name>.py       a scene field's plain reference, which a
                            configuration names under `reference`
                            (reference/imap.py gives the interface)
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.abspath(__file__))
META_KEYS = ("source", "precision", "reduced", "assumed", "reference")
REFERENCE_API = ("PRECISION", "CONTROL", "consts", "init", "follow_map",
                 "follow_track")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _json(root: str | None, folder: str, name: str) -> dict:
    path = os.path.join(root or ROOT, folder, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def workload(name: str, root: str | None = None) -> dict:
    return _json(root, "workloads", name)


def traffic(name: str, root: str | None = None) -> dict:
    return _json(root, "traffic", name)


def config(name: str, root: str | None = None) -> dict:
    """The system's configuration dict (the file without its meta keys)."""
    c = _json(root, "configs", name)
    return {k: v for k, v in c.items() if k not in META_KEYS}


def merge(base: dict, over: dict | None) -> dict:
    """base with the nested dict `over` laid over it (copies)."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else copy.deepcopy(v)
    return out


def _module(kind: str, folder: str, name: str, root: str | None):
    path = os.path.join(root or ROOT, folder, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"slambench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: str | None = None):
    """The reader module of one metric (metrics/<name>.py)."""
    return _module("metric reader", "metrics", name, root)


def reference(config_name: str, root: str | None = None):
    """The plain reference module that configuration `config_name` names
    under `reference` (reference/<name>.py). There is no default: a
    configuration that names none, names one that has no file, or whose
    module lacks part of REFERENCE_API is refused."""
    name = _json(root, "configs", config_name).get("reference")
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"configuration {config_name!r} names no plain "
                         f"reference (its `reference` key: {name!r})")
    mod = _module("plain reference", "reference", name, root)
    missing = [a for a in REFERENCE_API if not hasattr(mod, a)]
    if missing:
        raise AttributeError(f"reference {name!r} lacks "
                             f"{', '.join(missing)}")
    return mod


def kernel_patterns(name: str, root: str | None = None) -> list:
    """Compiled patterns of one kernel's CUDA names (kernels/<name>.txt;
    blank lines and lines starting with # are skipped)."""
    path = os.path.join(root or ROOT, "kernels", f"{name}.txt")
    with open(path) as fh:
        return [re.compile(s) for s in (ln.strip() for ln in fh)
                if s and not s.startswith("#")]


def benchmark(root: str | None = None) -> dict | None:
    """BENCHMARK.json beside the benchmark's folder, if there is one."""
    path = os.path.join(os.path.dirname(root or ROOT), "BENCHMARK.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(cell: str, traced: bool, root: str | None = None) -> list:
    """Names of the metrics a run of `cell` reports: BENCHMARK.json's
    end_to_end (untraced) or per_layer (traced) entries whose `workloads`
    include the cell or that have none."""
    bench = benchmark(root)
    if bench is None:
        raise FileNotFoundError("BENCHMARK.json is missing beside the "
                                "benchmark's folder")
    key = "per_layer" if traced else "end_to_end"
    return [m["name"] for m in bench.get(key, [])
            if cell in m.get("workloads", [cell])]
