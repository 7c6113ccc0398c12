"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles to `build/torch_kernels/lib<name>.so` at the
repository root (listed in .gitignore), for sm_90a, with a plain C
interface. Nothing is compiled at import: `load(name)` builds on first use
(or when a source is newer than its library), `build_all` compiles every
source at once, one nvcc process each, all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "torch_kernels")
SOURCES = ("p1_sigma", "fused_vg", "megakernel", "fused_mlp")
# -fmad=false: no multiply-add contraction beyond the explicit __fmaf_rn
# calls, so elementwise float math rounds as the plain PyTorch versions do
# (points, depths and x . B feed a bf16 rounding, where one ulp matters)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC))
    return os.path.getmtime(lib) < newest


def build_all(names=SOURCES, force: bool = False) -> dict:
    """Compile the named sources in parallel. Returns {name: ptxas log}.
    Raises RuntimeError with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                        os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[name] = out
        if p.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {p.returncode}) ---\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        if _stale(name):
            build_all([name])
        _loaded[name] = ctypes.CDLL(_lib_path(name))
        _loaded[name].kernel_error_string.restype = ctypes.c_char_p
        _loaded[name].kernel_error_string.argtypes = [ctypes.c_int]
    return _loaded[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")

