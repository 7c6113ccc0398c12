"""First-hit ray casting against a triangle mesh on the host, through the
in-repo native BVH library (native/raycast.cpp, built into
native/libraycast.so with make when absent), loaded with ctypes as the
mesher loads libmarching_tets.so (the JAX reference's tools/raycast.py)."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "native")
_LIB = None
_F = ctypes.POINTER(ctypes.c_float)
_L = ctypes.POINTER(ctypes.c_long)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib_path = os.path.join(_NATIVE_DIR, "libraycast.so")
    if not os.path.exists(lib_path):
        subprocess.run(["make", "-C", _NATIVE_DIR, "libraycast.so"],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.rc_build.restype = ctypes.c_void_p
    lib.rc_build.argtypes = [_F, ctypes.c_long, _L, ctypes.c_long]
    lib.rc_cast.argtypes = [ctypes.c_void_p, _F, _F, ctypes.c_long, _F]
    lib.rc_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class MeshRaycaster:
    """First-hit ray parameter t for batches of rays; t = -1 on a miss."""

    def __init__(self, verts: np.ndarray, tris: np.ndarray):
        lib = _load()
        self._verts = np.ascontiguousarray(verts, np.float32)
        self._tris = np.ascontiguousarray(tris, np.int64)
        self._h = lib.rc_build(self._verts.ctypes.data_as(_F),
                               len(self._verts),
                               self._tris.ctypes.data_as(_L),
                               len(self._tris))

    def cast(self, origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        o = np.ascontiguousarray(origins, np.float32)
        d = np.ascontiguousarray(dirs, np.float32)
        out = np.empty((len(o),), np.float32)
        _load().rc_cast(self._h, o.ctypes.data_as(_F), d.ctypes.data_as(_F),
                        len(o), out.ctypes.data_as(_F))
        return out

    def __del__(self):
        if getattr(self, "_h", None) is not None and _LIB is not None:
            _LIB.rc_free(self._h)
            self._h = None
