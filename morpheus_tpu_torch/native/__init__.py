"""Native (C++) host code of the port, built at first use with g++ and bound
with ctypes: marching-tetrahedra iso-surface extraction (mc_tetra.cpp), the
hot host op of mesh export.

The library is built into ``_build/`` beside the source (listed in
.gitignore) and rebuilt when the source is newer. Each build writes a file of
its own and renames it into place, so processes that build at once never load
a half-written library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_SRC_DIR, "_build")


def _build(name: str, srcs: list[str]) -> str:
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    src_paths = [os.path.join(_SRC_DIR, s) for s in srcs]
    if os.path.exists(so) and all(
            os.path.getmtime(so) >= os.path.getmtime(s) for s in src_paths):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp] + src_paths
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)
    return so


class _MCubes:
    def __init__(self):
        self._lib = None

    @property
    def lib(self):
        if self._lib is None:
            so = _build("mc_tetra", ["mc_tetra.cpp"])
            lib = ctypes.CDLL(so)
            lib.mt_run.restype = ctypes.c_int
            lib.mt_run.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mt_free.restype = None
            lib.mt_free.argtypes = [ctypes.c_void_p]
            self._lib = lib
        return self._lib

    def marching_cubes(self, sdf: np.ndarray, level: float = 0.0):
        """(vertices (V, 3) float32 in index coordinates, faces (F, 3)
        int32) of the `level` iso-surface of a dense (X, Y, Z) grid."""
        sdf = np.ascontiguousarray(sdf, np.float32)
        if sdf.ndim != 3:
            raise ValueError(f"expected a 3-D grid, got shape {sdf.shape}")
        nx, ny, nz = sdf.shape
        vp = ctypes.POINTER(ctypes.c_float)()
        fp = ctypes.POINTER(ctypes.c_int32)()
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        rc = self.lib.mt_run(
            sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nx, ny, nz, ctypes.c_float(level),
            ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp),
            ctypes.byref(nf))
        if rc != 0:
            raise RuntimeError("mt_run failed")
        try:
            verts = np.ctypeslib.as_array(vp, (nv.value, 3)).copy() \
                if nv.value else np.zeros((0, 3), np.float32)
            faces = np.ctypeslib.as_array(fp, (nf.value, 3)).copy() \
                if nf.value else np.zeros((0, 3), np.int32)
        finally:
            if nv.value:
                self.lib.mt_free(vp)
            if nf.value:
                self.lib.mt_free(fp)
        return verts.astype(np.float32), faces.astype(np.int32)


mcubes_native = _MCubes()
