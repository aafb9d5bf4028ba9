"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file in this directory with a plain C interface.
At first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``_build/`` (listed in .gitignore) under a name that carries a hash of its
source, and loaded with ctypes. Nothing here falls back: a missing ``nvcc``
or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# argtypes of each kernel's C entry points (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits); an entry point that
# returns something other than a CUDA error code gives (argtypes, restype)
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "level_histogram": {
        "level_histogram_f32": [_P, _P, _P, _I, _I64, _I, _I64, _I, _P, _P],
        "level_histogram_bf16": [_P, _P, _P, _I, _I64, _I, _I64, _I, _P, _P],
    },
    "segment_sum_sorted": {
        "segment_sum_sorted_f32": [_P, _P, _P, _I64, _I, _I64, _I, _P, _P,
                                   _P],
        "segment_sum_sorted_bf16": [_P, _P, _P, _I64, _I, _I64, _I, _P, _P,
                                    _P],
        "segment_sum_sorted_scratch_bytes": ([_I64, _I, _I64], _I64),
    },
    "level_gather": {
        "level_gather_s1": [_P, _P, _P, _I, _I64, _I, _I64, _P, _P],
        "level_gather_s3": [_P, _P, _P, _I, _I64, _I, _I64, _P, _P],
        "level_gather_bf16": [_P, _P, _P, _I, _I64, _I, _I64, _P, _P],
    },
    "row_gather": {
        "row_gather": [_P, _P, _P, _I, _I64, _I64, _P, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine that has the card (set CUDA_HOME)")
    return path


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(_HERE, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=None) -> dict[str, float]:
    """Compile the kernels `names` (all by default) whose libraries are not
    there, one nvcc per source, all started together; returns the seconds
    each took (0 for one already built) and raises with the compiler's
    output if any nvcc fails."""
    names = list(SIGNATURES) if names is None else list(names)
    secs, running = {}, {}
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib):
            secs[name] = 0.0
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in running.items():
        build_logs[name] = proc.communicate()[0]
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"kernel build failed: {name}: nvcc exited "
                          f"{proc.returncode}\n{build_logs[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    _, path = _target(name)
    if not os.path.exists(path):
        build_all([name])
    lib = ctypes.CDLL(path)
    for fn, sig in SIGNATURES[name].items():
        argtypes, restype = sig if isinstance(sig, tuple) else (sig, _I)
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _loaded[name] = lib
    return lib
