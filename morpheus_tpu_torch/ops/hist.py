"""Per-level histogram of hash-grid embedding cotangents.

Port of morpheus_tpu/ops/hist_pallas.py::level_histogram. The hash-grid
backward accumulates an unsorted stream of (row, value) updates into each
level's slice of the embedding table. On a CUDA tensor this launches the
hand-written kernel in kernels/level_histogram.cu; on a CPU tensor it runs the
plain version below. Nothing falls back: a CUDA call that cannot build or
launch the kernel raises.

Contract (both versions):

    level_histogram(idx_local (L, Np) int32, vals (L*Np, C) f32|bf16,
                    level_starts (L ints), n_rows, round_bf16=False)
        -> (n_rows, C) f32
    out[level_starts[l] + idx_local[l, i], c] += float(vals[l*Np + i, c])

Unlike the TPU kernel's (C, L, t_pad) output, the result is already in the
(T, C) table layout: the TPU caller's per-level slice-and-concatenate is
folded in. Payloads are summed in f32; a bf16 payload is widened, and an f32
payload with round_bf16 is rounded to bf16 first (to nearest even, as
``.to(torch.bfloat16)``), so the caller's separate rounding pass folds into
the kernel's load.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels, trace

MAX_LEVELS = 64


def _check(idx_local, vals, level_starts, n_rows):
    if idx_local.dim() != 2 or idx_local.dtype != torch.int32:
        raise ValueError("idx_local must be (L, Np) int32")
    L, Np = idx_local.shape
    if vals.dim() != 2 or vals.shape[0] != L * Np:
        raise ValueError(f"vals must be (L*Np, C) = ({L * Np}, C), got "
                         f"{tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals dtype {vals.dtype} not in (float32, bfloat16)")
    if len(level_starts) != L or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"need 1..{MAX_LEVELS} level starts, one per level")
    if vals.device != idx_local.device:
        raise ValueError("idx_local and vals must be on one device")
    if max(level_starts) > n_rows:
        raise ValueError("a level starts past the end of the table")


def level_histogram_reference(idx_local: torch.Tensor, vals: torch.Tensor,
                              level_starts, n_rows: int,
                              round_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version: per-channel index_add_ of the values (rounded
    to bf16 first under round_bf16) into an f32 table."""
    _check(idx_local, vals, level_starts, n_rows)
    L = idx_local.shape[0]
    starts = torch.as_tensor(list(level_starts), dtype=torch.int64,
                             device=idx_local.device).reshape(L, 1)
    rows = (idx_local.to(torch.int64) + starts).reshape(-1)
    v = (vals.to(torch.bfloat16) if round_bf16 else vals).to(torch.float32)
    out = torch.zeros((n_rows, v.shape[1]), dtype=torch.float32,
                      device=vals.device)
    for c in range(v.shape[1]):
        out[:, c].index_add_(0, rows, v[:, c])
    return out


def level_histogram(idx_local: torch.Tensor, vals: torch.Tensor, level_starts,
                    n_rows: int, round_bf16: bool = False) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if idx_local.device.type == "cpu":
        return level_histogram_reference(idx_local, vals, level_starts, n_rows,
                                         round_bf16)
    if idx_local.device.type != "cuda":
        raise ValueError(f"level_histogram: no kernel for {idx_local.device}")
    _check(idx_local, vals, level_starts, n_rows)
    L, Np = idx_local.shape
    idx_local = idx_local.contiguous()
    vals = vals.contiguous()
    C = vals.shape[1]
    out = torch.zeros((n_rows, C), dtype=torch.float32, device=vals.device)
    if out.numel() == 0 or vals.numel() == 0:   # nothing to add: no launch
        return out
    lib = kernels.load("level_histogram")
    fn = (lib.level_histogram_bf16 if vals.dtype == torch.bfloat16
          else lib.level_histogram_f32)
    starts = (ctypes.c_int64 * L)(*[int(s) for s in level_starts])
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        rc = fn(idx_local.data_ptr(), vals.data_ptr(), ctypes.addressof(starts),
                L, Np, C, n_rows, int(round_bf16), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"level_histogram kernel launch failed: CUDA error "
                           f"{rc}")
    trace.count("level_histogram.launches")
    return out

