"""Row gather of hash-grid table rows, level by level, exact.

The forward of the hash-grid encode under the row-gather routes
(``hist_rows``, ``sort_pallas_rows``, ``sort_pallas``; ops/hashgrid.py
ROUTES), and the gather of the cotangent table in their double backward.
The JAX package takes these rows with an XLA take, not a Pallas kernel. On a
CUDA tensor this launches the hand-written kernel in kernels/row_gather.cu;
on a CPU tensor it runs the plain version below, index_select on the flat
rows. Nothing falls back: a CUDA call that cannot build or launch the
kernel raises, and so does one whose rows the kernel does not take (it
takes rows of 4 bytes or more whose width is a power of two: the port's
are 4 to 128 bytes).

Contract (both versions), a copy with no rounding:

    row_gather(idx_local (L, Np) int32, emb (T, C) f32|bf16, level_starts
               (L ints)) -> (L*Np, C) in emb's dtype
    out[l*Np + i] = emb[level_starts[l] + idx_local[l, i]]

The kernel reads the level-major local indices and the level starts, as
level_gather and level_histogram do, so the flat int64 rows are not made.
Every index is in range by construction (each level's rows are taken modulo
its size): the kernel checks no bounds, the plain version's index_select
raises on an index out of range.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels, trace

MAX_LEVELS = 64


def _check(idx_local, emb, level_starts):
    if idx_local.dim() != 2 or idx_local.dtype != torch.int32:
        raise ValueError("idx_local must be (L, Np) int32")
    if emb.dim() != 2 or emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"emb must be a (T, C) float32 or bfloat16 table, got "
                         f"{tuple(emb.shape)} {emb.dtype}")
    L = idx_local.shape[0]
    if len(level_starts) != L or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"need 1..{MAX_LEVELS} level starts, one per level")
    if emb.device != idx_local.device:
        raise ValueError("idx_local and emb must be on one device")
    if max(level_starts) > emb.shape[0]:
        raise ValueError("a level starts past the end of the table")


def row_gather_reference(idx_local: torch.Tensor, emb: torch.Tensor,
                         level_starts) -> torch.Tensor:
    """Plain PyTorch version: index_select of the flat global rows."""
    _check(idx_local, emb, level_starts)
    starts = torch.as_tensor(list(level_starts), dtype=torch.int64,
                             device=idx_local.device).reshape(-1, 1)
    return emb.index_select(0, (idx_local.to(torch.int64) + starts)
                            .reshape(-1))


def row_gather(idx_local: torch.Tensor, emb: torch.Tensor,
               level_starts) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if idx_local.device.type == "cpu":
        return row_gather_reference(idx_local, emb, level_starts)
    if idx_local.device.type != "cuda":
        raise ValueError(f"row_gather: no kernel for {idx_local.device}")
    _check(idx_local, emb, level_starts)
    L, Np = idx_local.shape
    idx_local = idx_local.contiguous()
    emb = emb.contiguous()
    out = torch.empty((L * Np, emb.shape[1]), dtype=emb.dtype,
                      device=emb.device)
    if out.numel() == 0:                 # nothing to gather: no launch
        return out
    lib = kernels.load("row_gather")
    starts = (ctypes.c_int64 * L)(*[int(s) for s in level_starts])
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        rc = lib.row_gather(idx_local.data_ptr(), emb.data_ptr(),
                            ctypes.addressof(starts), L, Np,
                            emb.shape[1] * emb.element_size(), out.data_ptr(),
                            stream)
    if rc != 0:
        raise RuntimeError(f"row_gather kernel launch failed on rows of "
                           f"{emb.shape[1] * emb.element_size()} bytes: CUDA "
                           f"error {rc}")
    trace.count("row_gather.launches")
    return out

