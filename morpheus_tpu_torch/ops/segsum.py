"""Segment sum of a sorted update stream.

Port of morpheus_tpu/ops/segsum_pallas.py::segment_sum_sorted and
segment_sum_unsorted. The hash-grid backward under ``vjp_mode``
``sort_pallas_rows`` and ``sort_pallas`` sorts its rows and sums each run of
equal rows of the (row, cotangent) stream into the embedding table. On a
CUDA tensor this launches the hand-written kernel in
kernels/segment_sum_sorted.cu; on a CPU tensor it runs the plain version
below. Nothing falls back: a CUDA call that cannot build or launch the kernel
raises.

Contract (both versions):

    segment_sum_sorted(sorted_idx (N,) int32, vals (N, C) f32|bf16, size,
                       order=None, round_bf16=False) -> (size, C) f32
    out[sorted_idx[i], c] += float(r(vals[order[i], c]))

order is None (the identity) or the (N,) int64 permutation that sorted the
rows (``torch.sort(..., stable=True).indices``), so the payload is read
through the sort's order instead of being permuted first, as the JAX package
carries it through its multi-operand lax.sort. r rounds an f32 payload to bf16
(to nearest even, as ``.to(torch.bfloat16)``) under round_bf16 and is the
identity otherwise; sums are f32. sorted_idx must be nondecreasing (the
kernel's sum is wrong for another order); keys outside [0, size) are dropped.
Unlike the TPU kernel's (C, size) output, the result is the (T, C) table
layout. The kernel writes every row once, in an order of additions fixed by
the shapes, so two calls give the same bits. The sort stays outside, as
lax.sort does in the JAX package.
"""
from __future__ import annotations

import torch

from .. import kernels, trace


def _check(sorted_idx, vals, size, order):
    if sorted_idx.dim() != 1 or sorted_idx.dtype != torch.int32:
        raise ValueError("sorted_idx must be (N,) int32")
    N = sorted_idx.shape[0]
    if vals.dim() != 2 or vals.shape[0] != N:
        raise ValueError(f"vals must be (N, C) = ({N}, C), got "
                         f"{tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals dtype {vals.dtype} not in (float32, bfloat16)")
    if vals.device != sorted_idx.device:
        raise ValueError("sorted_idx and vals must be on one device")
    if order is not None:
        if order.dtype != torch.int64 or tuple(order.shape) != (N,):
            raise ValueError(f"order must be ({N},) int64, got "
                             f"{tuple(order.shape)} {order.dtype}")
        if order.device != sorted_idx.device:
            raise ValueError("order must be on the device of sorted_idx")
    if size < 0:
        raise ValueError("size must be >= 0")


def segment_sum_sorted_reference(sorted_idx: torch.Tensor, vals: torch.Tensor,
                                 size: int, order: torch.Tensor | None = None,
                                 round_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the payload permuted by order, rounded to bf16
    under round_bf16, then per-channel index_add_ into an f32 table."""
    _check(sorted_idx, vals, size, order)
    v = vals if order is None else vals.index_select(0, order)
    if round_bf16:
        v = v.to(torch.bfloat16)
    v = v.to(torch.float32)
    rows = sorted_idx.to(torch.int64)
    keep = (rows >= 0) & (rows < size)
    if not bool(keep.all()):
        rows, v = rows[keep], v[keep]
    out = torch.zeros((size, v.shape[1]), dtype=torch.float32,
                      device=vals.device)
    for c in range(v.shape[1]):
        out[:, c].index_add_(0, rows, v[:, c])
    return out


def segment_sum_sorted(sorted_idx: torch.Tensor, vals: torch.Tensor,
                       size: int, order: torch.Tensor | None = None,
                       round_bf16: bool = False) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if sorted_idx.device.type == "cpu":
        return segment_sum_sorted_reference(sorted_idx, vals, size, order,
                                            round_bf16)
    if sorted_idx.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: no kernel for "
                         f"{sorted_idx.device}")
    _check(sorted_idx, vals, size, order)
    sorted_idx = sorted_idx.contiguous()
    vals = vals.contiguous()
    N, C = vals.shape
    if size == 0 or N == 0:   # nothing to add: no launch
        return torch.zeros((size, C), dtype=torch.float32, device=vals.device)
    lib = kernels.load("segment_sum_sorted")
    fn = (lib.segment_sum_sorted_bf16 if vals.dtype == torch.bfloat16
          else lib.segment_sum_sorted_f32)
    # every row is written by the kernel: no zero-fill
    out = torch.empty((size, C), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        scratch = torch.empty(
            (lib.segment_sum_sorted_scratch_bytes(N, C, size),),
            dtype=torch.uint8, device=vals.device)
        rc = fn(sorted_idx.data_ptr(), vals.data_ptr(),
                None if order is None else order.contiguous().data_ptr(), N,
                C, size, int(round_bf16), out.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum_sorted kernel launch failed: CUDA "
                           f"error {rc}")
    trace.count("segment_sum_sorted.launches")
    return out



def segment_sum_unsorted(idx: torch.Tensor, vals: torch.Tensor,
                         size: int) -> torch.Tensor:
    """Stable sort by index, then segment_sum_sorted reading the float32
    payload through the sort's order, as the JAX package sorts it along."""
    keys, order = torch.sort(idx.to(torch.int32), stable=True)
    return segment_sum_sorted(keys, vals.to(torch.float32), size, order=order)
