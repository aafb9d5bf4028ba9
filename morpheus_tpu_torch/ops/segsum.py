"""Segment sum of a sorted update stream.

Port of morpheus_tpu/ops/segsum_pallas.py::segment_sum_sorted and
segment_sum_unsorted. The hash-grid backward under ``vjp_mode``
``sort_pallas_rows`` and ``sort_pallas`` sorts its (row, cotangent) stream by
row and sums each run of equal rows into the embedding table. On a CUDA
tensor this launches the hand-written kernel in kernels/segment_sum_sorted.cu;
on a CPU tensor it runs the plain version below. Nothing falls back: a CUDA
call that cannot build or launch the kernel raises.

Contract (both versions):

    segment_sum_sorted(sorted_idx (N,) int32, vals (N, C) f32|bf16, size)
        -> (size, C) f32
    out[sorted_idx[i], c] += float(vals[i, c])

sorted_idx should be nondecreasing: the kernel is right for any order but
only fast for a sorted one. Unlike the TPU kernel's (C, size) output, the
result is the (T, C) table layout. bf16 payloads are rounded by the caller
and summed in f32. The sort stays outside the kernel, as lax.sort does in the
JAX package.
"""
from __future__ import annotations

import torch

from .. import kernels


def _check(sorted_idx, vals, size):
    if sorted_idx.dim() != 1 or sorted_idx.dtype != torch.int32:
        raise ValueError("sorted_idx must be (N,) int32")
    if vals.dim() != 2 or vals.shape[0] != sorted_idx.shape[0]:
        raise ValueError(f"vals must be (N, C) = ({sorted_idx.shape[0]}, C), "
                         f"got {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals dtype {vals.dtype} not in (float32, bfloat16)")
    if vals.device != sorted_idx.device:
        raise ValueError("sorted_idx and vals must be on one device")
    if size < 0:
        raise ValueError("size must be >= 0")


def segment_sum_sorted_reference(sorted_idx: torch.Tensor, vals: torch.Tensor,
                                 size: int) -> torch.Tensor:
    """Plain PyTorch version: per-channel index_add_ of the (already rounded)
    values into an f32 table."""
    _check(sorted_idx, vals, size)
    rows = sorted_idx.to(torch.int64)
    v = vals.to(torch.float32)
    out = torch.zeros((size, v.shape[1]), dtype=torch.float32,
                      device=vals.device)
    for c in range(v.shape[1]):
        out[:, c].index_add_(0, rows, v[:, c])
    return out


def segment_sum_sorted(sorted_idx: torch.Tensor, vals: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if sorted_idx.device.type == "cpu":
        return segment_sum_sorted_reference(sorted_idx, vals, size)
    if sorted_idx.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: no kernel for "
                         f"{sorted_idx.device}")
    _check(sorted_idx, vals, size)
    sorted_idx = sorted_idx.contiguous()
    vals = vals.contiguous()
    N, C = vals.shape
    out = torch.zeros((size, C), dtype=torch.float32, device=vals.device)
    if out.numel() == 0 or N == 0:   # nothing to add: no launch
        return out
    lib = kernels.load("segment_sum_sorted")
    fn = (lib.segment_sum_sorted_bf16 if vals.dtype == torch.bfloat16
          else lib.segment_sum_sorted_f32)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        rc = fn(sorted_idx.data_ptr(), vals.data_ptr(), N, C, size,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum_sorted kernel launch failed: CUDA "
                           f"error {rc}")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0


def segment_sum_unsorted(idx: torch.Tensor, vals: torch.Tensor,
                         size: int) -> torch.Tensor:
    """Stable sort by index, then segment_sum_sorted; the payload travels as
    float32, as in the JAX package."""
    keys, order = torch.sort(idx.to(torch.int32), stable=True)
    return segment_sum_sorted(keys, vals.to(torch.float32).index_select(
        0, order), size)
