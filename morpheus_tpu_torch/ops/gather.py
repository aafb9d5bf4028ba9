"""Per-level gather of hash-grid table rows through a bf16 split.

Port of morpheus_tpu/ops/gather_pallas.py::level_gather together with its
packer pack_level_table: the forward of the hash-grid encode under
``vjp_mode: mxu_rows``. Each gathered f32 value x is split into bf16 planes
t1 = bf16(x), t2 = bf16(x - t1), t3 = bf16(x - t1 - t2) (round to nearest
even, f32 differences) and the result is t1 (one plane, the bf16 payload) or
(t1 + t2) + t3 in f32 (three planes, f32 to within one ulp). On a CUDA tensor
this launches the hand-written kernel in kernels/level_gather.cu; on a CPU
tensor it runs the plain version below. Nothing falls back: a CUDA call that
cannot build or launch the kernel raises.

Contract (both versions):

    level_gather(idx_local (L, Np) int32, emb (T, C) f32|bf16, level_starts
                 (L ints), n_split 1|3) -> (L*Np, C) f32
    out[l*Np + i, c] = split_sum(emb[level_starts[l] + idx_local[l, i], c])

A bf16 table (the bfloat16 mixed-precision policy casts the table before
the gather) is read as it is: each split of a bf16 value is the value, so
n_split does not change a result and the kernel widens the bf16 row.

Level l's rows run from level_starts[l] to the next level's start (the
table's end for the last level). Unlike the TPU kernel, which reads tables
repacked as (L, T/128, 128*C) bf16 planes on every call and returns
(C, L*Np), the kernel reads the (T, C) f32 table itself, splits the one
value it needs, and writes the (N, C) row layout: the repack folds into it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels, trace

WIN = 128           # lanes of one packed table row (gather_pallas.WIN)
MAX_LEVELS = 64


def _check(idx_local, emb, level_starts, n_split):
    if idx_local.dim() != 2 or idx_local.dtype != torch.int32:
        raise ValueError("idx_local must be (L, Np) int32")
    if emb.dim() != 2 or emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"emb must be a (T, C) float32 or bfloat16 table, got "
                         f"{tuple(emb.shape)} {emb.dtype}")
    L = idx_local.shape[0]
    if len(level_starts) != L or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"need 1..{MAX_LEVELS} level starts, one per level")
    if n_split not in (1, 3):
        raise ValueError(f"n_split must be 1 or 3, got {n_split}")
    if emb.device != idx_local.device:
        raise ValueError("idx_local and emb must be on one device")
    if max(level_starts) > emb.shape[0]:
        raise ValueError("a level starts past the end of the table")


def pack_level_table(emb: torch.Tensor, offsets, n_levels: int, t_pad: int,
                     n_split: int) -> tuple:
    """Literal port of gather_pallas.pack_level_table: the slices
    emb[offsets[l]:offsets[l+1]], zero-padded to a common t_pad (rounded up
    to WIN), laid out (L, t_hi, C*WIN) with lane c*WIN + lo holding row
    hi*WIN + lo, split into n_split bf16 planes."""
    C = emb.shape[1]
    t_pad = (max(t_pad, WIN) + WIN - 1) // WIN * WIN
    t_hi = t_pad // WIN
    levels = []
    for l in range(n_levels):
        e = emb[offsets[l]:offsets[l + 1]]
        if e.shape[0] < t_pad:
            e = torch.cat([e, e.new_zeros((t_pad - e.shape[0], C))])
        levels.append(e.reshape(t_hi, WIN, C).permute(0, 2, 1)
                      .reshape(t_hi, C * WIN))
    tab = torch.stack(levels)                             # (L, t_hi, C*WIN)
    t1 = tab.to(torch.bfloat16)
    if n_split == 1:
        return (t1,)
    r1 = tab - t1.to(tab.dtype)
    t2 = r1.to(torch.bfloat16)
    t3 = (r1 - t2.to(tab.dtype)).to(torch.bfloat16)
    return (t1, t2, t3)


def level_gather_reference(idx_local: torch.Tensor, emb: torch.Tensor,
                           level_starts, n_split: int) -> torch.Tensor:
    """Plain PyTorch version: pack_level_table, select each index's lane
    from every plane, then sum the planes in f32 in order, (t1 + t2) + t3."""
    _check(idx_local, emb, level_starts, n_split)
    L, Np = idx_local.shape
    C = emb.shape[1]
    offsets = [int(s) for s in level_starts] + [emb.shape[0]]
    t_pad = max(offsets[l + 1] - offsets[l] for l in range(L))
    tabs = pack_level_table(emb, offsets, L, t_pad, n_split)
    idx = idx_local.to(torch.int64)
    hi, lo = (idx // WIN)[..., None], (idx % WIN)[..., None]  # (L, Np, 1)
    lvl = torch.arange(L, device=idx.device).reshape(L, 1, 1)
    chan = torch.arange(C, device=idx.device)
    out = None
    for tab in tabs:
        sel = tab.reshape(L, -1, C, WIN)[lvl, hi, chan, lo].to(torch.float32)
        out = sel if out is None else out + sel           # (L, Np, C)
    return out.reshape(L * Np, C)


def level_gather(idx_local: torch.Tensor, emb: torch.Tensor, level_starts,
                 n_split: int) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if idx_local.device.type == "cpu":
        return level_gather_reference(idx_local, emb, level_starts, n_split)
    if idx_local.device.type != "cuda":
        raise ValueError(f"level_gather: no kernel for {idx_local.device}")
    _check(idx_local, emb, level_starts, n_split)
    L, Np = idx_local.shape
    idx_local = idx_local.contiguous()
    emb = emb.contiguous()
    T, C = emb.shape
    out = torch.empty((L * Np, C), dtype=torch.float32, device=emb.device)
    if out.numel() == 0:                 # nothing to gather: no launch
        return out
    lib = kernels.load("level_gather")
    fn = (lib.level_gather_bf16 if emb.dtype == torch.bfloat16
          else lib.level_gather_s1 if n_split == 1 else lib.level_gather_s3)
    starts = (ctypes.c_int64 * L)(*[int(s) for s in level_starts])
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        rc = fn(idx_local.data_ptr(), emb.data_ptr(), ctypes.addressof(starts),
                L, Np, C, T, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"level_gather kernel launch failed: CUDA error "
                           f"{rc}")
    trace.count("level_gather.launches")
    return out

