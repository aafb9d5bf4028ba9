"""Multi-resolution hash grid encoder: the port's encode
(morpheus_tpu_torch/ops/hashgrid.py) on its plain route. Every level gathers
its corner rows with index_select under torch's own autograd, whose
backward is index_add_; a bf16 gradient payload rounds each row's
cotangent before it is added, as tpu.grad_payload states. No kernel, no
packed dense prefix (the port's packing is the same sum in another order).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch


_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF
VJP_MODES = ("hist_rows", "mxu_rows", "sort_pallas_rows", "sort_pallas",
             "sort", "level_scatter", "scatter")
INTERPOLATIONS = ("linear", "smoothstep", "nearest")


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 15
    per_level_scale: float = 2.0
    desired_resolution: int | None = None
    gridtype: str = "hash"          # 'hash' | 'tiled' (no hashing: wraps)
    align_corners: bool = False     # lattice corners on the cube's corners
    # 'linear' (trilinear), 'smoothstep' (trilinear of smoothstepped
    # fractions, gridencoder.cu:143-159) or 'nearest' (one rounded corner,
    # the occupancy queries)
    interpolation: str = "linear"
    vjp_mode: str = "hist_rows"     # embedding-cotangent route, VJP_MODES
    grad_payload: str = "float32"   # 'float32' | 'bfloat16' cotangents

    def __post_init__(self):
        if self.vjp_mode not in VJP_MODES:
            raise ValueError(f"vjp_mode {self.vjp_mode!r} not in {VJP_MODES}")
        if self.interpolation not in INTERPOLATIONS:
            raise ValueError(f"interpolation {self.interpolation!r} not in "
                             f"{INTERPOLATIONS}")
        if self.gridtype not in ("hash", "tiled"):
            raise ValueError(f"gridtype {self.gridtype!r} not in ('hash', "
                             "'tiled')")
        if self.desired_resolution is not None:
            s = np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                        / (self.num_levels - 1))
            object.__setattr__(self, "per_level_scale", float(s))

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def resolutions(self) -> Sequence[int]:
        s = np.log2(self.per_level_scale)
        return tuple(int(np.ceil(np.exp2(l * s) * self.base_resolution))
                     for l in range(self.num_levels))

    @property
    def offsets(self) -> Sequence[int]:
        """Start row of each level's table, then the total (grid.py:125-135)."""
        offs, off = [], 0
        max_params = 2 ** self.log2_hashmap_size
        for res in self.resolutions:
            n = min(max_params, res ** self.input_dim)
            n = int(np.ceil(n / 8) * 8)
            offs.append(off)
            off += n
        offs.append(off)
        return tuple(offs)

    @property
    def table_size(self) -> int:
        return self.offsets[-1]


def init_embeddings(generator: torch.Generator, spec: HashGridSpec,
                    device) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) init (grid.py:145-147)."""
    u = torch.rand((spec.table_size, spec.level_dim), generator=generator,
                   device=device)
    return u * 2e-4 - 1e-4


def _index_consts(spec: HashGridSpec, resolution: int, hashmap_size: int):
    """Static corner-index constants of one level: each axis's dense stride
    (0 once the stride has passed the table) and whether the level hashes
    (a hash grid's level whose lattice overflows the table; a tiled grid
    never hashes and wraps instead)."""
    coef, stride = [], 1
    for _ in range(spec.input_dim):
        coef.append(stride if stride <= hashmap_size else 0)
        stride *= resolution
    return coef, spec.gridtype == "hash" and stride > hashmap_size


def _corner_rows(pos_grid: torch.Tensor, coef: torch.Tensor, hashed,
                 size: torch.Tensor) -> torch.Tensor:
    """Integer corner coordinates (..., D) int64 -> row within the level.

    Dense stride accumulation while the stride fits the table, prime-XOR hash
    otherwise. The reference multiplies in wrapping uint32; here each product
    is taken in int64 and cut to 32 bits before the XOR and the modulo.
    coef (..., D), size (...) and hashed (a bool, or a bool tensor (...))
    broadcast against pos_grid[..., 0]."""
    D = pos_grid.shape[-1]
    if hashed is not True:
        dense = (pos_grid * coef).sum(-1) & _U32
        if hashed is False:
            return dense % size
    h = (pos_grid[..., 0] * _PRIMES[0]) & _U32
    for d in range(1, D):
        h = h ^ ((pos_grid[..., d] * _PRIMES[d]) & _U32)
    if hashed is not True:
        h = torch.where(hashed, h, dense)
    return h % size


def corner_index(spec: HashGridSpec, pos_grid: torch.Tensor, resolution: int,
                 hashmap_size: int) -> torch.Tensor:
    """Row within one level of integer corner coordinates (..., D) int64."""
    coef, hashed = _index_consts(spec, resolution, hashmap_size)
    return _corner_rows(pos_grid, pos_grid.new_tensor(coef), hashed,
                        hashmap_size)


@functools.lru_cache(maxsize=64)
def _starts(starts: tuple, device) -> torch.Tensor:
    # made once per device: a host-to-card copy waits for the card
    return torch.tensor(starts, dtype=torch.int64,
                        device=device).reshape(-1, 1)


class _Rows:
    """Index stream of one gather: level-major local indices (L, Np) int32
    and each level's start row; the flat global rows and their stable sort
    are made when a route first needs them."""

    def __init__(self, local: torch.Tensor, starts: Sequence[int], n_rows: int):
        self.local = local.to(torch.int32)
        self.starts = tuple(int(s) for s in starts)
        self.n_rows = int(n_rows)

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        """Flat global rows (L*Np,) int64."""
        return (self.local.to(torch.int64)
                + _starts(self.starts, self.local.device)).reshape(-1)

    @functools.cached_property
    def sorted(self):
        """(keys (N,) int32, order (N,) int64): the rows in stable order."""
        return torch.sort(self.rows.to(torch.int32), stable=True)


class _RoundGrad(torch.autograd.Function):
    """Identity whose cotangent is rounded to bfloat16 and back: the
    gradient payload that tpu.grad_payload states. Its own backward is
    _Round, so the double backward of the normals sees the f32 values."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Round.apply(g)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)

    @staticmethod
    def backward(ctx, gg):
        return _RoundGrad.apply(gg)


def take_rows(emb: torch.Tensor, idx_local: torch.Tensor,
              starts: Sequence[int], vjp_mode: str = "hist_rows",
              payload_dtype=None, table_dtype=None) -> torch.Tensor:
    """Rows emb[starts[l] + idx_local[l, i]] in level-major order, (L*Np, C),
    gathered with index_select under torch's own autograd (its backward is
    index_add_), whatever vjp_mode names; a bf16 payload_dtype rounds each
    row's cotangent to bfloat16 before it is added into the table."""
    rows = _Rows(idx_local, starts, emb.shape[0])
    if table_dtype is not None:
        emb = emb.to(table_dtype)
    out = emb.index_select(0, rows.rows)
    return _RoundGrad.apply(out) if payload_dtype == torch.bfloat16 else out


class _Levels:
    """Static constants of a run of levels, as tensors that broadcast
    against level-major (levels, corners, P[, D]) work: the lattice
    resolution, each level's table size and corner-index constants, and the
    corner offsets."""

    def __init__(self, spec: HashGridSpec, levels, n_corners: int, device):
        offs, D = spec.offsets, spec.input_dim
        res = [spec.resolutions[l] for l in levels]
        size = [offs[l + 1] - offs[l] for l in levels]
        consts = [_index_consts(spec, r, n) for r, n in zip(res, size)]
        n = len(res)
        self.res = torch.tensor(res, dtype=torch.float32,
                                device=device).reshape(n, 1, 1)
        self.res_max = torch.tensor(res, dtype=torch.int64,
                                    device=device).reshape(n, 1, 1, 1) - 1
        self.size = torch.tensor(size, dtype=torch.int64,
                                 device=device).reshape(n, 1, 1)
        self.coef = torch.tensor([c for c, _ in consts], dtype=torch.int64,
                                 device=device).reshape(n, 1, 1, D)
        hashed = [h for _, h in consts]
        self.hashed = (all(hashed) or (any(hashed) and torch.tensor(
            hashed, device=device).reshape(n, 1, 1)))
        # each level's dense strides (n, 1, D); each corner's bits (corners,
        # 1, D)
        self.strides = torch.tensor(
            [[r ** d for d in range(D)] for r in res], dtype=torch.int64,
            device=device).reshape(n, 1, D)
        self.bits = torch.tensor(
            [[(c >> d) & 1 for d in range(D)] for c in range(n_corners)],
            dtype=torch.int64, device=device).reshape(n_corners, 1, D)
        self.upper = self.bits.bool()


@functools.lru_cache(maxsize=64)
def _levels(spec: HashGridSpec, lo: int, hi: int, n_corners: int,
            device) -> _Levels:
    return _Levels(spec, range(lo, hi), n_corners, device)


def _lattice(x: torch.Tensor, lv: _Levels, align_corners: bool = False):
    """x (P, D) in [0, 1] -> (pos, grid0), each (levels, P, D). Cell
    centres on the lattice (pos = x*res - 0.5, clipped to [0, res-1]), or
    with align_corners the lattice's ends on the cube's (pos = x*(res-1),
    grid0 clipped to [0, res-2]) (JAX hashgrid.py:541-547)."""
    if align_corners:
        pos = x[None] * (lv.res - 1.0)
        return pos, torch.clamp(torch.clamp(torch.floor(pos), min=0.0),
                                max=lv.res - 2.0)
    # clamp, not minimum: a point on the upper bound keeps its gradient
    pos = torch.clamp(torch.clamp(x[None] * lv.res - 0.5, min=0.0),
                      max=lv.res - 1.0)
    return pos, torch.floor(pos)


def _corner_weights(pos, grid0, lv: _Levels, smoothstep: bool = False):
    """Trilinear weight of each corner: (levels, corners, P), the product
    over axes taken in axis order; smoothstep first maps each fraction f to
    f*f*(3 - 2f)."""
    f = (pos - grid0)[:, None]                           # (n, 1, P, D)
    if smoothstep:
        f = f * f * (3.0 - 2.0 * f)
    sel = torch.where(lv.upper, f, 1.0 - f)              # (n, corners, P, D)
    w = sel[..., 0]
    for d in range(1, sel.shape[-1]):
        w = w * sel[..., d]
    return w


def active_count(max_level, num_levels: int) -> int | None:
    """Levels the coarse-to-fine schedule unlocks: clip(ceil(max_level*L), 1,
    L) in float32, as grid.py:42,53 (None when there is no schedule)."""
    if max_level is None:
        return None
    a = int(np.ceil(np.float32(max_level) * np.float32(num_levels)))
    return max(1, min(num_levels, a))


def encode(inputs: torch.Tensor, embeddings: torch.Tensor, spec: HashGridSpec,
           bound: float = 1.0, max_level=None,
           active_levels: int | None = None,
           compute_dtype=None) -> torch.Tensor:
    """Positions in [-bound, bound]^D -> (..., L*C) features.

    max_level (a host float, or a 0-dim float32 tensor on the inputs'
    device, whose mask is then computed there with no host read, as the
    JAX package's traced mask is) zero-fills levels >= ceil(max_level*L);
    active_levels (static int) skips the gather of the levels at or above it
    (exact when no smaller than the max_level count: they are zero either
    way). Out-of-range points encode to zeros.

    compute_dtype torch.bfloat16 gathers from the table cast to bf16 (the
    mixed-precision policy, JAX hashgrid.py:499-506); positions, weights
    and the features stay f32. The JAX package casts before the gather, so
    under the row-gather routes the table cotangent is rounded to bf16
    after its f32 accumulation; under mxu_rows its gather returns f32 and
    the cotangent stays f32, which the cast inside GatherRows keeps."""
    x01 = (inputs + bound) / (2.0 * bound)
    prefix = x01.shape[:-1]
    D = spec.input_dim
    x = x01.reshape(-1, D)
    P = x.shape[0]
    C = embeddings.shape[1]
    dev = x.device
    # sort_pallas keeps f32 payloads whatever grad_payload says (JAX
    # hashgrid.py:81-118)
    pd = (torch.bfloat16 if spec.grad_payload == "bfloat16"
          and spec.vjp_mode != "sort_pallas" else None)
    table_dtype = None
    if compute_dtype is not None and compute_dtype != embeddings.dtype:
        if spec.vjp_mode == "mxu_rows":
            table_dtype = compute_dtype
        else:
            embeddings = embeddings.to(compute_dtype)
    smooth = spec.interpolation == "smoothstep"

    in_range = ((x >= 0.0) & (x <= 1.0)).all(-1, keepdim=True)
    offsets, resolutions = spec.offsets, spec.resolutions
    L_full = spec.num_levels
    L = L_full if active_levels is None else max(1, min(L_full,
                                                        int(active_levels)))
    n_corners = 1 if spec.interpolation == "nearest" else (1 << D)
    active = (torch.clamp(torch.ceil(max_level * float(L_full)), 1.0,
                          float(L_full))
              if isinstance(max_level, torch.Tensor)
              else active_count(max_level, L_full))

    # dense packed prefix (hist_rows only): levels whose whole lattice fits
    # the table gather one (2^D*C)-wide row per site from a table of 2^D
    # shifted copies
    k_pack = 0

    outs = []
    L_u = L - k_pack
    if L_u:
        lv = _levels(spec, k_pack, L, n_corners, dev)
        pos, grid0 = _lattice(x, lv, spec.align_corners)
        if spec.interpolation == "nearest":
            cg = torch.clamp(torch.clamp(torch.round(pos), min=0.0),
                             max=lv.res - 1.0).to(torch.int64)[:, None]
            w = None
        else:
            w = _corner_weights(pos, grid0, lv, smooth)          # (Lu, n, P)
            cg = torch.minimum(grid0.to(torch.int64)[:, None] + lv.bits,
                               lv.res_max)                       # (Lu, n, P, D)
        local = _corner_rows(cg, lv.coef, lv.hashed, lv.size)
        feats = take_rows(embeddings, local.reshape(L_u, -1),
                          offsets[k_pack:L], spec.vjp_mode, pd, table_dtype)
        feats = feats.reshape(L_u, n_corners, P, C)
        outs.append(feats[:, 0].to(x.dtype) if w is None
                    else (w[..., None] * feats).sum(1))          # (Lu, P, C)
    out_l = outs[0] if len(outs) == 1 else torch.cat(outs, 0)   # (L, P, C)

    if isinstance(active, torch.Tensor) or (active is not None
                                            and active < L):
        keep = torch.arange(L, device=dev) < active
        out_l = torch.where(keep[:, None, None], out_l, 0.0)

    out = out_l.permute(1, 0, 2)                                 # (P, L, C)
    if L < L_full:   # statically truncated levels are zero-filled
        out = torch.cat([out, out.new_zeros((P, L_full - L, C))], 1)
    out = out.reshape(P, L_full * C)
    out = torch.where(in_range, out, 0.0)
    return out.reshape(*prefix, L_full * C)
