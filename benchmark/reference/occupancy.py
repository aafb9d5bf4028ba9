"""Occupancy grid and fixed-shape ray marching
(port of morpheus_tpu/ops/occupancy.py).

Random numbers come from a `Draws` source by name (utils.Draws), so tests can
replay the reference's draws. Top-k selections use a stable descending sort:
the reference's approx_max_k is exact off the TPU and breaks ties toward the
lower index, and so does a stable sort.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .local import LOCAL
from . import volrender


class OccupancyState(NamedTuple):
    occs: torch.Tensor      # (R^3,) float32 EMA density*step estimates
    binaries: torch.Tensor  # (R, R, R) bool


def init_occupancy(resolution: int, device) -> OccupancyState:
    return OccupancyState(
        occs=torch.zeros((resolution ** 3,), dtype=torch.float32,
                         device=device),
        binaries=torch.ones((resolution,) * 3, dtype=torch.bool,
                            device=device))


@functools.lru_cache(maxsize=4)
def cell_centers(resolution: int, bound: float, device) -> torch.Tensor:
    """(R^3, 3) float32 cell centres of the grid over [-bound, bound]^3,
    made once per device (a host-to-card copy waits for the card)."""
    g = (np.arange(resolution) + 0.5) / resolution
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (np.stack([x, y, z], -1).reshape(-1, 3) * 2.0 - 1.0) * bound
    return torch.as_tensor(c.astype(np.float32), device=device)


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, largest first,
    ties toward the lower index."""
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def update_occupancy(state: OccupancyState, draws, density_fn, step: int,
                     bound: float, step_size: float, *, warmup_steps: int = 256,
                     ema_decay: float = 0.95, threshold: float = 0.01,
                     sample_fraction: float = 0.25) -> OccupancyState:
    """One EMA update over every cell (all cells while step < warmup_steps,
    otherwise a random sample of them). density_fn(x (M, 3)) -> sigma (M,)."""
    R = state.binaries.shape[0]
    n_cells = R ** 3
    dev = state.occs.device
    centers = cell_centers(R, bound, dev)
    cell = 2.0 * bound / R
    jitter = (draws.uniform("occ_jitter", (n_cells, 3)) - 0.5) * cell
    n_sample = int(n_cells * sample_fraction)
    sel = draws.randint("occ_sel", (n_sample,), 0, n_cells)

    occ_new = density_fn(centers + jitter).reshape(-1) * step_size
    if step < warmup_steps:
        update_mask = torch.ones((n_cells,), dtype=torch.bool, device=dev)
    else:
        update_mask = torch.zeros((n_cells,), dtype=torch.bool, device=dev)
        update_mask[sel] = True
    occs = torch.where(update_mask,
                       torch.maximum(state.occs * ema_decay, occ_new),
                       state.occs)
    thresh = torch.clamp(occs.mean(), max=threshold)
    return OccupancyState(occs=occs, binaries=(occs > thresh).reshape(R, R, R))


def update_occupancy_sampled(state: OccupancyState, draws, density_fn,
                             bound: float, step_size: float, *,
                             ema_decay: float = 0.95, threshold: float = 0.01,
                             sample_fraction: float = 0.25,
                             update_index: int | None = None
                             ) -> OccupancyState:
    """Post-warmup update of R^3*fraction cells. With `update_index` the
    cells follow the strided rotation sel_i = (k*n + i)*stride mod R^3 (the
    reference computes it in wrapping uint32; so does this, in int64 cut to
    32 bits), which visits every cell once per 1/fraction updates."""
    R = state.binaries.shape[0]
    n_cells = R ** 3
    n_sample = max(1, int(n_cells * sample_fraction))
    dev = state.occs.device
    if update_index is None:
        sel = draws.randint("occ_sel", (n_sample,), 0, n_cells)
    else:
        u32 = 0xFFFFFFFF
        stride = (2654435761 % n_cells) | 1
        base = ((update_index * n_sample) & u32) + torch.arange(
            n_sample, dtype=torch.int64, device=dev)
        sel = (((base & u32) * stride) & u32) % n_cells
    centers = cell_centers(R, bound, dev)[sel]
    cell = 2.0 * bound / R
    jitter = (draws.uniform("occ_jitter", (n_sample, 3)) - 0.5) * cell

    occ_new = density_fn(centers + jitter).reshape(-1) * step_size
    occs = state.occs.clone()
    occs[sel] = torch.maximum(state.occs[sel] * ema_decay, occ_new)
    thresh = torch.clamp(occs.mean(), max=threshold)
    return OccupancyState(occs=occs, binaries=(occs > thresh).reshape(R, R, R))


def ray_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: float,
             eps: float = 1e-9):
    """Slab-test ray/AABB intersection -> (t_near, t_far), t_near >= 0."""
    inv_d = 1.0 / torch.where(torch.abs(rays_d) < eps,
                              torch.sign(rays_d) * eps + eps, rays_d)
    t0 = (-bound - rays_o) * inv_d
    t1 = (bound - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    return torch.clamp(t_near, min=0.0), t_far


def occs_lookup(occs: torch.Tensor, resolution: int, x: torch.Tensor,
                bound: float) -> torch.Tensor:
    """Float EMA occupancy of points x (..., 3)."""
    R = resolution
    idx = torch.clamp(((x + bound) / (2.0 * bound) * R).to(torch.int64),
                      0, R - 1)
    flat = (idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2]
    return occs[flat]


def march_rays(draws, state: OccupancyState, rays_o: torch.Tensor,
               rays_d: torch.Tensor, bound: float, step_size: float,
               march_steps: int, max_samples: int,
               score_uniform_mix: float = 0.0, occ_threshold: float = 0.01):
    """Occupancy-culled marching: `march_steps` stratified fixed steps from
    the AABB entry, masked by the grid, of which the `max_samples` with the
    largest approximate rendering weight are kept (ties toward earlier
    samples). Returns (t_starts, t_ends, mask, score), each (N, K)."""
    N = rays_o.shape[0]
    M, K = march_steps, max_samples
    t_near, t_far = ray_aabb(rays_o, rays_d, bound)
    jitter = draws.uniform("march", (N, 1))

    steps = torch.arange(M, dtype=torch.float32, device=rays_o.device)[None]
    t0 = t_near[:, None] + (steps + jitter) * step_size
    t1 = t0 + step_size
    tm = 0.5 * (t0 + t1)

    inside = tm < t_far[:, None]
    xs = rays_o[:, None, :] + rays_d[:, None, :] * tm[..., None]
    R = state.binaries.shape[0]
    # the binaries are exactly occs > min(mean, threshold), so the mask comes
    # from the one float lookup; a never-updated grid counts as all occupied
    o_val = occs_lookup(state.occs, R, xs, bound)
    mean = state.occs.mean()
    thresh = torch.clamp(mean, max=occ_threshold)
    occ = ((o_val > thresh) | (mean == 0.0)) & inside
    tau = torch.where(occ, torch.clamp(o_val, 0.0, 20.0), 0.0)
    tau_cum = torch.cat([torch.zeros_like(tau[:, :1]),
                         torch.cumsum(tau, -1)[:, :-1]], -1)
    w_approx = -torch.expm1(-tau) * torch.exp(-tau_cum)
    front_bias = (M - steps) / M * 1e-6
    score = torch.where(occ, w_approx + front_bias + 1e-8, -1.0)
    if score_uniform_mix > 0.0:
        u = draws.uniform("march_mix", (N, M))
        score = torch.where(occ, score + score_uniform_mix * u, score)

    idx = torch.sort(top_k_indices(score, K), dim=-1).values     # ascending t
    t_starts = torch.gather(t0, 1, idx)
    t_ends = torch.gather(t1, 1, idx)
    mask = torch.gather(occ, 1, idx)
    t_starts = torch.where(mask, t_starts, 0.0)
    t_ends = torch.where(mask, t_ends, 0.0)
    return t_starts, t_ends, mask, torch.gather(score, 1, idx)


def compact_samples(t_starts, t_ends, mask, score, budget: int,
                    rays=None) -> dict:
    """Keep the top-`budget` samples of the (N, K) grid by march score, as a
    flat ray-sorted stream: ray_id (B,) nondecreasing, t_starts/t_ends (B,),
    valid (B,), starts (N+1,) segment boundaries, and `rows`, the stream's
    place in the global one. `rays` (parallel.sharding.Rows; None: one
    process) places the N rays in the global batch: the top-k runs over the
    whole batch's scores and this rank keeps its own rays' samples, a
    contiguous run of the global stream, at the fixed size of rows
    (Rows.split_sorted): its padding entries are inert, not valid, at t 0
    of this rank's last ray (a copy of a real ray), and past every segment
    (starts[N] counts the members; volrender.Segments(padded=True) sends
    them to no ray's slot)."""
    N, K = mask.shape
    if rays is None:
        rays = LOCAL.rows(N)
    flat_score = rays.gather(torch.where(mask, score, -torch.inf))
    perm = torch.sort(top_k_indices(flat_score.reshape(-1),
                                    int(budget))).values
    perm, rows = rays.split_sorted(perm, K)
    ray_id = torch.div(perm, K, rounding_mode="floor")
    t_starts = t_starts.reshape(-1).index_select(0, perm)
    t_ends = t_ends.reshape(-1).index_select(0, perm)
    valid = mask.reshape(-1).index_select(0, perm)
    member = rows.members()
    if member is None:
        starts = volrender.segment_starts(ray_id, N)
    else:
        t_starts = torch.where(member, t_starts, 0.0)
        t_ends = torch.where(member, t_ends, 0.0)
        valid = valid & member
        starts = volrender.segment_starts(torch.where(member, ray_id, N), N)
    return {"ray_id": ray_id, "t_starts": t_starts, "t_ends": t_ends,
            "valid": valid, "starts": starts, "rows": rows}
