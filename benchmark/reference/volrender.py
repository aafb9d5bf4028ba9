"""Volume-rendering integration on a flat ray-sorted sample stream, and on
a dense (N, K) grid of samples (port of morpheus_tpu/ops/volrender.py: the
flat_* functions, render_weights and accumulate).

Per-ray prefix sums are taken exactly per ray, never as one global f32 prefix
over the whole stream: each ray owns at most K (max_samples) consecutive
samples, so the stream is scattered into a dense (N, K) layout at
(ray, i - starts[ray]) and summed along K.
"""
from __future__ import annotations

import torch


def segment_starts(ray_id: torch.Tensor, num_rays: int) -> torch.Tensor:
    """(N+1,) boundaries: ray r owns [starts[r], starts[r+1])."""
    return torch.searchsorted(
        ray_id, torch.arange(num_rays + 1, dtype=ray_id.dtype,
                             device=ray_id.device))


class Segments:
    """Where each sample of a ray-sorted (B,) stream sits in the dense
    (N, K) per-ray layout. A `padded` stream (occupancy.compact_samples
    under a process group) ends in entries past its last segment,
    starts[N] onwards: they go to a slot past the layout, dropped."""

    def __init__(self, ray_id: torch.Tensor, starts: torch.Tensor, K: int,
                 padded: bool = False):
        self.ray_id, self.starts, self.K = ray_id, starts, int(K)
        self.N = starts.shape[0] - 1
        self.padded = padded
        i = torch.arange(ray_id.shape[0], device=ray_id.device)
        self.slot = ray_id * self.K + (i - starts[ray_id])
        if padded:
            self.slot = torch.where(i < starts[-1], self.slot,
                                    self.N * self.K)

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        """(B, ...) -> (N, K, ...), zeros where a ray has fewer samples."""
        size = self.N * self.K
        z = x.new_zeros((size + self.padded,) + x.shape[1:])
        z = z.index_copy(0, self.slot, x)
        if self.padded:
            z = z[:size]
        return z.reshape((self.N, self.K) + x.shape[1:])


def seg_cumsum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Inclusive per-ray cumulative sum of x (B,) or (B, C) (0 at a padded
    stream's padding)."""
    cs = torch.cumsum(seg.dense(x), dim=1).reshape(
        (seg.N * seg.K,) + x.shape[1:])
    if seg.padded:
        cs = torch.cat([cs, cs.new_zeros((1,) + x.shape[1:])])
    return cs.index_select(0, seg.slot)


def flat_segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Per-ray sums of x (B,) or (B, C) -> (N,) or (N, C); 0 for empty rays."""
    return seg.dense(x).sum(1)


def flat_render_weights(t_starts, t_ends, sigmas, valid, seg: Segments):
    """alpha_i = 1 - exp(-sigma_i dt_i), T_i = exp(-sum_{j<i} sigma_j dt_j)
    per ray, w_i = alpha_i T_i; invalid samples carry zero optical depth.
    Returns (weights, trans, alphas), each (B,)."""
    dt = t_ends - t_starts
    tau = torch.where(valid, sigmas * dt, 0.0)
    cum = seg_cumsum(tau, seg)
    trans = torch.exp(-(cum - tau))              # exclusive per-ray prefix
    alphas = -torch.expm1(-tau)
    weights = torch.where(valid, alphas * trans, 0.0)
    return weights, trans, alphas


def flat_accumulate(weights, values, seg: Segments):
    """Per-ray sum of w_i v_i: (N, C), or (N, 1) when values is None."""
    x = weights[:, None] if values is None else weights[:, None] * values
    return flat_segment_sum(x, seg)


def render_weights(t_starts, t_ends, sigmas, mask):
    """The flat_render_weights arithmetic on a dense (N, K) grid: invalid
    samples carry zero optical depth. Returns (weights, trans, alphas),
    each (N, K)."""
    dt = t_ends - t_starts
    tau = torch.where(mask, sigmas * dt, 0.0)
    tau_shift = torch.cat([torch.zeros_like(tau[..., :1]),
                           torch.cumsum(tau, dim=-1)[..., :-1]], -1)
    trans = torch.exp(-tau_shift)
    alphas = -torch.expm1(-tau)
    weights = torch.where(mask, alphas * trans, 0.0)
    return weights, trans, alphas


def accumulate(weights, values=None):
    """Sum of w_i v_i along the sample axis (..., K) -> (..., C), or of the
    weights alone (..., 1) when values is None."""
    if values is None:
        return weights.sum(-1, keepdim=True)
    return (weights[..., None] * values).sum(-2)
