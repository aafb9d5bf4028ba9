"""Frequency positional encoding with the coarse-to-fine max_level mask
(port of morpheus_tpu/ops/encodings.py::freq_encode)."""
from __future__ import annotations

import functools

import numpy as np
import torch


def freq_output_dim(input_dim: int, n_freqs: int,
                    include_input: bool = True) -> int:
    return input_dim * (1 if include_input else 0) + input_dim * n_freqs * 2


@functools.lru_cache(maxsize=32)
def _freqs(n_freqs: int, dtype, device) -> torch.Tensor:
    # made once per device: a host-to-card copy waits for the card
    return torch.as_tensor(2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs),
                           dtype=dtype, device=device)


def freq_encode(x: torch.Tensor, n_freqs: int, max_level=None,
                include_input: bool = True) -> torch.Tensor:
    """Layout [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] with f_k = 2^k.

    max_level (a host float, or None) zeroes the frequencies at or above
    floor(max_level * n_freqs), computed in float32 as the reference's traced
    schedule does."""
    freqs = _freqs(n_freqs, x.dtype, x.device)
    xb = x[..., None, :] * freqs[:, None]                        # (..., F, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)    # (..., F, 2, D)
    if max_level is not None:
        n_active = int(np.floor(np.float32(max_level) * np.float32(n_freqs)))
        if n_active < n_freqs:
            keep = torch.arange(n_freqs, device=x.device) < n_active
            enc = torch.where(keep[:, None, None], enc, 0.0)
    enc = enc.reshape(*x.shape[:-1], n_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
