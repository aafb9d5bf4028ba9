"""Frequency positional encoding with the coarse-to-fine max_level mask, and
the real spherical-harmonics direction basis (port of
morpheus_tpu/ops/encodings.py: freq_encode, sh_encode)."""
from __future__ import annotations

import functools
import math

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

    max_level (a host float, a 0-dim float32 tensor on x's device, or None)
    zeroes the frequencies at or above floor(max_level * n_freqs), computed
    in float32 as the reference's traced schedule does; a tensor's mask is
    computed on the device, with no host read."""
    freqs = _freqs(n_freqs, x.dtype, x.device)
    xb = x[..., None, :] * freqs[:, None]                        # (..., F, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)    # (..., F, 2, D)
    if isinstance(max_level, torch.Tensor):
        keep = (torch.arange(n_freqs, device=x.device)
                < torch.floor(max_level * float(n_freqs)))
        enc = torch.where(keep[:, None, None], enc, 0.0)
    elif max_level is not None:
        n_active = int(np.floor(np.float32(max_level) * np.float32(n_freqs)))
        if n_active < n_freqs:
            keep = torch.arange(n_freqs, device=x.device) < n_active
            enc = torch.where(keep[:, None, None], enc, 0.0)
    enc = enc.reshape(*x.shape[:-1], n_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def sh_output_dim(degree: int) -> int:
    return degree * degree


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit directions (..., 3), degrees 1-8:
    Y_{l,m} for l < degree, m in [-l, l], degree^2 values (JAX
    encodings.py:52-107). Associated Legendre recurrences in cos(theta) = z
    with the sin(theta)^m factor carried by the azimuthal terms A_m, B_m
    (st^m cos(m phi), st^m sin(m phi), recurred from x and y)."""
    if not 1 <= degree <= 8:
        raise ValueError(f"degree {degree} not in 1..8")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    L = degree
    pt = {(0, 0): torch.ones_like(z)}
    for m in range(1, L):
        pt[(m, m)] = pt[(m - 1, m - 1)] * (2 * m - 1)
    for m in range(L):
        if m + 1 < L:
            pt[(m + 1, m)] = z * (2 * m + 1) * pt[(m, m)]
        for l in range(m + 2, L):
            pt[(l, m)] = ((2 * l - 1) * z * pt[(l - 1, m)]
                          - (l + m - 1) * pt[(l - 2, m)]) / (l - m)
    a, b = {0: torch.ones_like(x)}, {0: torch.zeros_like(x)}
    for m in range(1, L):
        a[m] = x * a[m - 1] - y * b[m - 1]
        b[m] = x * b[m - 1] + y * a[m - 1]
    out = []
    for l in range(L):
        row = [None] * (2 * l + 1)
        row[l] = math.sqrt((2 * l + 1) / (4.0 * math.pi)) * pt[(l, 0)]
        for m in range(1, l + 1):
            k = math.sqrt((2 * l + 1) / (2.0 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            row[l + m] = k * pt[(l, m)] * a[m]
            row[l - m] = k * pt[(l, m)] * b[m]
        out.extend(row)
    return torch.stack(out, -1)
