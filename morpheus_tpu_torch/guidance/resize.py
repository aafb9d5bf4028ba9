"""Image resize with jax.image.resize's semantics (bilinear and bicubic),
for NCHW tensors.

jax.image.resize is scale_and_translate with antialiasing: each output
sample is a weighted sum of input samples under a kernel (triangle for
bilinear, Keys cubic with a = -0.5 for bicubic) that is widened by the
scale when downscaling, with the weights renormalised over the in-bounds
taps. torch's F.interpolate differs on both counts (bicubic a = -0.75, no
antialias). Here each axis's weight matrix is built once on the host and
applied as a matmul, so the resize is differentiable and exact to the JAX
one up to float32 round-off.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


KERNELS = {"bilinear": _triangle, "linear": _triangle,
           "bicubic": _keys_cubic, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float32 weights of one axis (jax/_src/image/scale.py
    compute_weight_mat, scale n_out/n_in, no translation, antialias on),
    computed in float32 as JAX computes them."""
    f = np.float32
    inv_scale = f(1.0) / (f(n_out) / f(n_in))
    kernel_scale = max(inv_scale, f(1.0))
    sample_f = ((np.arange(n_out, dtype=f) + f(0.5)) * inv_scale - f(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f)[:, None]) \
        / kernel_scale
    w = KERNELS[method](x).astype(f)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def resize(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) as jax.image.resize(method)
    resizes the two spatial axes."""
    H, W = x.shape[-2:]
    Ho, Wo = size
    if (H, W) == (Ho, Wo):
        return x
    wh = _weights(H, Ho, method, x.dtype, x.device)
    ww = _weights(W, Wo, method, x.dtype, x.device)
    return torch.matmul(torch.matmul(wh.transpose(0, 1), x), ww)


@functools.lru_cache(maxsize=64)
def _weights(n_in: int, n_out: int, method: str, dtype, device
             ) -> torch.Tensor:
    """weight_matrix on `device`, copied there once: a copy from host
    memory waits for the card, and a CUDA graph cannot capture one."""
    return torch.as_tensor(weight_matrix(n_in, n_out, method), device=device,
                           dtype=dtype)
