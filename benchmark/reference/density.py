"""SDF to density, and the exp and softplus activations (port of
morpheus_tpu/ops/density.py)."""
from __future__ import annotations

import torch

BETA_MIN = 1e-4


def laplace_beta(beta_param: torch.Tensor) -> torch.Tensor:
    """Effective beta = |beta| + beta_min (models/density.py:29-31)."""
    return torch.abs(beta_param) + BETA_MIN


def laplace_density(sdf: torch.Tensor, beta_param: torch.Tensor) -> torch.Tensor:
    """VolSDF Laplace CDF density alpha * Laplace(0, beta).cdf(-sdf)."""
    beta = laplace_beta(beta_param)
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf)
                    * torch.expm1(-torch.abs(sdf) / beta))


class _TruncExp(torch.autograd.Function):
    """exp whose derivative is exp(min(x, 15)) (models/model.py:16-29, the
    JAX package's custom_jvp)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def biased_softplus(x: torch.Tensor, bias: float = 0.0) -> torch.Tensor:
    return torch.nn.functional.softplus(x + bias)
