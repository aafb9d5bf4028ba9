"""SDF to density (port of morpheus_tpu/ops/density.py)."""
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
