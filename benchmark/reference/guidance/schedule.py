"""Diffusion noise schedule and DDIM stepping (port of
morpheus_tpu/guidance/schedule.py; reference: diffusers DDIMScheduler as
configured in zero123_utils.py:75-87, ldm/models/diffusion/ddpm.py).

Zero123: 1000 timesteps, scaled_linear betas in [0.00085, 0.012],
clip_sample=False, set_alpha_to_one=False, steps_offset=1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012

    @property
    def betas(self) -> np.ndarray:
        # 'scaled_linear': linear in sqrt(beta), in float64
        return np.linspace(self.linear_start ** 0.5, self.linear_end ** 0.5,
                           self.num_train_timesteps, dtype=np.float64) ** 2

    @property
    def alphas_cumprod(self) -> np.ndarray:
        """float64; the guidance keeps it as a float32 buffer."""
        return np.cumprod(1.0 - self.betas)


def _per_sample(ac: torch.Tensor, t: torch.Tensor, ndim: int):
    return ac.index_select(0, t.reshape(-1).long()).reshape(
        (-1,) + (1,) * (ndim - 1))


def add_noise(ac: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(ac_t) x0 + sqrt(1-ac_t) eps (diffusers add_noise)."""
    a = _per_sample(ac, t, x0.ndim)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def predict_start_from_noise(ac: torch.Tensor, x_t: torch.Tensor,
                             t: torch.Tensor, noise: torch.Tensor
                             ) -> torch.Tensor:
    """x0 = (x_t - sqrt(1-ac) eps) / sqrt(ac) (ddpm.py
    predict_start_from_noise)."""
    a = _per_sample(ac, t, x_t.ndim)
    return (x_t - torch.sqrt(1.0 - a) * noise) / torch.sqrt(a)


def ddim_timesteps(num_train: int, num_steps: int,
                   steps_offset: int = 1) -> np.ndarray:
    """diffusers DDIMScheduler.set_timesteps (leading spacing + offset)."""
    step_ratio = num_train // num_steps
    ts = (np.arange(0, num_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + steps_offset


def ddim_step(ac: torch.Tensor, model_out: torch.Tensor, t: int,
              t_prev: int, sample: torch.Tensor, noise=None,
              eta: float = 0.0, set_alpha_to_one: bool = False
              ) -> torch.Tensor:
    """One DDIM update x_t -> x_{t_prev} (diffusers DDIMScheduler.step with
    clip_sample=False); `noise` (sample's shape) is added when eta > 0."""
    ac_t = ac[t]
    if t_prev >= 0:
        ac_prev = ac[t_prev]
    else:
        ac_prev = (torch.ones_like(ac_t) if set_alpha_to_one else ac[0])
    x0 = (sample - torch.sqrt(1.0 - ac_t) * model_out) / torch.sqrt(ac_t)
    sigma = eta * torch.sqrt((1 - ac_prev) / (1 - ac_t)) \
        * torch.sqrt(1 - ac_t / ac_prev)
    dir_xt = torch.sqrt(torch.clamp(1.0 - ac_prev - sigma ** 2, min=0.0)) \
        * model_out
    prev = torch.sqrt(ac_prev) * x0 + dir_xt
    if eta > 0 and noise is not None:
        prev = prev + sigma * noise
    return prev
