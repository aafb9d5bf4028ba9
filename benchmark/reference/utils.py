"""Normalisation and the named random draws (the port's utils.py)."""
from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """L2-normalize along the last axis."""
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


class Draws:
    """Named source of a step's random numbers: a torch.Generator on
    `device` seeded with `seed`. The port's trainer draws from one such
    generator, site by site in its step's order, so the same seed and the
    same sites give the same values."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, name: str, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def normal(self, name: str, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def randint(self, name: str, shape, low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.device)
