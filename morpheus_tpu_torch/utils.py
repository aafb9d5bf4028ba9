"""Small shared utilities: normalisation, device choice, random draws."""
from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """L2-normalize along the last axis (reference: utils.py:70-71)."""
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; when it is
    asked for and absent this raises - the port never falls back to the CPU
    on its own. Pass device="cpu" to run on the CPU deliberately."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Draws:
    """Named source of the random numbers of one training step.

    Every random site of the real step asks for its values by name
    (``uniform("march", (N, 1))``), so a test can replay another framework's
    draws through the same call sites (tests/torch_parity.py does so with the
    JAX key tree). This default wraps a ``torch.Generator`` on `device`.
    """

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
