"""The one-process layout of a batch: the plain counterpart of the port's
Reducer and Rows (morpheus_tpu_torch/parallel/sharding.py) when no process
group is up, where every collective is the identity and a rank holds every
entry in order."""
from __future__ import annotations

import torch


class Rows:
    """All `total` entries of a 1-D index space, in order."""

    padded = False

    def __init__(self, total: int):
        self.total = int(total)

    @property
    def red(self) -> "Reducer":
        return LOCAL

    def __len__(self) -> int:
        return self.total

    def global_index(self, device) -> torch.Tensor:
        return torch.arange(self.total, device=device)

    def members(self):
        return None

    def take(self, full: torch.Tensor) -> torch.Tensor:
        return full

    def draws(self, draws):
        return draws

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def scaled(self, k: int) -> "Rows":
        return Rows(self.total * k)

    def repeated(self, p: int, device) -> "Rows":
        return Rows(p * self.total)

    def select(self, sel: torch.Tensor):
        return sel, Rows(sel.shape[0])

    def split_sorted(self, perm: torch.Tensor, k: int):
        return perm, Rows(perm.shape[0])


class Reducer:
    rank, world, active = 0, 1, False

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum() / x.numel()

    def rows(self, n: int) -> Rows:
        return Rows(n)


LOCAL = Reducer()
