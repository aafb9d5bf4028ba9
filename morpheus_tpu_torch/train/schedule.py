"""Training curriculum as host functions of the epoch
(port of morpheus_tpu/train/schedule.py: learning_rate, max_level,
loss_weights). Values are computed in float32, as the reference's traced
schedule computes them."""
from __future__ import annotations

import dataclasses

import numpy as np

_F = np.float32


@dataclasses.dataclass(frozen=True)
class Curriculum:
    lr: float = 5e-4
    n_epochs: int = 2000
    warm_up_end: int = 200
    progressive_level: bool = True
    ori_weight: float = 0.01
    ori_weight_late: float = 0.002
    rgb_weight: float = 5.0
    rgb_weight_late: float = 10.0
    beta_weight: float = 0.1
    beta_weight_late: float = 0.3

    @property
    def swap_epoch(self) -> int:
        return 200 + self.warm_up_end

    def lr_factor(self, epoch) -> np.float32:
        """0.01 below epoch 100, linear to 1 at warm_up_end, then cosine
        down to alpha=0.05 (morpheus.py:472-502)."""
        e = _F(epoch)
        if e < _F(self.warm_up_end):
            if e < _F(100):
                return _F(0.01)
            return _F(0.01) + (e - _F(100)) / _F(max(self.warm_up_end - 100,
                                                     1)) * _F(0.99)
        progress = (e - _F(self.warm_up_end)) / _F(
            max(self.n_epochs - self.warm_up_end, 1))
        alpha = _F(0.05)
        return ((np.cos(_F(np.pi) * progress) + _F(1.0)) * _F(0.5)
                * (_F(1.0) - alpha) + alpha)

    def learning_rate(self, epoch) -> np.float32:
        return _F(self.lr) * self.lr_factor(epoch)

    def max_level(self, epoch) -> np.float32:
        """Coarse-to-fine level schedule (morpheus.py:808-813)."""
        if not self.progressive_level:
            return _F(1.0)
        ratio = _F(epoch) / _F(self.n_epochs)
        return np.minimum(_F(1.0), _F(0.5) + _F(0.5) * ratio)

    def loss_weights(self, epoch):
        """(ori, rgb, beta) weights with the late swap."""
        if epoch > self.swap_epoch:
            return (self.ori_weight_late, self.rgb_weight_late,
                    self.beta_weight_late)
        return self.ori_weight, self.rgb_weight, self.beta_weight

    @staticmethod
    def from_config(config: dict) -> "Curriculum":
        tr = config["train"]
        if tr.get("optim", "adam") != "adam":
            raise NotImplementedError(
                f"optim {tr.get('optim')!r}: the port implements Adam only "
                "(ROADMAP.md queue A, item A15)")
        return Curriculum(
            lr=tr["lr"], n_epochs=tr["n_epochs"],
            warm_up_end=tr["warm_up_end"],
            progressive_level=tr["progressive_level"],
            ori_weight=tr["ori_weight"], rgb_weight=tr["rgb_weight"],
            beta_weight=tr["beta_weight"])
