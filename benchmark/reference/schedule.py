"""Training curriculum as host functions of the epoch
(port of morpheus_tpu/train/schedule.py: learning_rate, max_level,
loss_weights, freeze_deform, view_ranges, sds_t_range). Values are
computed in float32, as the reference's traced schedule computes them.
StepScalars holds the values the real step reads as 0-dim device tensors
at fixed addresses, which a captured step reads where the JAX package's
compiled step reads its traced epoch."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_F = np.float32


@dataclasses.dataclass(frozen=True)
class Curriculum:
    lr: float = 5e-4
    n_epochs: int = 2000
    warm_up_end: int = 200
    warm_up_steps: int = 100        # host steps whose virtual slots run real
    freeze_epoch: int = 400         # deform freeze while epoch <= this
    progressive_level: bool = True
    albedo_iter_ratio: float = 0.1
    min_ambient_ratio: float = 0.1
    textureless_ratio: float = 0.2
    ori_weight: float = 0.01
    ori_weight_late: float = 0.002
    rgb_weight: float = 5.0
    rgb_weight_late: float = 10.0
    beta_weight: float = 0.1
    beta_weight_late: float = 0.3
    t_range: tuple = (0.02, 0.5)
    # progressive view expansion (morpheus.py:796-806); off in shipped
    # configs
    progressive_view: bool = False
    progressive_view_init_ratio: float = 0.2
    default_polar: float = 90.0
    default_azimuth: float = 0.0
    full_theta_range: tuple = (45.0, 105.0)
    full_phi_range: tuple = (-180.0, 180.0)

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

    def freeze_deform(self, epoch) -> bool:
        """Whether the virtual step's deform freeze is on
        (morpheus.py:1452-1453: freeze_lr ends after freeze_epoch)."""
        return epoch <= self.freeze_epoch

    def view_ranges(self, epoch):
        """Progressive-view ((th_lo, th_hi), (ph_lo, ph_hi)) in degrees
        (morpheus.py:796-806): the ranges grow from the default view toward
        the full ranges at twice the epoch ratio."""
        r = np.minimum(_F(1.0), _F(self.progressive_view_init_ratio)
                       + _F(2.0) * (_F(epoch) / _F(self.n_epochs)))
        th = tuple(_F(self.default_polar) * (_F(1) - r) + _F(f) * r
                   for f in self.full_theta_range)
        ph = tuple(_F(self.default_azimuth) * (_F(1) - r) + _F(f) * r
                   for f in self.full_phi_range)
        return th, ph

    def sds_t_range(self, epoch):
        """The annealed SDS timestep range (morpheus.py:1455-1461): t_range
        until the late swap, then the upper end falls linearly to 0.02."""
        start = _F(self.swap_epoch)
        if _F(epoch) > start:
            end_t = _F(0.02) + _F(0.48) * (_F(1.0) - (_F(epoch) - start) / _F(
                max(self.n_epochs - self.swap_epoch, 1.0)))
        else:
            end_t = _F(self.t_range[1])
        return _F(self.t_range[0]), end_t

    def sds_steps(self, epoch) -> tuple[int, int]:
        """(min_step, max_step): the t range in integer timesteps of 1000,
        truncated as the reference's int cast truncates."""
        lo, hi = self.sds_t_range(epoch)
        return int(lo * _F(1000)), int(hi * _F(1000))

    def loss_weights(self, epoch):
        """(ori, rgb, beta) weights with the late swap."""
        if epoch > self.swap_epoch:
            return (self.ori_weight_late, self.rgb_weight_late,
                    self.beta_weight_late)
        return self.ori_weight, self.rgb_weight, self.beta_weight

    @staticmethod
    def from_config(config: dict) -> "Curriculum":
        tr = config["train"]
        d = config["data"]
        # Adan runs at 5x the base lr (morpheus.py:149: get_params_all(5*lr))
        lr = tr["lr"] * (5.0 if tr.get("optim") == "adan" else 1.0)
        return Curriculum(
            lr=lr, n_epochs=tr["n_epochs"],
            warm_up_end=tr["warm_up_end"], warm_up_steps=tr["warm_up_steps"],
            freeze_epoch=tr["freeze_epoch"],
            progressive_level=tr["progressive_level"],
            albedo_iter_ratio=tr["albedo_iter_ratio"],
            min_ambient_ratio=tr["min_ambient_ratio"],
            textureless_ratio=tr["textureless_ratio"],
            ori_weight=tr["ori_weight"], rgb_weight=tr["rgb_weight"],
            beta_weight=tr["beta_weight"],
            t_range=tuple(config["guidance"]["t_range"]),
            progressive_view=bool(tr["progressive_view"]),
            progressive_view_init_ratio=tr["progressive_view_init_ratio"],
            default_polar=d["default_polar"],
            default_azimuth=d["default_azimuth"],
            full_theta_range=tuple(d["full_theta_range"]),
            full_phi_range=tuple(d["full_phi_range"]))
