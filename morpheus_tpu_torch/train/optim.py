"""Per-group Adam with the reference's betas/eps, the GradScaler-style skip
of non-finite updates, the virtual step's deform freeze, and the parameter
EMA (port of morpheus_tpu/train/optim.py: FREEZE_GROUPS, adam_update,
ema_update).

The update runs on the device with no host synchronisation: the skip is a
select between the new and the old state, as in the reference's compiled
step.
"""
from __future__ import annotations

import numpy as np
import torch

# top-level parameter name -> static lr multiplier (models/model.py:309-333)
GROUP_MULTIPLIERS = {
    "sdf_grid": 1.0, "color_grid": 1.0, "sdf_net": 1.0, "topo_net": 1.0,
    "color_net": 1.0, "beta": 0.5, "deform_net": 1.0, "deform_code": 1.0,
    "pose": 0.1, "bg_net": 1.0, "app_code": 1.0,
}

# groups the virtual step does not move while the deformation field is
# frozen (morpheus.py:504-511); their moments still update
FREEZE_GROUPS = ("deform_code", "deform_net", "topo_net")


def group_of(name: str) -> str:
    """Top-level group of a parameter name ('deform_net.layers.0.weight'
    -> 'deform_net')."""
    return name.split(".", 1)[0]


class Adam:
    """torch.optim.Adam-like semantics of the reference's adam_update:
    p -= lr*mult * (m/bc1) / (sqrt(v/bc2) + eps), b1 0.9, b2 0.99, eps 1e-15.
    An update whose gradients are not all finite leaves the parameters and
    the moments (and the step count) as they were. Frozen groups take a
    zero learning rate: their parameters stay, their moments and the step
    count move (optim.py:62-82 of the JAX package)."""

    def __init__(self, named_params, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-15):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.mult = [np.float32(GROUP_MULTIPLIERS.get(group_of(n), 1.0))
                     for n in self.names]
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = self.params[0].device
        self.step = torch.zeros((), dtype=torch.float32, device=dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads, lr, frozen=(), ok=None) -> torch.Tensor:
        """Apply one step with base learning rate `lr`, the groups in
        `frozen` at rate 0; returns the on-device flag of whether it was
        applied. `ok` (a device bool) also gates the step, as the
        gradients' own finiteness does. The arithmetic is the reference's,
        op for op, in multi-tensor (foreach) launches."""
        # the GradScaler's fused check, with an unscale by exactly 1.0
        found = torch.zeros((), dtype=torch.float32, device=self.step.device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, torch.ones_like(found))
        ok = (found == 0.0) if ok is None else (found == 0.0) & ok
        b1, b2 = self.b1, self.b2
        t = self.step + 1.0
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        mu = torch._foreach_mul(self.mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        nu = torch._foreach_mul(self.nu, b2)
        g2 = torch._foreach_mul(grads, 1 - b2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_mul_(upd, [
            0.0 if group_of(n) in frozen else float(m * np.float32(lr))
            for n, m in zip(self.names, self.mult)])
        torch._foreach_div_(upd, den)
        new = torch._foreach_sub(self.params, upd)
        for dst, src in ((self.params, new), (self.mu, mu), (self.nu, nu)):
            for d, s in zip(dst, src):
                torch.where(ok, s, d, out=d)
        torch.where(ok, t, self.step, out=self.step)
        return ok


@torch.no_grad()
def ema_update(ema: list, params: list, decay: float) -> None:
    """ema <- decay*ema + (1-decay)*params, in place."""
    for e, p in zip(ema, params):
        e.copy_(decay * e + (1 - decay) * p)
