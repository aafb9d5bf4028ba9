"""Per-group Adam with the reference's betas and eps, the GradScaler-style
skip of non-finite updates and the virtual step's deform freeze (the
port's train/optim.py: FREEZE_GROUPS and Adam, op for op). The learning
rate is a host float.
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


class _Optimizer:
    """What Adam and Adan share: the per-parameter group multipliers, the
    step count and the SLOTS (per-parameter state, checkpointed by name)
    on the parameters' device; the GradScaler-style skip of an update
    whose gradients are not all finite, which leaves the parameters, the
    slots and the step count as they were; and the freeze, a zero learning
    rate for the frozen groups, whose moments and the step count still
    move (optim.py:62-82 of the JAX package). A subclass gives its SLOTS
    and `_apply`, the arithmetic of one update."""

    name = ""
    SLOTS: tuple = ()

    def __init__(self, named_params):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.mult = [np.float32(GROUP_MULTIPLIERS.get(group_of(n), 1.0))
                     for n in self.names]
        dev = self.params[0].device
        self.step = torch.zeros((), dtype=torch.float32, device=dev)
        for k in self.SLOTS:
            setattr(self, k, [torch.zeros_like(p) for p in self.params])

    def _apply(self, grads, t, rates):
        """(new parameters, new slots in SLOTS order) of the update at step
        t (a device scalar), each parameter at its own rate: `rates` is a
        list of (rate, indices of the parameters at that rate), a rate a
        float or a 0-dim device tensor (_scale)."""
        raise NotImplementedError

    def _rates(self, lr, frozen) -> list:
        """[(rate, parameter indices)]: each group multiplier times lr in
        float32 (a host float for a host lr, a 0-dim tensor for a tensor
        lr), 0.0 for the groups in `frozen`."""
        by_mult = {}
        for i, (n, m) in enumerate(zip(self.names, self.mult)):
            by_mult.setdefault(None if group_of(n) in frozen else m,
                               []).append(i)
        host = not isinstance(lr, torch.Tensor)
        return [(0.0 if m is None
                 else float(m * np.float32(lr)) if host else lr * float(m),
                 idx) for m, idx in by_mult.items()]

    @staticmethod
    def _scale(xs, rates, op=torch._foreach_mul_) -> None:
        """op(xs[idx], rate) in place for each (rate, idx) group of
        `rates`: one multi-tensor launch a group."""
        for rate, idx in rates:
            op([xs[i] for i in idx], rate)

    @torch.no_grad()
    def update(self, grads, lr, frozen=(), ok=None) -> torch.Tensor:
        """Apply one step with base learning rate `lr` (a host float or a
        0-dim float32 device tensor), the groups in `frozen` at rate 0;
        returns the on-device flag of whether it was applied. `ok` (a
        device bool) also gates the step, as the gradients' own finiteness
        does."""
        # the GradScaler's fused check, with an unscale by exactly 1.0
        found = torch.zeros((), dtype=torch.float32, device=self.step.device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, torch.ones_like(found))
        ok = (found == 0.0) if ok is None else (found == 0.0) & ok
        t = self.step + 1.0
        new, slots = self._apply(grads, t, self._rates(lr, frozen))
        for dst, src in zip([self.params] + [getattr(self, k)
                                             for k in self.SLOTS],
                            [new] + list(slots)):
            for d, s in zip(dst, src):
                torch.where(ok, s, d, out=d)
        torch.where(ok, t, self.step, out=self.step)
        return ok


class Adam(_Optimizer):
    """torch.optim.Adam-like semantics of the reference's adam_update:
    p -= lr*mult * (m/bc1) / (sqrt(v/bc2) + eps), b1 0.9, b2 0.99, eps 1e-15.
    The arithmetic is the reference's, op for op, in multi-tensor (foreach)
    launches."""

    name = "adam"
    SLOTS = ("mu", "nu")

    def __init__(self, named_params, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-15):
        super().__init__(named_params)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _apply(self, grads, t, rates):
        b1, b2 = self.b1, self.b2
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
        self._scale(upd, rates)
        torch._foreach_div_(upd, den)
        return torch._foreach_sub(self.params, upd), (mu, nu)
