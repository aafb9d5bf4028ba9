"""The numbers that decide `correct`: the program's first steps against the
reference's, from the same inputs and draws.

- loss: the widest gap of a step's loss, over the checked steps, as a
  share of the reference's loss;
- grad: the first gradient as the optimizer got it, worked out from Adam's
  first moment after its first update (m = (1 - b1) g from zero), by the
  worst leaf: the gap between the program's norm of the leaf and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf;
- update: the parameters' change over the checked steps, by the worst leaf
  as grad, over the leaves that the reference's gradients move: a leaf whose
  largest gradient norm over the checked updates is under a thousandth of
  the median leaf's moves under Adam by round-off alone and is left out.
"""
from __future__ import annotations

import numpy as np
import torch

B1 = 0.9            # Adam's b1, the port's and the reference's
CHECKED_STEPS = 3   # the first steps of set-up's epoch that are compared
STILL = 1e-3        # a leaf's gradient under this share of the median's


def _norms(d: dict, names) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(d[n].double()))
                     for n in names])


def _worst(prog: np.ndarray, ref: np.ndarray) -> float:
    if not len(ref):
        return 0.0
    den = np.maximum(ref, np.median(ref))
    gap = np.abs(prog - ref)
    with np.errstate(invalid="ignore", divide="ignore"):
        share = np.where(gap == 0, 0.0, gap / den)
    return float(np.max(share))


def gradients(rec: dict) -> list:
    """The gradient of each optimizer update among the checked steps, by
    name, from the first moments recorded after each step."""
    out, prev_mu, prev_count = [], None, 0.0
    for count, mu in zip(rec["counts"], rec["mu"]):
        if count > prev_count:
            out.append({n: (m.double() - (0.0 if prev_mu is None
                                          else B1 * prev_mu[n].double()))
                        / (1.0 - B1) for n, m in mu.items()})
        prev_mu, prev_count = mu, count
    return out


def numbers(prog: dict, ref: dict, n: int) -> dict:
    """{"loss", "grad", "update"} of the program's record against the
    reference's (harness.Checked.record, harness.run_reference)."""
    if prog["kinds"][:n] != ref["kinds"][:n]:
        raise AssertionError(f"steps {prog['kinds']} against {ref['kinds']}")
    lp, lr = np.array(prog["losses"][:n]), np.array(ref["losses"][:n])
    loss = float(np.max(np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)))
    names = sorted(ref["params"])
    gp, gr = gradients(prog), gradients(ref)
    if len(gp) != len(gr) or not gr:
        return {"loss": loss, "grad": float("inf"), "update": float("inf")}
    grad = _worst(_norms(gp[0], names), _norms(gr[0], names))
    moved = np.max([_norms(g, names) for g in gr], axis=0)
    keep = [nm for nm, v in zip(names, moved)
            if v >= STILL * np.median(moved)]
    dp = {nm: prog["params"][nm].double().to(ref["params0"][nm].device)
          - ref["params0"][nm].double() for nm in keep}
    dr = {nm: ref["params"][nm].double() - ref["params0"][nm].double()
          for nm in keep}
    update = _worst(_norms(dp, keep), _norms(dr, keep))
    return {"loss": loss, "grad": grad, "update": update}
