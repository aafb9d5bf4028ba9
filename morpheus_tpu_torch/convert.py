"""Parameter bridge between the JAX package's `init_field` tree
(morpheus_tpu/model/field.py:135-164) and the port's `Field` state dict.

JAX MLPs are {"w": [(in, out), ...], "b": [(out,), ...]}; the port's
nn.Linear weight is (out, in), so weights are transposed both ways. Code
tables (lists) become numbered entries. The input tree holds numpy arrays
(np.asarray of the JAX leaves); nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> Field state dict."""
    state = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            for l, (w, b) in enumerate(zip(value["w"], value["b"])):
                state[f"{key}.layers.{l}.weight"] = _t(np.asarray(w).T)
                state[f"{key}.layers.{l}.bias"] = _t(b)
        elif isinstance(value, (list, tuple)):
            for i, a in enumerate(value):
                state[f"{key}.{i}"] = _t(a)
        else:
            state[key] = _t(value)
    return state


def params_to_jax(state) -> dict:
    """Field state dict (or Field) -> JAX-layout tree of numpy arrays."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    tree: dict = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        parts = name.split(".")
        if len(parts) == 4 and parts[1] == "layers":       # key.layers.l.x
            mlp = tree.setdefault(parts[0], {"w": [], "b": []})
            l = int(parts[2])
            lst = mlp["w" if parts[3] == "weight" else "b"]
            lst.extend([None] * (l + 1 - len(lst)))
            lst[l] = a.T.copy() if parts[3] == "weight" else a
        elif len(parts) == 2:                              # key.i
            lst = tree.setdefault(parts[0], [])
            i = int(parts[1])
            lst.extend([None] * (i + 1 - len(lst)))
            lst[i] = a
        else:
            tree[name] = a
    return tree


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))
