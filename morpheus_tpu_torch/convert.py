"""Parameter bridge between the JAX package's `init_field` tree
(morpheus_tpu/model/field.py:135-164) and the port's `Field` state dict, and
the reader of the JAX package's checkpoints.

JAX MLPs are {"w": [(in, out), ...], "b": [(out,), ...]}; the port's
nn.Linear weight is (out, in), so weights are transposed both ways. Code
tables (lists) become numbered entries. The input tree holds numpy arrays
(np.asarray of the JAX leaves); nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple

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


class _AdamState(NamedTuple):
    """Stand-in for morpheus_tpu.train.optim.AdamState in a JAX pickle."""
    step: object
    mu: dict
    nu: dict


class _OccupancyState(NamedTuple):
    """Stand-in for morpheus_tpu.ops.occupancy.OccupancyState."""
    occs: object
    binaries: object


class _JaxCkptUnpickler(pickle.Unpickler):
    """Reads a JAX `model_ep_*.pkl` without importing JAX or the JAX
    package: its two NamedTuple classes map to the stand-ins above, numpy's
    classes load as usual, and every other class is refused."""

    STAND_INS = {("morpheus_tpu.train.optim", "AdamState"): _AdamState,
                 ("morpheus_tpu.ops.occupancy", "OccupancyState"):
                     _OccupancyState}

    def find_class(self, module, name):
        if (module, name) in self.STAND_INS:
            return self.STAND_INS[(module, name)]
        if (module, name) == ("morpheus_tpu.train.optim", "AdanState"):
            raise NotImplementedError(
                "a checkpoint of the Adan optimizer: the port runs Adam only "
                "(ROADMAP.md queue A, item A15)")
        if module.split(".")[0] != "numpy":
            raise pickle.UnpicklingError(
                f"refusing {module}.{name} in a JAX checkpoint")
        return super().find_class(module, name)


def _named(tree: dict) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def load_jax_ckpt(path: str) -> dict:
    """A JAX `model_ep_*.pkl` (morpheus_tpu/train/trainer.py:921-955) as
    the port's checkpoint dict (train/trainer.py Trainer.state_dict), for
    Trainer.load_state_dict. The JAX run's PRNG key has no counterpart in
    the port's draws and is left out, as are the virtual-step gradients it
    carries (zero in a run without guidance)."""
    with open(path, "rb") as f:
        payload = _JaxCkptUnpickler(f).load()
    st = payload["state"]
    opt = st["opt_state"]
    return {
        "params": _named(st["params"]),
        "optim": {"name": "adam", "step": float(np.asarray(opt.step)),
                  "mu": _named(opt.mu), "nu": _named(opt.nu)},
        "ema": _named(st["ema"]),
        "occ": {"occs": np.asarray(st["occ"].occs),
                "binaries": np.asarray(st["occ"].binaries)},
        "global_step": int(np.asarray(st["global_step"])),
        "epoch": int(payload["epoch"]),
        "draws": None,
        "host_step": int(payload.get("host_step", 0)),
    }
