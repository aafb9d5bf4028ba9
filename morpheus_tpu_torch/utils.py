"""Small shared utilities: normalisation, device choice, random draws,
seeding, the run log and the source snapshot (reference: utils.py,
morpheus.py:75-103,360-364)."""
from __future__ import annotations

import os
import random
import shutil
import time

import numpy as np
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


def seed_everything(seed: int) -> None:
    """Seed Python, numpy and torch (reference: utils.py:63-68)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class Logger:
    """Append-to-file + console logger (reference: morpheus.py:92-103,
    360-364)."""

    def __init__(self, workspace: str | None, log_name: str = "log.txt"):
        self.workspace = workspace
        self._fh = None
        if workspace is not None:
            os.makedirs(workspace, exist_ok=True)
            self._fh = open(os.path.join(workspace, log_name), "a+")

    def __call__(self, *args):
        msg = " ".join(str(a) for a in args)
        print(msg, flush=True)
        if self._fh is not None:
            stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
            print(f"[{stamp}] {msg}", file=self._fh)
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def file_backup(workspace: str) -> None:
    """Snapshot the port's sources (*.py, *.cu, *.cpp under
    morpheus_tpu_torch/) into workspace/recording/ for reproducibility
    (reference file_backup, morpheus.py:75-90)."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(pkg)
    rec = os.path.join(workspace, "recording")
    for base, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                src = os.path.join(base, f)
                dst = os.path.join(rec, os.path.relpath(src, root))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copyfile(src, dst)
