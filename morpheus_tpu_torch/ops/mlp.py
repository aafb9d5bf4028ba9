"""Plain ReLU MLP with the SAL/IGR geometric init
(port of morpheus_tpu/ops/mlp.py; float32 only)."""
from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Module):
    """num_layers nn.Linear layers, ReLU between them. The JAX layer weight
    w (in, out) is this module's layers[l].weight.T (see convert.py)."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int):
        super().__init__()
        dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
        self.layers = nn.ModuleList(nn.Linear(dims[l], dims[l + 1])
                                    for l in range(num_layers))

    def reset(self, generator: torch.Generator, geo_init: bool = False,
              geo_bias: float = 0.5):
        """Initialise like morpheus_tpu/ops/mlp.py::init_mlp: torch's default
        U(-1/sqrt(in), 1/sqrt(in)) for weight and bias, or the geometric init
        (last layer ~ sqrt(pi)/sqrt(in), first layer reading only xyz)."""
        n = len(self.layers)
        with torch.no_grad():
            for l, lin in enumerate(self.layers):
                d_out, d_in = lin.weight.shape
                dev = lin.weight.device
                if not geo_init:
                    bound = 1.0 / math.sqrt(d_in)
                    for p in (lin.weight, lin.bias):
                        p.copy_(torch.rand(p.shape, generator=generator,
                                           device=dev) * 2 * bound - bound)
                elif l == n - 1:
                    mean = math.sqrt(math.pi) / math.sqrt(d_in)
                    lin.weight.copy_(mean + 1e-4 * torch.randn(
                        (d_out, d_in), generator=generator, device=dev))
                    lin.bias.fill_(-geo_bias)
                else:
                    std = math.sqrt(2.0) / math.sqrt(d_out)
                    w = std * torch.randn((d_out, d_in), generator=generator,
                                          device=dev)
                    if l == 0:
                        w[:, 3:] = 0.0
                    lin.weight.copy_(w)
                    lin.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for l, lin in enumerate(self.layers):
            x = lin(x)
            if l != n - 1:
                x = torch.relu(x)
        return x
