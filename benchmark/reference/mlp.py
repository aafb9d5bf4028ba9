"""Plain ReLU MLP with the SAL/IGR geometric init and the bfloat16
mixed-precision policy (port of morpheus_tpu/ops/mlp.py: init_mlp,
apply_mlp)."""
from __future__ import annotations

import math

import torch
from torch import nn


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices, summed and returned in float32: a bf16
    GEMM with an f32 output on the card; on the CPU the f32 product of the
    widened operands, which is the same number (a product of two bf16
    values is exact in f32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _BF16Linear(torch.autograd.Function):
    """x @ w.T + b with x and w in bf16, the product in f32 (the JAX
    package's jnp.dot(..., preferred_element_type=f32)) and the f32 bias
    added in f32. The gradients of x and w are f32 products of the f32
    cotangent with the widened other operand; autograd rounds them to bf16,
    the operands' type, as the JAX transpose rounds them to its operands'
    type."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w.t()) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w.float(), g.t() @ x.float(), g.sum(0)


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

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """dtype None runs float32; torch.bfloat16 runs the JAX package's
        mixed policy (ops/mlp.py:54-73): inputs and weights in bf16, each
        product summed in f32 with the f32 bias added, each hidden ReLU's
        output cast back to bf16, the result in x's type."""
        n = len(self.layers)
        out_dtype = x.dtype
        if dtype is not None:
            x = x.to(dtype)
        for l, lin in enumerate(self.layers):
            if dtype is None:
                x = lin(x)
            else:
                lead = x.shape[:-1]
                x = _BF16Linear.apply(x.reshape(-1, x.shape[-1]),
                                      lin.weight.to(dtype), lin.bias)
                x = x.reshape(*lead, x.shape[-1])
            if l != n - 1:
                x = torch.relu(x)
                if dtype is not None:
                    x = x.to(dtype)
        return x.to(out_dtype)
