"""Building blocks of the Zero123 diffusion stack in NCHW (port of
morpheus_tpu/guidance/layers.py; reference: ldm/modules/diffusionmodules/
{openaimodel.py,util.py}, ldm/modules/attention.py).

Submodules carry ldm's names (in_layers.2, emb_layers.1, out_layers.3,
skip_connection, attn1.to_q, ff.net.0.proj, proj_in, ...), so an ldm state
dict loads with load_state_dict and no key table. Attention, convolutions
and matmuls are library calls, as they are XLA ops (not Pallas kernels) in
the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding in [cos | sin] order (util.py
    timestep_embedding), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over 32 groups computed in float32 whatever the input and
    parameter types (util.py GroupNorm32); the output takes the input's
    type."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(32, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def conv_nd(c_in: int, c_out: int, k: int, stride: int = 1,
            padding: int | None = None, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride=stride,
                     padding=k // 2 if padding is None else padding,
                     bias=bias)


class ResBlock(nn.Module):
    """openaimodel.py ResBlock: GN+SiLU+conv, time-embedding add, GN+SiLU+
    (dropout)+zero conv, conv or identity skip."""

    def __init__(self, c_in: int, c_out: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(c_in), nn.SiLU(),
                                       conv_nd(c_in, c_out, 3))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, c_out))
        self.out_layers = nn.Sequential(GroupNorm32(c_out), nn.SiLU(),
                                        nn.Dropout(0.0),
                                        conv_nd(c_out, c_out, 3))
        self.skip_connection = (nn.Identity() if c_in == c_out
                                else conv_nd(c_in, c_out, 1))

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


def attention(q, k, v, heads: int):
    """Multi-head scaled dot-product attention of (B, N, heads*d) q and
    (B, M, heads*d) k, v; scale 1/sqrt(d)."""
    B, N, inner = q.shape
    d = inner // heads
    q, k, v = (a.reshape(B, a.shape[1], heads, d).transpose(1, 2)
               for a in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, N, inner)


class CrossAttention(nn.Module):
    """attention.py CrossAttention: q from x, k and v from the context (or
    from x)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim),
                                    nn.Dropout(0.0))

    def forward(self, x, context=None):
        context = x if context is None else context
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context),
                        self.heads)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b)              # exact (erf) GELU


class FeedForward(nn.Module):
    """attention.py FeedForward with GEGLU, mult 4."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """attention.py SpatialTransformer: GroupNorm (eps 1e-6, float32),
    1x1 conv projections, `depth` transformer blocks over the pixels."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = conv_nd(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads,
                                  context_dim) for _ in range(depth)])
        self.proj_out = conv_nd(channels, channels, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(B, C, H * W).transpose(1, 2)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1 (openaimodel.py Downsample)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = conv_nd(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (openaimodel.py Upsample)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv_nd(channels, channels, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
