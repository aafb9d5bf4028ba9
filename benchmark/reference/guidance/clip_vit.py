"""CLIP ViT image tower in NCHW input (port of
morpheus_tpu/guidance/clip_vit.py; reference: FrozenCLIPImageEmbedder,
ldm/modules/encoders/modules.py:343-383, the OpenAI 'ViT-L/14' encode_image
with its 768-d projection). The CLIP-similarity eval uses it as ViT-B/32.

Parameter names follow open_clip's visual tower: conv1, class_embedding,
positional_embedding, ln_pre, transformer.resblocks.N.{ln_1,
attn.in_proj_weight, attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}, ln_post, proj.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resize import resize

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """images (B, 3, H, W) in [0, 1] -> 224x224, CLIP-normalised (the
    reference's kornia bicubic resize + normalize, modules.py:361-372; the
    resize is jax.image.resize's bicubic, see resize.py)."""
    x = resize(images, (224, 224), "bicubic")
    mean = torch.as_tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


class _Attention(nn.Module):
    """nn.MultiheadAttention's parameters (fused in_proj), computed with
    scaled_dot_product_attention."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = (F.linear(x, self.in_proj_weight, self.in_proj_bias)
                   .reshape(B, N, 3, self.heads, C // self.heads)
                   .permute(2, 0, 3, 1, 4))
        out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


class _MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))     # QuickGELU


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width, 4 * width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads)
                                        for _ in range(layers)])


class CLIPVisionTransformer(nn.Module):
    """OpenAI CLIP VisionTransformer. ViT-L/14: width 1024, 24 layers, 16
    heads, patch 14, out 768; ViT-B/32: width 768, 12 layers, 12 heads,
    patch 32, out 512. Input 224x224."""

    def __init__(self, width: int = 1024, layers: int = 24, heads: int = 16,
                 patch: int = 14, out_dim: int = 768, image_size: int = 224):
        super().__init__()
        n_tok = (image_size // patch) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, out_dim))

    def forward(self, x):
        """x (B, 3, 224, 224) CLIP-normalised -> (B, out_dim)."""
        B = x.shape[0]
        h = self.conv1(x).flatten(2).transpose(1, 2)          # (B, P, W)
        cls = self.class_embedding.reshape(1, 1, -1).expand(B, 1, -1)
        h = torch.cat([cls.to(h.dtype), h], 1) + self.positional_embedding
        h = self.ln_pre(h)
        for block in self.transformer.resblocks:
            h = block(h)
        return self.ln_post(h[:, 0]) @ self.proj


def vit_l14() -> CLIPVisionTransformer:
    return CLIPVisionTransformer(width=1024, layers=24, heads=16, patch=14,
                                 out_dim=768)


def vit_b32() -> CLIPVisionTransformer:
    return CLIPVisionTransformer(width=768, layers=12, heads=12, patch=32,
                                 out_dim=512)


def flax_default_init_(root: nn.Module, gen: torch.Generator,
                       zero=frozenset()) -> None:
    """Initialise every Conv2d, Linear, norm and fused CLIP attention under
    `root` as flax's defaults do: lecun-normal kernels (truncated at two
    standard deviations), zero biases, unit norms; the weights of the
    modules whose id() is in `zero` start at zero. Under no_grad."""
    for m in root.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if id(m) in zero:
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, _Attention):
            # flax's q/k/v Dense kernels, fused: fan_in = width
            std = math.sqrt(1.0 / m.in_proj_weight.shape[1]) \
                / .87962566103423978
            nn.init.trunc_normal_(m.in_proj_weight, 0.0, std,
                                  -2 * std, 2 * std, generator=gen)
            m.in_proj_bias.zero_()


def embeddings_init_(model: CLIPVisionTransformer,
                     gen: torch.Generator) -> None:
    """The class and positional embeddings and the projection,
    N(0, 0.02) as the JAX tower's params. Under no_grad."""
    for p in (model.class_embedding, model.positional_embedding, model.proj):
        p.normal_(0.0, 0.02, generator=gen)
