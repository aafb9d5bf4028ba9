"""SD 1.x UNet epsilon-predictor in the Zero123 configuration, NCHW (port
of morpheus_tpu/guidance/unet.py; reference: ldm/modules/diffusionmodules/
openaimodel.py:414-760): in_channels 8 (4 noisy + 4 concatenated latent),
out 4, model_channels 320, channel_mult (1,2,4,4), 2 res blocks, attention
at ds in {1,2,4}, transformer depth 1, context_dim 768, 8 heads.

Module names follow ldm: time_embed.{0,2}, input_blocks.I.J,
middle_block.{0,1,2}, output_blocks.I.J, out.{0,2}.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (Downsample, GroupNorm32, ResBlock, SpatialTransformer,
                     Upsample, conv_nd, timestep_embedding)


class TimestepEmbedSequential(nn.Sequential):
    """Children called in turn with the time embedding (ResBlock) or the
    context (SpatialTransformer) as they need it."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    def __init__(self, in_channels: int = 8, out_channels: int = 4,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_heads: int = 8, context_dim: int = 768,
                 transformer_depth: int = 1):
        super().__init__()
        mc = model_channels
        emb_dim = mc * 4
        self.model_channels = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_dim), nn.SiLU(),
                                        nn.Linear(emb_dim, emb_dim))

        def attn(ch):
            return SpatialTransformer(ch, num_heads, context_dim,
                                      transformer_depth)

        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            conv_nd(in_channels, mc, 3))])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb_dim)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(
                    Downsample(ch)))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, ch, emb_dim), attn(ch), ResBlock(ch, ch, emb_dim))

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for nr in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb_dim)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and nr == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 conv_nd(mc, out_channels, 3))

    def forward(self, x, timesteps, context):
        """x (B, in_ch, H, W); timesteps (B,); context (B, L, context_dim).
        The sinusoid is computed in float32, then takes x's type, so that a
        bfloat16 UNet runs in bfloat16 throughout (GroupNorm aside)."""
        t_emb = timestep_embedding(timesteps,
                                   self.model_channels).to(x.dtype)
        emb = self.time_embed(t_emb)
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h)

