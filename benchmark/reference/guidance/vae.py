"""AutoencoderKL first stage in NCHW (port of morpheus_tpu/guidance/vae.py;
reference: ldm/models/autoencoder.py:285 with Encoder/Decoder of
ldm/modules/diffusionmodules/model.py; SD VAE: ch 128, ch_mult (1,2,4,4),
2 res blocks, attention only at the bottleneck, z 4, double_z, scale
factor 0.18215). Module names follow ldm (encoder.down.L.block.N,
encoder.down.L.downsample.conv, encoder.mid.attn_1, decoder.up.L...,
quant_conv, post_quant_conv)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv_nd

SCALE_FACTOR = 0.18215


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    """model.py ResnetBlock: GN (eps 1e-6) + swish + conv, twice; 1x1
    nin_shortcut when the width changes."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm1 = _norm(c_in)
        self.conv1 = conv_nd(c_in, c_out, 3)
        self.norm2 = _norm(c_out)
        self.conv2 = conv_nd(c_out, c_out, 3)
        if c_in != c_out:
            self.nin_shortcut = conv_nd(c_in, c_out, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """model.py AttnBlock: one-head self-attention over the pixels."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q, self.k, self.v, self.proj_out = (conv_nd(c, c, 1)
                                                 for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(B, 1, C, H * W).transpose(2, 3)
                   for m in (self.q, self.k, self.v))
        h = F.scaled_dot_product_attention(q, k, v)
        h = h.transpose(2, 3).reshape(B, C, H, W)
        return x + self.proj_out(h)


class _Down(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_blocks: int, down: bool):
        super().__init__()
        self.block = nn.ModuleList([ResnetBlock(c_in if i == 0 else c_out,
                                                c_out)
                                    for i in range(n_blocks)])
        if down:
            self.downsample = nn.Module()
            self.downsample.conv = nn.Conv2d(c_out, c_out, 3, stride=2)


class _Up(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_blocks: int, up: bool):
        super().__init__()
        self.block = nn.ModuleList([ResnetBlock(c_in if i == 0 else c_out,
                                                c_out)
                                    for i in range(n_blocks)])
        if up:
            self.upsample = nn.Module()
            self.upsample.conv = conv_nd(c_out, c_out, 3)


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 double_z: bool = True):
        super().__init__()
        self.conv_in = conv_nd(3, ch, 3)
        self.down = nn.ModuleList()
        c = ch
        for level, mult in enumerate(ch_mult):
            self.down.append(_Down(c, ch * mult, num_res_blocks,
                                   level != len(ch_mult) - 1))
            c = ch * mult
        self.mid = _Mid(c)
        self.norm_out = _norm(c)
        self.conv_out = conv_nd(c, 2 * z_channels if double_z
                                else z_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for down in self.down:
            for block in down.block:
                h = block(h)
            if hasattr(down, "downsample"):
                # model.py Downsample: asymmetric pad (0,1,0,1), then a
                # stride-2 conv without padding
                h = down.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3,
                 z_channels: int = 4):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = conv_nd(z_channels, c, 3)
        self.mid = _Mid(c)
        ups = []
        for level in reversed(range(len(ch_mult))):
            ups.append(_Up(c, ch * ch_mult[level], num_res_blocks + 1,
                           level != 0))
            c = ch * ch_mult[level]
        self.up = nn.ModuleList(ups[::-1])       # up[level], as ldm's
        self.norm_out = _norm(c)
        self.conv_out = conv_nd(c, out_ch, 3)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for up in reversed(self.up):
            for block in up.block:
                h = block(h)
            if hasattr(up, "upsample"):
                h = up.upsample.conv(F.interpolate(h, scale_factor=2.0,
                                                   mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode -> (mean, logvar) through quant_conv; decode through
    post_quant_conv (autoencoder.py:285-330)."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks)
        self.quant_conv = conv_nd(2 * embed_dim, 2 * embed_dim, 1)
        self.post_quant_conv = conv_nd(embed_dim, embed_dim, 1)

    def encode_moments(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_mode(self, x):
        """The posterior's mode (its mean): the reference's .mode() for the
        concatenated latent (zero123_utils.py:96)."""
        return self.encode_moments(x)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x):
        return self.decode(self.encode_mode(x))
