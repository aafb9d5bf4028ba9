"""Multi-resolution 1-D temporal feature codes
(port of morpheus_tpu/ops/codes.py)."""
from __future__ import annotations

import torch


def init_multicode(generator: torch.Generator, sizes, dim: int, device
                   ) -> list[torch.Tensor]:
    """randn-initialized (size, dim) code tables (deform_code.py:13-15)."""
    return [torch.randn((s, dim), generator=generator, device=device)
            for s in sizes]


def multicode_dim(sizes, dim: int) -> int:
    return len(sizes) * dim


def _rows(vol: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    # index_select: its backward is an index_add, where advanced indexing's
    # sorts the indices first
    return vol.index_select(0, i.reshape(-1)).reshape(i.shape + vol.shape[1:])


def sample_multicode(volumes, t: torch.Tensor) -> torch.Tensor:
    """Codes at normalized times t (N, 1) in [0, 1] -> (N, len(volumes)*dim):
    linear interpolation over each table's time axis (align_corners=True)."""
    t = torch.clamp(t[..., 0], 0.0, 1.0)
    feats = []
    for vol in volumes:
        size = vol.shape[0]
        pos = t * (size - 1)
        i0 = torch.clamp(torch.floor(pos), 0, size - 1).long()
        i1 = torch.clamp(i0 + 1, 0, size - 1)
        w = (pos - i0)[..., None]
        feats.append(_rows(vol, i0) * (1.0 - w) + _rows(vol, i1) * w)
    return torch.cat(feats, dim=-1)
