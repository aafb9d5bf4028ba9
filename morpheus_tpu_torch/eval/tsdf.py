"""Dense TSDF fusion of posed RGB-D frames on a torch device (port of
morpheus_tpu/eval/tsdf.py; it replaces Open3D's ScalableTSDFVolume,
reference tools/vis.py:315-361 run_tsdf_fusion, which visualizer.py:110-125
uses to reconstruct the static background).

The volume and its voxel centres live on `device`. Each frame's projection
and update run there in float64, in the JAX copy's order of operations, so
the fused volume is the JAX copy's (a voxel whose projection lands on a
pixel's half coordinate may round the other way when a BLAS sums the
rotation in another order). The iso-surface is extracted on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import meshing
from ..utils import resolve_device


class TSDFVolume:
    def __init__(self, bounds: np.ndarray, voxel_size: float,
                 sdf_trunc: float | None = None, device="cuda"):
        """bounds: (2, 3) [min, max] in world units. The volume is built on
        `device` (without CUDA, "cuda" raises)."""
        self.device = resolve_device(device)
        self.bounds = np.asarray(bounds, np.float64)
        self.voxel_size = voxel_size
        self.sdf_trunc = sdf_trunc or 4.0 * voxel_size
        dims = np.ceil((self.bounds[1] - self.bounds[0]) / voxel_size
                       ).astype(int) + 1
        self.dims = dims
        shape = tuple(int(d) for d in dims)
        kw = {"dtype": torch.float32, "device": self.device}
        self.tsdf = torch.ones(shape, **kw)
        self.weight = torch.zeros(shape, **kw)
        self.color = torch.zeros(shape + (3,), **kw)
        g = [float(self.bounds[0][i])
             + torch.arange(shape[i], dtype=torch.float64,
                            device=self.device) * voxel_size
             for i in range(3)]
        xx, yy, zz = torch.meshgrid(*g, indexing="ij")
        self._pts = torch.stack([xx, yy, zz], -1).reshape(-1, 3)

    def integrate(self, rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                  c2w_gl: np.ndarray, depth_max: float = 10.0):
        """Integrate one frame. rgb (H, W, 3) [0,1]; depth (H, W) z-depth;
        c2w OpenGL convention."""
        H, W = depth.shape
        c2w = np.asarray(c2w_gl, np.float64).copy()
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        w2c = torch.as_tensor(np.linalg.inv(c2w), device=self.device)
        cam = self._pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam[:, 2]
        zc = torch.clamp(z, min=1e-9)
        # torch.round, as np.round, rounds half to even
        u = torch.round(float(K[0, 0]) * cam[:, 0] / zc
                        + float(K[0, 2])).long()
        v = torch.round(float(K[1, 1]) * cam[:, 1] / zc
                        + float(K[1, 2])).long()
        del cam, zc
        valid = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        flat = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
        del u, v
        d = torch.as_tensor(depth, device=self.device).reshape(-1)[flat]
        valid &= (d > 0) & (d < depth_max)
        sdf = d - z                       # float32 - float64: float64
        valid &= sdf > -self.sdf_trunc
        tsdf_new = torch.clamp(sdf / self.sdf_trunc, -1.0, 1.0)
        del d, sdf

        w_old = self.weight.reshape(-1)
        t_old = self.tsdf.reshape(-1)
        c_old = self.color.reshape(-1, 3)
        w_new = valid.double()
        w_tot = w_old + w_new
        t_upd = torch.where(valid, (t_old * w_old + tsdf_new * w_new)
                            / torch.clamp(w_tot, min=1e-9), t_old)
        c_frame = torch.as_tensor(rgb, device=self.device).reshape(-1, 3)[flat]
        c_upd = torch.where(valid[:, None],
                            (c_old * w_old[:, None] + c_frame * w_new[:, None])
                            / torch.clamp(w_tot[:, None], min=1e-9), c_old)
        self.tsdf = t_upd.reshape(self.tsdf.shape).float()
        self.weight = w_tot.reshape(self.weight.shape).float()
        self.color = c_upd.reshape(self.color.shape).float()

    def extract_mesh(self, min_weight: float = 1.0):
        """Zero iso-surface of the fused TSDF (observed voxels only),
        extracted on the host: (vertices (V, 3) float32, faces, colors
        (V, 3) or None)."""
        vol = torch.where(self.weight >= min_weight, self.tsdf,
                          1.0).cpu().numpy()
        verts_idx, faces, _ = meshing.extract_isosurface(vol, level=0.0)
        verts = self.bounds[0] + verts_idx * self.voxel_size
        colors = None
        if len(verts):
            idx = np.clip(np.round(verts_idx).astype(int), 0,
                          np.asarray(self.dims) - 1)
            idx = torch.as_tensor(idx, device=self.device)
            colors = self.color[idx[:, 0], idx[:, 1], idx[:, 2]].cpu().numpy()
        return verts.astype(np.float32), faces, colors


def run_tsdf_fusion(images, depths, masks, K, poses_gl, voxel_size=0.02,
                    bounds=None, mask_out_object: bool = True,
                    depth_max: float = 10.0, device="cuda"):
    """Fuse the background (object masked out) like reconstruct_bg_mesh
    (visualizer.py:110-125): depth of masked-object pixels is dropped. The
    volume is on `device`."""
    if bounds is None:
        bounds = np.array([[-4.0, -4.0, -4.0], [4.0, 4.0, 4.0]])
    vol = TSDFVolume(bounds, voxel_size, device=device)
    for i in range(len(images)):
        d = depths[i].copy()
        if mask_out_object:
            d[masks[i] > 0.5] = 0.0
        vol.integrate(images[i], d, K, poses_gl[i], depth_max=depth_max)
    return vol
