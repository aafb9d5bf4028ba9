"""Mesh extraction from the field (port of morpheus_tpu/mesh_export.py;
reference morpheus.py:367-416).

The dense SDF grid is queried on the field's device in chunks of CHUNK
points, written into one device buffer and copied to the host once per grid.
The iso-surface is extracted on the host (ops/meshing.py, native C++ when it
builds) and written as a PLY.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .model.field import Field
from .ops import meshing

CHUNK = 2 ** 18


def _query(field: Field, n: int, points, t, cano: bool, return_color: bool,
           chunk: int) -> np.ndarray:
    """field.query_density over n points, points(lo, hi) giving each chunk,
    under no_grad; sdf (n,) or albedo (n, 3) as one host array."""
    dev = field.pose.device
    out = torch.empty((n, 3) if return_color else (n,), device=dev)
    tval = 0.0 if t is None else float(t)
    with torch.no_grad():
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            res = field.query_density(points(lo, hi), t=tval, cano=cano,
                                      return_color=return_color)
            out[lo:hi] = res["albedo"] if return_color else res["sdf"]
    return out.cpu().numpy()


def query_sdf_grid(field: Field, resolution: int = 128, t=None,
                   cano: bool = False, chunk: int = CHUNK,
                   bound: float = 1.0) -> np.ndarray:
    """Dense SDF over a [-bound, bound]^3 grid of resolution^3 points
    (morpheus.py:382-395); (R, R, R) float32, index order (x, y, z)."""
    dev = field.pose.device
    R = resolution
    lin = torch.as_tensor(np.linspace(-bound, bound, R, dtype=np.float32),
                          device=dev)

    def points(lo, hi):
        # the (i, j, k) of flat index i*R*R + j*R + k, built on the device
        idx = torch.arange(lo, hi, device=dev)
        return torch.stack([lin[idx // (R * R)], lin[(idx // R) % R],
                            lin[idx % R]], -1)

    sdf = _query(field, R ** 3, points, t, cano or t is None, False, chunk)
    return sdf.reshape(R, R, R)


def vertex_colors(field: Field, verts: np.ndarray, t=None, cano: bool = False,
                  chunk: int = CHUNK) -> np.ndarray:
    """Albedo (V, 3) at the vertices (V, 3) of a mesh (morpheus.py:397-404)."""
    v = torch.as_tensor(np.asarray(verts, np.float32), device=field.pose.device)
    return _query(field, len(v), lambda lo, hi: v[lo:hi], t, cano or t is None,
                  True, chunk)


def export_mesh(field: Field, mesh_path: str, resolution: int = 128, t=None,
                cano: bool = False, color_mesh: bool = True,
                chunk: int = CHUNK):
    """Dense SDF query -> iso-surface -> vertex colors -> PLY
    (morpheus.py:367-408). Returns (vertices, faces, info); info holds the
    seconds of each part (query_s, march_s, color_s, ply_s), the backend of
    the extraction and the mesh's size."""
    os.makedirs(os.path.dirname(mesh_path) or ".", exist_ok=True)
    t0 = time.perf_counter()
    sdf = query_sdf_grid(field, resolution, t=t, cano=cano, chunk=chunk)
    t1 = time.perf_counter()
    verts_idx, faces, backend = meshing.extract_isosurface(sdf, level=0.0)
    verts = verts_idx / (resolution - 1.0) * 2.0 - 1.0
    t2 = time.perf_counter()

    colors = None
    if color_mesh and len(verts):
        colors = vertex_colors(field, verts, t=t, cano=cano, chunk=chunk)
    t3 = time.perf_counter()
    meshing.save_ply(mesh_path, verts.astype(np.float32), faces, colors)
    info = {"path": mesh_path, "resolution": resolution,
            "query_s": t1 - t0, "march_s": t2 - t1, "color_s": t3 - t2,
            "ply_s": time.perf_counter() - t3, "backend": backend,
            "verts": len(verts), "faces": len(faces)}
    return verts, faces, info


def export_all_meshes(field: Field, out_dir: str, num_frames: int, epoch: int,
                      resolution: int = 128, color: bool = False) -> list:
    """Per-frame meshes mesh_{epoch}_{i}.ply at t = i / num_frames
    (morpheus.py:410-416), one frame at a time; the info of each export."""
    infos = []
    for i in range(num_frames):
        infos.append(export_mesh(
            field, os.path.join(out_dir, f"mesh_{epoch:04d}_{i:04d}.ply"),
            resolution=resolution, t=i / num_frames, color_mesh=color)[2])
    return infos
