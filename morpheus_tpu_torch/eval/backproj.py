"""GT backprojection meshes from RGB-D frames.

The reference's 3-D metrics compare culled reconstructions against per-frame
GT meshes shipped with the KillingFusion data as `mesh/backproj_{i}.ply`
(tools/culling.py:262-268). Those are depth-map triangulations; this module
builds the same artifact from any RGB-D sequence — used to generate GT meshes
for the synthetic benchmark scene so the full Acc/Comp/ratio/F-score pipeline
runs without the proprietary scans.
"""
from __future__ import annotations

import os

import numpy as np

from .. import cameras
from ..ops import meshing


def backproject_mesh(depth: np.ndarray, mask: np.ndarray, K: np.ndarray,
                     c2w: np.ndarray, edge_limit: float = 0.05):
    """Triangulate one masked depth map on the pixel grid.

    depth (H, W) is the ray-parameter depth used throughout the dataset
    (positions = o + d * depth with unnormalized OpenGL dirs,
    datasets/utils.py:58). Quads whose corners are valid and whose edges are
    shorter than edge_limit become two triangles (discontinuities are cut).
    Returns (vertices (V, 3) f32, faces (F, 3) i32).
    """
    H, W = depth.shape
    rays = np.asarray(cameras.get_camera_rays(
        H, W, K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    pts = c2w[:3, 3] + (rays @ c2w[:3, :3].T) * depth[..., None]
    valid = (depth > 0) & (mask > 0.5)

    vid = np.full((H, W), -1, np.int64)
    vid[valid] = np.arange(int(valid.sum()))
    verts = pts[valid].astype(np.float32)

    # quad corners a=(i,j) b=(i,j+1) c=(i+1,j) d=(i+1,j+1)
    a, b = vid[:-1, :-1], vid[:-1, 1:]
    c, d = vid[1:, :-1], vid[1:, 1:]
    pa, pb = pts[:-1, :-1], pts[:-1, 1:]
    pc, pd = pts[1:, :-1], pts[1:, 1:]

    def edge_ok(p, q):
        return np.linalg.norm(p - q, axis=-1) < edge_limit

    tri1 = (a >= 0) & (b >= 0) & (c >= 0) \
        & edge_ok(pa, pb) & edge_ok(pa, pc) & edge_ok(pb, pc)
    tri2 = (b >= 0) & (c >= 0) & (d >= 0) \
        & edge_ok(pb, pd) & edge_ok(pc, pd) & edge_ok(pb, pc)
    f1 = np.stack([a[tri1], c[tri1], b[tri1]], -1)
    f2 = np.stack([b[tri2], c[tri2], d[tri2]], -1)
    faces = np.concatenate([f1, f2], 0).astype(np.int32)
    return verts, faces


def write_backproj_meshes(scene: dict, out_dir: str,
                          edge_limit: float = 0.05) -> str:
    """Write mesh/backproj_{i}.ply for every frame of an in-memory scene dict
    (images/depths/masks/poses/K as produced by data.synthetic). Returns the
    directory usable as a dataset data_dir for eval_mesh."""
    mesh_dir = os.path.join(out_dir, "mesh")
    os.makedirs(mesh_dir, exist_ok=True)
    n = len(scene["depths"])
    # deterministic function of the scene — skip the (minutes-long on 1 vCPU)
    # regeneration when a crash-resumed run already wrote every frame
    if all(os.path.exists(os.path.join(mesh_dir, f"backproj_{i}.ply"))
           for i in range(n)):
        return out_dir
    K = np.asarray(scene["K"], np.float64)
    for i in range(len(scene["depths"])):
        v, f = backproject_mesh(np.asarray(scene["depths"][i]),
                                np.asarray(scene["masks"][i]), K,
                                np.asarray(scene["poses"][i], np.float64),
                                edge_limit=edge_limit)
        meshing.save_ply(os.path.join(mesh_dir, f"backproj_{i}.ply"), v, f)
    return out_dir
