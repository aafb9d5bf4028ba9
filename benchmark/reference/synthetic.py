"""Synthetic RGB-D sequence of a deforming sphere, numpy only
(port of morpheus_tpu/data/synthetic.py)."""
from __future__ import annotations

import numpy as np

from . import cameras


def make_synthetic_scene(num_frames: int = 8, H: int = 64, W: int = 64,
                         radius: float = 0.5, cam_radius: float = 2.5,
                         motion: float = 0.1, fov_deg: float = 40.0) -> dict:
    """images (T,H,W,3), depths (T,H,W), masks (T,H,W), poses (T,4,4) OpenGL
    c2w, K (3,3), radius/theta/phi (T,): the in-memory layout DeformDataset
    reads."""
    fx = 0.5 * W / np.tan(np.deg2rad(fov_deg) / 2)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float64)

    t_idx = np.arange(num_frames)
    phis = t_idx / num_frames * 60.0            # partial orbit like a scan
    thetas = np.full(num_frames, 90.0)
    radii = np.full(num_frames, cam_radius)

    rays_cam = cameras.get_camera_rays(H, W, fx)

    images = np.zeros((num_frames, H, W, 3), np.float32)
    depths = np.zeros((num_frames, H, W), np.float32)
    masks = np.zeros((num_frames, H, W), np.float32)
    poses = np.zeros((num_frames, 4, 4), np.float32)

    for i in range(num_frames):
        c2w = cameras.c2w_from_polar(np.array([cam_radius]),
                                     np.array([thetas[i]]),
                                     np.array([phis[i]]))[0]
        poses[i] = c2w
        # per-frame deformation: the sphere centre slides along x
        center = np.array([motion * np.sin(2 * np.pi * i / num_frames),
                           0.0, 0.0])
        o = c2w[:3, 3]
        # unnormalized directions (d_z = -1 in camera space): depth is the
        # ray parameter t, i.e. z-depth
        d = rays_cam @ c2w[:3, :3].T
        oc = o - center
        a = np.sum(d * d, -1)
        b = np.sum(d * oc, -1)
        c = np.sum(oc * oc) - radius ** 2
        disc = b * b - a * c
        hit = disc > 0
        t_hit = np.where(hit, (-b - np.sqrt(np.clip(disc, 0, None))) / a, 0.0)
        hit = hit & (t_hit > 0)

        pts = o + d * t_hit[..., None]
        n = (pts - center) / radius
        albedo = 0.5 + 0.5 * np.stack([n[..., 0], n[..., 1],
                                       np.ones_like(n[..., 0]) * 0.3], -1)
        images[i] = np.where(hit[..., None], albedo, 1.0)
        depths[i] = np.where(hit, t_hit, 0.0)
        masks[i] = hit.astype(np.float32)

    return {
        "images": images, "depths": depths, "masks": masks, "poses": poses,
        "K": K, "radius": radii.astype(np.float32),
        "theta": thetas.astype(np.float32), "phi": phis.astype(np.float32),
        "num_frames": num_frames, "H": H, "W": W,
        "sphere_radius": radius, "motion": motion,
    }
