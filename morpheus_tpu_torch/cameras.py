"""Camera and ray math (reference: datasets/utils.py, datasets/dataset.py).

numpy versions for host-side scene set-up and torch versions for what runs
inside a training step (the per-frame pose correction).
"""
from __future__ import annotations

import numpy as np
import torch


def get_camera_rays(H: int, W: int, fx, fy=None, cx=None, cy=None
                    ) -> np.ndarray:
    """Per-pixel camera-space ray directions, (H, W, 3) float32, pixel
    centres, OpenGL convention: x right, y up, looking down -z."""
    if fy is None:
        fy = fx
    if cx is None:
        cx, cy = 0.5 * W, 0.5 * H
    fx, fy, cx, cy = (np.float32(v) for v in (fx, fy, cx, cy))
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    return np.stack([(i + np.float32(0.5) - cx) / fx,
                     -((j + np.float32(0.5) - cy) / fy),
                     -np.ones_like(i)], -1)


def scale_intrinsics(K, scale: float) -> np.ndarray:
    """Scale the top two rows of an intrinsics matrix."""
    K = np.array(K, dtype=np.float32)
    K[..., :2, :3] *= np.float32(scale)
    return K


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.sqrt(np.maximum(np.sum(x * x, -1, keepdims=True),
                                  np.float32(1e-20)))


def c2w_from_cam_center(cam_centers: np.ndarray) -> np.ndarray:
    """OpenGL look-at-origin camera-to-world matrices, (B, 4, 4) float32,
    keeping the chirality."""
    forward = _normalize(cam_centers)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), forward.shape)
    right = _normalize(np.cross(up, forward))
    up = _normalize(np.cross(forward, right))
    B = forward.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses[:, :3, :3] = np.stack((right, up, forward), axis=-1)
    poses[:, :3, 3] = cam_centers
    return poses


def c2w_from_polar(radius, theta_deg, phi_deg) -> np.ndarray:
    """Polar coordinates (degrees) to look-at c2w, float32."""
    theta = np.deg2rad(np.asarray(theta_deg, np.float32))
    phi = np.deg2rad(np.asarray(phi_deg, np.float32))
    r = np.asarray(radius, np.float32)
    centers = np.stack([r * np.sin(theta) * np.sin(phi), r * np.cos(theta),
                        r * np.sin(theta) * np.cos(phi)], axis=-1)
    return c2w_from_cam_center(centers)


def euler_to_rotation(rotations: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) to rotation matrices (..., 3, 3); column layout
    of the reference PoseArray (models/pose.py:35-58)."""
    ca, cb, cg = (torch.cos(rotations[..., i]) for i in range(3))
    sa, sb, sg = (torch.sin(rotations[..., i]) for i in range(3))
    col1 = torch.stack([ca * cb, sa * cb, -sb], -1)
    col2 = torch.stack([ca * sb * sg - sa * cg, sa * sb * sg + ca * cg,
                        cb * sg], -1)
    col3 = torch.stack([ca * sb * cg + sa * sg, sa * sb * cg - ca * sg,
                        cb * cg], -1)
    return torch.stack([col1, col2, col3], -1)
