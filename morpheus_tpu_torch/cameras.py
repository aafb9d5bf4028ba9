"""Camera and ray math (reference: datasets/utils.py, datasets/dataset.py).

numpy versions for host-side scene set-up and torch versions for what runs
inside a training step (the per-frame pose correction, the virtual camera
of the SDS step: port of morpheus_tpu/cameras.py:49-152), and the
decomposition of a projection matrix that the preprocessing and the viewer
read their cameras with (load_K_Rt_from_P).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .utils import safe_normalize


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


# ---- torch: the virtual camera of the SDS step -------------------------------

def look_at(cam_centers: torch.Tensor, targets=0.0) -> torch.Tensor:
    """OpenGL look-at camera-to-world matrices (B, 4, 4), keeping the
    chirality (ref: dataset.py:225-266); the torch form of
    c2w_from_cam_center, with targets."""
    forward = safe_normalize(cam_centers - targets)
    up = _const((0.0, 1.0, 0.0), cam_centers.dtype,
                cam_centers.device).expand(forward.shape)
    right = safe_normalize(torch.linalg.cross(up, forward, dim=-1))
    up = safe_normalize(torch.linalg.cross(forward, right, dim=-1))
    rot = torch.stack((right, up, forward), dim=-1)             # (B, 3, 3)
    top = torch.cat([rot, cam_centers[..., None]], -1)          # (B, 3, 4)
    last = _const((0.0, 0.0, 0.0, 1.0), top.dtype,
                  top.device).expand(top.shape[0], 1, 4)
    return torch.cat([top, last], 1)


@functools.lru_cache(maxsize=16)
def _const(values: tuple, dtype, device) -> torch.Tensor:
    """A small constant, made once per dtype and device: a copy from host
    memory waits for the card, and a CUDA graph cannot capture one."""
    return torch.tensor(values, dtype=dtype, device=device)


def polar_to_cam_center(radius, theta_rad, phi_rad) -> torch.Tensor:
    """Spherical to cartesian with the reference's y-up convention
    (ref: dataset.py:312-316)."""
    return torch.stack([radius * torch.sin(theta_rad) * torch.sin(phi_rad),
                        radius * torch.cos(theta_rad),
                        radius * torch.sin(theta_rad) * torch.cos(phi_rad)],
                       dim=-1)


def get_view_direction(thetas_rad: torch.Tensor, phis_rad: torch.Tensor,
                       overhead_rad: float, front_rad: float
                       ) -> torch.Tensor:
    """Discrete view direction (0 front, 1 side, 2 back, 3 side, 4 top, 5
    bottom), int64 (B,) (ref: datasets/utils.py:70-91)."""
    two_pi = 2.0 * math.pi
    phis = torch.remainder(phis_rad, two_pi)
    res = torch.zeros(thetas_rad.shape[0], dtype=torch.long,
                      device=thetas_rad.device)
    res = torch.where((phis >= math.pi + front_rad / 2)
                      & (phis < two_pi - front_rad / 2), 1, res)
    res = torch.where((phis >= math.pi - front_rad / 2)
                      & (phis < math.pi + front_rad / 2), 2, res)
    res = torch.where((phis >= front_rad / 2)
                      & (phis < math.pi - front_rad / 2), 3, res)
    res = torch.where(thetas_rad <= overhead_rad, 4, res)
    return torch.where(thetas_rad >= math.pi - overhead_rad, 5, res)


def _deg2rad(x) -> np.float32:
    return np.float32(x) * np.float32(math.pi / 180.0)


def sample_virtual_camera(draws, radius: torch.Tensor, theta_range_deg,
                          phi_range_deg, uniform_sphere_rate: float = 0.0):
    """One random virtual camera (ref: dataset.py:435-501): polar angles
    uniform in the ranges (degrees), or, with probability
    uniform_sphere_rate, a direction uniform on the upper hemisphere.
    Draws: 'cam_theta' (1,), 'cam_phi' (1,), 'cam_sphere' (1, 3) and
    'cam_sphere_pick' (). Returns (c2w (1, 4, 4), theta_deg (1,), phi_deg
    (1,)), all on radius's device."""
    th_lo, th_hi = (_deg2rad(a) for a in theta_range_deg)
    ph_lo, ph_hi = (_deg2rad(a) for a in phi_range_deg)
    two_pi = 2 * math.pi

    theta_r = draws.uniform("cam_theta", (1,)) * float(th_hi - th_lo) \
        + float(th_lo)
    phi_r = draws.uniform("cam_phi", (1,)) * float(ph_hi - ph_lo) \
        + float(ph_lo)
    phi_r = torch.where(phi_r < 0, phi_r + two_pi, phi_r)

    g = draws.normal("cam_sphere", (1, 3))
    unit = safe_normalize(torch.stack([g[:, 0], g[:, 1].abs(), g[:, 2]], -1))
    theta_u = torch.arccos(torch.clamp(unit[:, 1], -1.0, 1.0))
    phi_u = torch.atan2(unit[:, 0], unit[:, 2])
    phi_u = torch.where(phi_u < 0, phi_u + two_pi, phi_u)

    use_uniform = draws.uniform("cam_sphere_pick", ()) < uniform_sphere_rate
    theta = torch.where(use_uniform, theta_u, theta_r)
    phi = torch.where(use_uniform, phi_u, phi_r)
    c2w = look_at(polar_to_cam_center(radius, theta, phi))
    return c2w, torch.rad2deg(theta), torch.rad2deg(phi)


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection matrix into intrinsics (4, 4) and a c2w
    pose (4, 4) float32 (port of morpheus_tpu/cameras.py:164-191): an RQ
    decomposition by a flipped QR in numpy, in place of the reference's
    cv2.decomposeProjectionMatrix (datasets/utils.py:5-26)."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    # RQ decomposition of M = K R via flipped QR
    Pflip = np.flipud(M).T
    Q, R = np.linalg.qr(Pflip)
    K = np.flipud(np.fliplr(R.T))
    Rmat = np.flipud(Q.T)
    # enforce positive diagonal on K
    sign = np.diag(np.sign(np.diag(K)))
    K = K @ sign
    Rmat = sign @ Rmat
    if np.linalg.det(Rmat) < 0:
        Rmat = -Rmat
    t = np.linalg.solve(K, P[:, 3])
    cam_center = -Rmat.T @ t
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rmat.T
    pose[:3, 3] = cam_center
    return intrinsics, pose
