"""Camera trajectories of the world-space viewer, numpy only (port of
morpheus_tpu/vis/pose_utils.py; reference: tools/pose_utils.py)."""
from __future__ import annotations

import copy

import numpy as np


def safe_normalize(x, eps=1e-20):
    return x / np.sqrt(np.clip(np.sum(x * x, -1), eps, None))


def rot_x(theta):
    s, c = np.sin(theta), np.cos(theta)
    return np.array([[1., 0., 0.], [0., c, -s], [0., s, c]])


def rot_y(theta):
    s, c = np.sin(theta), np.cos(theta)
    return np.array([[c, 0., s], [0., 1., 0.], [-s, 0., c]])


def rot_z(theta):
    s, c = np.sin(theta), np.cos(theta)
    return np.array([[c, -s, 0.], [s, c, 0.], [0., 0., 1.]])


def cv2gl(c2w):
    c2w = copy.deepcopy(c2w)
    c2w[:, 1] *= -1
    c2w[:, 2] *= -1
    return c2w


gl2cv = cv2gl


def rotate_vector(rotate_axis, theta, v):
    """Rodrigues rotation of v about rotate_axis by theta."""
    k = safe_normalize(rotate_axis)
    c, s = np.cos(theta), np.sin(theta)
    return v * c + s * np.cross(k, v) + k * np.dot(k, v) * (1 - c)


def create_360_trajectory(c2w_ref, target, rotate_axis, num_frames,
                          reverse: bool = False):
    """Orbit the reference camera about `rotate_axis` through `target`
    (tools/pose_utils.py:56-80)."""
    v = c2w_ref[:3, -1] - target
    axes = [c2w_ref[:3, i] for i in range(3)]
    thetas = np.linspace(0.0, -2 * np.pi if reverse else 2 * np.pi, num_frames)
    out = []
    for theta in thetas:
        c2w = np.eye(4)
        c2w[:3, -1] = rotate_vector(rotate_axis, theta, v) + target
        for i in range(3):
            c2w[:3, i] = rotate_vector(rotate_axis, theta, axes[i])
        out.append(c2w)
    return out
