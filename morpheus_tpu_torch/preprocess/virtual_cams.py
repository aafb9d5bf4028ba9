"""Virtual-camera generation: raw RGB-D + cameras_sphere.npz -> the training
layout (color_virt/ depth_raw_crop/ mask_virt/ poses_virt/ padding_mask/
K_virt.txt r_theta_phi.txt); port of morpheus_tpu/preprocess/virtual_cams.py,
host code, writing the same files.

Pure-numpy port of preprocess/preprocess.py (Database/DataProcessor): decompose
P=K·w2c, normalize by scale_mat, polar coords of each camera, re-aim cameras at
the object centre, rotate+crop frames to size_h×size_w around the projected
centre."""
from __future__ import annotations

import os

import numpy as np

from ..cameras import load_K_Rt_from_P
from ..data.dataset import read_raw_frames


def _gl2cv(c2w):
    out = c2w.copy()
    out[:, 1] *= -1
    out[:, 2] *= -1
    return out


def _safe_normalize(v, eps=1e-20):
    return v / np.sqrt(np.maximum((v * v).sum(-1, keepdims=True), eps))


def load_raw_sequence(data_dir: str, depth_scale: float = 1000.0,
                      cameras_name: str = "cameras_sphere.npz"):
    """rgb/depth/mask + normalized OpenGL c2w poses + per-frame intrinsics
    (Database, preprocess.py:21-133); rgb/*.jpg before rgb/*.png."""
    raw = read_raw_frames(data_dir, depth_scale, image_exts=("jpg", "png"))
    images, depths, masks = raw["images"], raw["depths"], raw["masks"]
    n = images.shape[0]

    cams = np.load(os.path.join(data_dir, cameras_name))
    align = np.diag([1.0, -1.0, -1.0, 1.0])
    poses, Ks, scales = [], [], []
    for i in range(n):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        K, pose = load_K_Rt_from_P(P)
        pose = pose.astype(np.float64)
        pose[:3, 1] *= -1          # opencv → opengl
        pose[:3, 2] *= -1
        pose = align @ pose
        poses.append(pose)
        Ks.append(K[:3, :3])
        scales.append(1.0 / cams[f"scale_mat_{i}"][0, 0])
    depths = depths * np.asarray(scales)[:, None, None]
    return {
        "images": images, "depths": depths, "masks": masks,
        "poses": np.stack(poses), "K": np.stack(Ks),
        "num_frames": n,
    }


def polar_from_c2w(poses: np.ndarray, virtual: bool, scale_radius: float = 1.0):
    """(r, θ, φ) of each camera (preprocess.py:264-294). virtual=True derives
    them from the optical axis so the re-aimed camera keeps its distance."""
    centers = poses[:, :3, 3]
    zdirs = poses[:, :3, 2]
    if virtual:
        r = np.sum(centers * zdirs, -1)
        theta = np.arccos(np.clip(zdirs[:, 1], -1, 1))
        phi = np.arctan2(zdirs[:, 0], zdirs[:, 2])
    else:
        r = np.linalg.norm(centers, axis=-1)
        u = centers / r[:, None]
        theta = np.arccos(np.clip(u[:, 1], -1, 1))
        phi = np.arctan2(u[:, 0], u[:, 2])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return (r * scale_radius, np.rad2deg(theta), np.rad2deg(phi))


def c2w_from_polar_with_x(radius, theta_deg, phi_deg, x_axis):
    """Look-at c2w keeping the original camera x-axis (preprocess.py:163-262,
    x_axis branch)."""
    theta = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)
    centers = np.stack([radius * np.sin(theta) * np.sin(phi),
                        radius * np.cos(theta),
                        radius * np.sin(theta) * np.cos(phi)], -1)
    forward = _safe_normalize(centers)        # OpenGL: target at origin
    right = x_axis
    up = _safe_normalize(np.cross(forward, right))
    poses = np.tile(np.eye(4), (len(centers), 1, 1))
    poses[:, :3, :3] = np.stack((right, up, forward), -1)
    poses[:, :3, 3] = centers
    return poses


def _crop_with_padding(img: np.ndarray, top: int, left: int, h: int, w: int):
    """Zero-padded crop + padding mask (preprocess.py crop_image_2d/3d)."""
    H, W = img.shape[:2]
    out = np.zeros((h, w) + img.shape[2:], img.dtype)
    pad = np.ones((h, w), np.float32)
    y0, y1 = max(top, 0), min(top + h, H)
    x0, x1 = max(left, 0), min(left + w, W)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
        pad[y0 - top:y1 - top, x0 - left:x1 - left] = 0.0
    return out, pad


def preprocess_sequence(data_dir: str, size_h: int, size_w: int,
                        rot_degree: float = 0.0, depth_scale: float = 1000.0):
    """Full DataProcessor.preprocess() (preprocess.py:479-514): writes
    color_virt/, depth_raw_crop/, mask_virt/, padding_mask/, poses_virt/,
    K_virt.txt, r_theta_phi.txt (+raw), crop_centre_list.txt."""
    import cv2
    seq = load_raw_sequence(data_dir, depth_scale)
    poses, K = seq["poses"], seq["K"]
    n = seq["num_frames"]
    H, W = seq["images"].shape[1:3]

    radius, theta, phi = polar_from_c2w(poses, virtual=True)
    raw_r, raw_t, raw_p = polar_from_c2w(poses, virtual=False)
    x_axes = poses[:, :3, 0]
    poses_virt = c2w_from_polar_with_x(radius, theta, phi, x_axes)

    fx, fy = K[0][0, 0], K[0][1, 1]
    K_virt = np.array([[fx, 0.0, size_w / 2],
                       [0.0, fy, size_h / 2],
                       [0.0, 0.0, 1.0]])

    dirs = {k: os.path.join(data_dir, k) for k in
            ("color_virt", "depth_raw_crop", "mask_virt", "poses_virt",
             "padding_mask")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    centres = []
    for i in range(n):
        c2w_cv = _gl2cv(poses[i])
        w2c = np.linalg.inv(c2w_cv)
        x_c = w2c[:3, :3] @ np.zeros(3) + w2c[:3, 3]
        p = K[i] @ x_c
        px, py = int(p[0] / p[2]), int(p[1] / p[2])
        centres.append([px, py])

        rgb, depth, mask = seq["images"][i], seq["depths"][i], seq["masks"][i]
        if rot_degree != 0.0:
            R = cv2.getRotationMatrix2D((px, py), rot_degree, 1.0)
            rgb = cv2.warpAffine(rgb, R, (W, H))
            depth = cv2.warpAffine(depth, R, (W, H), flags=cv2.INTER_NEAREST)
            mask = cv2.warpAffine(mask, R, (W, H), flags=cv2.INTER_NEAREST)

        top, left = py - size_h // 2 + 1, px - size_w // 2 + 1
        rgb_c, _ = _crop_with_padding(rgb, top, left, size_h, size_w)
        depth_c, _ = _crop_with_padding(depth, top, left, size_h, size_w)
        mask_c, pad = _crop_with_padding(mask, top, left, size_h, size_w)

        cv2.imwrite(os.path.join(dirs["color_virt"], f"{i:06d}.png"),
                    cv2.cvtColor((rgb_c * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(dirs["depth_raw_crop"], f"{i:06d}.png"),
                    (depth_c * depth_scale).astype(np.uint16))
        cv2.imwrite(os.path.join(dirs["mask_virt"], f"{i:06d}.png"),
                    (mask_c * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(dirs["padding_mask"], f"{i:06d}.png"),
                    (pad * 255).astype(np.uint8))
        np.savetxt(os.path.join(dirs["poses_virt"], f"{i:06d}.txt"),
                   poses_virt[i])

    np.savetxt(os.path.join(data_dir, "K_virt.txt"), K_virt)
    np.savetxt(os.path.join(data_dir, "r_theta_phi.txt"),
               np.stack([radius, theta, phi], -1))
    np.savetxt(os.path.join(data_dir, "raw_r_theta_phi.txt"),
               np.stack([raw_r, raw_t, raw_p], -1))
    np.savetxt(os.path.join(data_dir, "crop_centre_list.txt"),
               np.asarray(centres, np.float64))
    np.savetxt(os.path.join(data_dir, "intrinsics.txt"), K[0])
    return {"poses_virt": poses_virt, "K_virt": K_virt,
            "radius": radius, "theta": theta, "phi": phi}
