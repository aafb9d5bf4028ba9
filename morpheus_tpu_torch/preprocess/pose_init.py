"""Pose initialization from masked RGB-D: per-frame object point clouds
registered to frame 0 with robust ICP -> cameras_sphere.npz (port of
morpheus_tpu/preprocess/pose_init.py; host code, numpy).

Port of the reference's preprocess/pose_init pipeline (step1.py ->
registrate.py -> step3.py -> create_camera.py), with the external C++
Fast-Robust-ICP binary replaced by the Welsch-IRLS robust ICP in
eval/icp.py (graduated non-convexity, same role)."""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from ..eval.icp import robust_icp


def depth_mask_to_points(depth: np.ndarray, mask: np.ndarray,
                         fx, fy, cx, cy, stride: int = 1) -> np.ndarray:
    """Backproject masked depth to camera-frame points (registrate.py
    mask2camera); OpenCV convention (+z forward)."""
    H, W = depth.shape
    v, u = np.nonzero((mask > 0.5) & (depth > 0))
    if stride > 1:
        v, u = v[::stride], u[::stride]
    z = depth[v, u]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    return np.stack([x, y, z], -1)


def register_sequence(depths: np.ndarray, masks: np.ndarray, K: np.ndarray,
                      max_points: int = 20000, icp_iters: int = 50):
    """Per-frame w2c transforms in the frame-0 object frame + normalization
    radius (registrate.py main loop, FRICP replaced by robust_icp).

    Returns (transformations (T,4,4) mapping object coords → camera coords,
    radius scalar)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    T_frames = depths.shape[0]
    rng = np.random.default_rng(0)

    transformations = np.repeat(np.eye(4)[None], T_frames, axis=0)
    all_points = []
    first_centered = None
    for i in range(T_frames):
        xyz = depth_mask_to_points(depths[i], masks[i], fx, fy, cx, cy)
        if len(xyz) > max_points:
            xyz = xyz[rng.choice(len(xyz), max_points, replace=False)]
        trans_coarse = xyz.mean(0)
        T_coarse = np.eye(4)
        T_coarse[:3, 3] = trans_coarse
        centered = xyz - trans_coarse

        if i == 0:
            first_centered = centered
            transformations[0] = T_coarse
            world = centered
        else:
            # register frame-0 object points onto the current frame's points
            T_fine = robust_icp(first_centered, centered, max_iter=icp_iters)
            transformations[i] = T_coarse @ T_fine
            # express current points back in the frame-0 object frame
            world = (centered - T_fine[:3, 3]) @ T_fine[:3, :3]
        all_points.append(world)

    pts = np.concatenate(all_points, 0)
    r = np.linalg.norm(pts, axis=-1)
    # denoise: drop the top 5% then pad 20% (registrate.py radius heuristic)
    r = r[r <= np.percentile(r, 95)]
    radius = float(r.max() * 1.2)
    return transformations, radius


def write_cameras_sphere(out_dir: str, transformations: np.ndarray,
                         radius: float, K: np.ndarray):
    """world_mat_i = K4 @ w2c_i, scale_mat_i = diag(radius)
    (create_camera.py)."""
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = K[:3, :3]
    cam = {}
    for i, w2c in enumerate(transformations):
        cam[f"world_mat_{i}"] = (K4 @ w2c).astype(np.float32)
        cam[f"scale_mat_{i}"] = np.diag(
            [radius, radius, radius, 1.0]).astype(np.float32)
    np.savez(os.path.join(out_dir, "cameras_sphere.npz"), **cam)


def run_pose_init(data_dir: str, depth_scale: float = 1000.0):
    """CLI-equivalent of step1+step3: reads data_dir/{depth,mask,intrinsics.txt},
    writes data_dir/cameras_sphere.npz."""
    import cv2
    K = np.loadtxt(os.path.join(data_dir, "intrinsics.txt"))
    p_depths = sorted(glob(os.path.join(data_dir, "depth/*.png")))
    p_masks = sorted(glob(os.path.join(data_dir, "mask/*.png")))
    depths = np.stack([cv2.imread(p, cv2.IMREAD_UNCHANGED)
                       for p in p_depths]).astype(np.float32) / depth_scale
    masks = np.stack([cv2.imread(p, cv2.IMREAD_UNCHANGED)
                      for p in p_masks]).astype(np.float32)
    if masks.ndim == 4:
        masks = masks[..., 0]
    masks = masks / max(masks.max(), 1.0)
    trans, radius = register_sequence(depths, masks, K)
    os.makedirs(os.path.join(data_dir, "intermediate"), exist_ok=True)
    np.savetxt(os.path.join(data_dir, "intermediate/radius.txt"),
               np.array([radius]), fmt="%.8f")
    np.save(os.path.join(data_dir, "intermediate/transformations.npy"),
            trans.reshape(-1, 16))
    write_cameras_sphere(data_dir, trans, radius, K)
    return trans, radius
