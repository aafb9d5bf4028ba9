"""Per-frame mesh rendering from real/360 trajectories (port of
morpheus_tpu/vis/mesh_video.py; replaces the reference's Open3D offscreen
Visualizer loop, morpheus.py:418-470 render_all_meshes + tools/vis.py).
Host code: the meshes are rasterized with numpy (eval/rasterizer.py)."""
from __future__ import annotations

import os

import numpy as np

from ..cameras import c2w_from_polar, euler_to_rotation
from ..eval.rasterizer import render_mesh_view
from ..ops import meshing
from .video import write_frames_video


def render_all_meshes(trainer, mesh_dir: str, save_images_dir: str,
                      save_video_dir: str, epoch: int, scale: float = 1.0,
                      view_360: bool = False, video_name: str = "video_real",
                      save_depths_dir: str | None = None,
                      save_video: bool = True):
    """Render each frame's exported mesh from the (pose-corrected) real
    trajectory or a 360° orbit; optionally save float depth maps for the
    depth-L1 metric (morpheus.py:418-470). The pose correction is the live
    field's (trainer.field.pose)."""
    import cv2

    ds = trainer.dataset
    K = np.asarray(ds.intrinsics, np.float64).copy()
    H, W = int(ds.H * scale), int(ds.W * scale)
    K[0, :] *= scale
    K[1, :] *= scale
    os.makedirs(save_images_dir, exist_ok=True)
    if save_depths_dir:
        os.makedirs(save_depths_dir, exist_ok=True)

    video_name = f"{video_name}_{epoch:04d}"
    depth_np = {}
    frames = []

    if not view_360:
        # learned pose correction applied to the stored pose
        # (morpheus.py:441-445)
        pose_params = trainer.field.pose.detach().cpu()
        Rs = euler_to_rotation(pose_params[:, :3]).numpy()
        pose_params = pose_params.numpy()
        c2ws = []
        for i in range(ds.num_frames):
            deltaT = np.eye(4)
            deltaT[:3, :3] = Rs[i]
            deltaT[:3, 3] = pose_params[i, 3:6]
            c2ws.append(deltaT @ np.asarray(ds.poses[i], np.float64))
    else:
        theta = np.full((ds.num_frames,),
                        trainer.config["data"]["default_polar"], np.float64)
        phi = np.arange(ds.num_frames, dtype=np.float64) \
            / ds.num_frames * 360.0
        radius = np.asarray(ds.radius, np.float64)[:ds.num_frames]
        c2ws = list(np.asarray(c2w_from_polar(radius, theta, phi),
                               np.float64))

    for i in range(ds.num_frames):
        path = os.path.join(mesh_dir, f"mesh_{epoch:04d}_{i:04d}.ply")
        verts, faces, colors = meshing.load_ply(path)
        rgb, depth = render_mesh_view(verts, faces,
                                      np.asarray(c2ws[i], np.float64), K, H, W,
                                      vertex_colors=colors)
        img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(save_images_dir, f"{i:04d}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        frames.append(img)
        if save_depths_dir is not None:
            cv2.imwrite(os.path.join(save_depths_dir, f"{i:04d}.png"),
                        (depth * 1000).astype(np.uint16))
            depth_np[f"depth_{i}"] = depth

    if save_video:
        os.makedirs(save_video_dir, exist_ok=True)
        write_frames_video(os.path.join(save_video_dir, f"{video_name}.mp4"),
                           np.stack(frames))
    if save_depths_dir is not None:
        np.savez(os.path.join(save_depths_dir, "depths.npz"), **depth_np)
    return frames
