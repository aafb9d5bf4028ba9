"""World-space composition viewer of the port (port of visualizer.py):

    python -m morpheus_tpu_torch.visualizer --config configs/snoopy.yaml \\
        --traj 360|real_view [--device cuda|cpu] [section --key value ...]

Reloads the final checkpoint, TSDF-fuses the static background from the raw
(masked-out) RGB-D frames on the device, exports every frame's colored
foreground mesh at 256^3 through the field on the device, moves the meshes
into the raw world frame through the NDR-to-raw pose algebra, and renders a
360-degree or real-view fly-through with the host rasterizer. Writes
<workspace>/scene_renderings/rgb/*.png and render_<traj>.mp4; the background
mesh is kept at <data_dir>/scene_meshes/bg_mesh.ply and reused. Ends with a
`viewer-stats {json}` line (the seconds of each part, the background's size,
the frames written) and a `kernel-launches {json}` line.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time
from glob import glob

import numpy as np

# the foreground meshes' resolution (visualizer.py:156's mesh_final_color_256)
FG_RES = 256


class Renderer:
    def __init__(self, config: dict, device="cuda"):
        from .data.dataset import RenderDataset
        from .train.trainer import Trainer
        from .utils import resolve_device

        self.config = config
        self.device = resolve_device(device)
        self.workspace = os.path.join(config["exp"]["output"],
                                      config["exp"]["exp_name"])
        self.dataset = RenderDataset(config)
        self.trainer = Trainer(config, self.dataset, device=self.device,
                               workspace=self.workspace)
        ckpt = os.path.join(self.workspace, "models",
                            f"model_ep_{config['train']['n_epochs']:04d}.pkl")
        if os.path.exists(ckpt):
            self.trainer.load_ckpt(ckpt)
        else:
            print(f"[warn] checkpoint {ckpt} not found; using random weights")
        # seconds of each part and the sizes of what was built
        self.stats: dict = {}

    def get_recon2world_transform(self, offset=None):
        """NDR(normalized recon space) → raw world per frame
        (visualizer.py:96-108)."""
        out = []
        for i in range(self.dataset.num_frames):
            c2w_raw = copy.deepcopy(self.dataset.poses_raw[i])
            c2w_ndr = copy.deepcopy(self.dataset.poses_ndr[i])
            c2w_ndr[:3, :3] /= self.dataset.sc_ndr
            t = c2w_raw @ np.linalg.inv(c2w_ndr)
            if offset is not None:
                t = t @ offset
            out.append(t)
        return out

    def reconstruct_bg_mesh(self, bg_mesh_path, voxel_size=0.02):
        """TSDF-fuse the background from masked-out raw frames on the
        device (visualizer.py:110-125)."""
        from .eval.tsdf import run_tsdf_fusion
        from .ops import meshing

        os.makedirs(os.path.dirname(bg_mesh_path), exist_ok=True)
        raw = self.dataset.raw
        t0 = time.perf_counter()
        vol = run_tsdf_fusion(raw["images"], raw["depths"], raw["masks"],
                              self.dataset.K_raw, self.dataset.poses_raw,
                              voxel_size=voxel_size, device=self.device)
        observed = int((vol.weight > 0).sum())
        t1 = time.perf_counter()
        verts, faces, colors = vol.extract_mesh()
        meshing.save_ply(bg_mesh_path, verts, faces, colors)
        self.stats.update(
            tsdf_s=t1 - t0, bg_mesh_s=time.perf_counter() - t1,
            bg_voxels=int(np.prod(vol.dims)), bg_observed_voxels=observed,
            bg_faces=len(faces))
        return verts, faces, colors

    def reconstruct_fg_mesh(self, mesh_dir, resolution=FG_RES, color=True):
        from . import mesh_export
        t0 = time.perf_counter()
        infos = mesh_export.export_all_meshes(
            self.trainer.field, mesh_dir, self.dataset.num_frames,
            self.config["train"]["n_epochs"], resolution=resolution,
            color=color)
        self.stats.update(fg_export_s=time.perf_counter() - t0,
                          fg_exports=len(infos),
                          fg_faces=[i["faces"] for i in infos])
        return infos

    def render_world_video(self, mesh_dir, traj_mode="360", scale=1.0,
                           up_tilt_deg=8.0):
        import cv2

        from .eval.rasterizer import render_mesh_view
        from .ops import meshing
        from .vis.pose_utils import create_360_trajectory, rot_x
        from .vis.video import write_frames_video

        mesh_transforms = self.get_recon2world_transform()

        bg_mesh_path = os.path.join(self.config["data"]["data_dir"],
                                    "scene_meshes", "bg_mesh.ply")
        if not os.path.exists(bg_mesh_path):
            self.reconstruct_bg_mesh(bg_mesh_path)
        bg_v, bg_f, bg_c = meshing.load_ply(bg_mesh_path)

        if not os.path.exists(mesh_dir) or not glob(os.path.join(mesh_dir,
                                                                 "*.ply")):
            self.reconstruct_fg_mesh(mesh_dir)
        mesh_files = sorted(glob(os.path.join(mesh_dir, "*.ply")))

        ndr2world = mesh_transforms[0]
        target = self.dataset.poses_raw[0][:3, -1] + (
            ndr2world[:3, :3] @ -self.dataset.poses_ndr[0][:3, -1])
        o2w_align = np.eye(4)
        o2w_align[:3, :3] = rot_x(np.deg2rad(up_tilt_deg))
        o2w_align[:3, -1] = np.asarray(target).squeeze()
        up_vec = o2w_align[:3, 1]

        if traj_mode == "real_view":
            c2w_list = list(self.dataset.poses_raw)
        elif traj_mode == "360":
            c2w_ref = copy.deepcopy(self.dataset.poses_raw[0])
            c2w_list = create_360_trajectory(c2w_ref, target, up_vec,
                                             self.dataset.num_frames)
        else:
            raise NotImplementedError(traj_mode)

        H = int(self.dataset.raw["images"].shape[1] * scale)
        W = int(self.dataset.raw["images"].shape[2] * scale)
        K = copy.deepcopy(np.asarray(self.dataset.K_raw, np.float64))
        K[0, :] *= scale
        K[1, :] *= scale

        save_dir = os.path.join(self.workspace, "scene_renderings")
        rgb_dir = os.path.join(save_dir, "rgb")
        os.makedirs(rgb_dir, exist_ok=True)

        frames = []
        raster_s = png_s = 0.0
        for i, mesh_file in enumerate(mesh_files):
            t0 = time.perf_counter()
            fv, ff, fc = meshing.load_ply(mesh_file)
            T = mesh_transforms[i]
            fv = fv @ T[:3, :3].T + T[:3, 3]
            # composite fg + bg into one mesh for the z-buffered render
            verts = np.concatenate([fv, bg_v], 0)
            faces = np.concatenate([ff, bg_f + len(fv)], 0)
            cols_f = fc if fc is not None else np.full((len(fv), 3), 0.75)
            cols_b = bg_c if bg_c is not None else np.full((len(bg_v), 3), 0.6)
            colors = np.concatenate([cols_f, cols_b], 0)
            rgb, _ = render_mesh_view(verts, faces, c2w_list[i], K, H, W,
                                      vertex_colors=colors)
            img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            t1 = time.perf_counter()
            cv2.imwrite(os.path.join(rgb_dir, f"{i:04d}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            frames.append(img)
            raster_s += t1 - t0
            png_s += time.perf_counter() - t1

        t0 = time.perf_counter()
        write_frames_video(os.path.join(save_dir,
                                        f"render_{traj_mode}.mp4"),
                           np.stack(frames), fps=25)
        self.stats.update(raster_s=raster_s, png_s=png_s,
                          video_s=time.perf_counter() - t0,
                          frames=len(frames), size=[H, W],
                          bg_mesh_faces=len(bg_f))
        return frames


def main(argv=None):
    from .__main__ import kernel_launches
    from .config import parse_cli

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--traj", type=str, default="360",
                     help="the camera path: 360 or real_view")
    pre.add_argument("--device", default="cuda",
                     help="where the field and the fusion run (cuda or cpu)")
    args, rest = pre.parse_known_args(argv)
    config = parse_cli(rest)
    renderer = Renderer(config, device=args.device)
    mesh_dir = os.path.join(renderer.workspace, f"mesh_final_color_{FG_RES}")
    renderer.render_world_video(mesh_dir, args.traj)
    print("viewer-stats " + json.dumps(renderer.stats), flush=True)
    print("kernel-launches " + json.dumps(kernel_launches()), flush=True)


if __name__ == "__main__":
    main()
