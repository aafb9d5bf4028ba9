"""RGB-D sequence held in memory and real-view ray sampling
(port of morpheus_tpu/data/dataset.py: DeformDataset for an in-memory scene,
device_data, sample_real_view_rays)."""
from __future__ import annotations

import numpy as np
import torch

from .. import cameras
from .synthetic import make_synthetic_scene


class DeformDataset:
    """Wraps an in-memory scene dict (see data/synthetic.py). Loading a
    preprocessed sequence from disk is not ported yet (ROADMAP.md A8)."""

    def __init__(self, config: dict, scene: dict):
        if config["data"].get("outlier_remove", False):
            raise NotImplementedError(
                "data.outlier_remove: not ported (ROADMAP.md queue A, A8)")
        self.cfg = config
        self.images = scene["images"]          # (T,H,W,3) float [0,1]
        self.depths = scene["depths"]          # (T,H,W) meters
        self.masks = scene["masks"]            # (T,H,W) float [0,1]
        self.poses = scene["poses"]            # (T,4,4) OpenGL c2w
        self.intrinsics = np.asarray(scene["K"], np.float64)
        self.radius = scene["radius"]
        self.theta = scene["theta"]
        self.phi = scene["phi"]
        self.num_frames = self.images.shape[0]
        self.H, self.W = self.images.shape[1:3]
        # the reference reads it from a float32 box: float(float32(1.01))
        self.bound = float(np.float32(1.01))

    def device_data(self, device, scale: float = 1.0) -> dict:
        """All frames and the camera-space ray grid as tensors on `device`,
        at an optional image scale (reference known_view_scale)."""
        H, W = int(scale * self.H), int(scale * self.W)
        K = cameras.scale_intrinsics(self.intrinsics, scale)
        if (H, W) != (self.H, self.W):
            import cv2
            images = np.stack([cv2.resize(im, (W, H),
                                          interpolation=cv2.INTER_LINEAR)
                               for im in self.images])
            depths = np.stack([cv2.resize(d, (W, H),
                                          interpolation=cv2.INTER_NEAREST)
                               for d in self.depths])
            masks = np.stack([cv2.resize(m, (W, H),
                                         interpolation=cv2.INTER_NEAREST)
                              for m in self.masks])
        else:
            images, depths, masks = self.images, self.depths, self.masks
        rays_d_cam = cameras.get_camera_rays(H, W, K[0, 0], K[1, 1], K[0, 2],
                                             K[1, 2])

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)

        T = self.num_frames
        return {
            "images": t(images.reshape(T, H * W, 3)),
            "depths": t(depths.reshape(T, H * W)),
            "masks": t(masks.reshape(T, H * W)),
            "poses": t(self.poses),
            "rays_d_cam": t(rays_d_cam.reshape(H * W, 3)),
            "H": H, "W": W,
        }


def sample_real_view_rays(draws, data: dict, num_frames: int,
                          ray_num: int) -> dict:
    """One random frame, `ray_num` random pixels of it (reference
    dataset.py:398-433); (ray_num, ...) tensors."""
    n_pix = data["rays_d_cam"].shape[0]
    frame_idx = draws.randint("frame", (), 0, num_frames)
    pix = draws.randint("pix", (ray_num,), 0, n_pix)
    # index_select throughout: indexing by a 0-d card tensor reads it back
    # to the host, which waits for the card
    f = frame_idx.reshape(1)
    pose = data["poses"].index_select(0, f)[0]
    d_cam = data["rays_d_cam"].index_select(0, pix)
    flat = f * n_pix + pix
    t_norm = frame_idx.to(torch.float32) / num_frames
    return {
        "rays_o": pose[:3, 3].expand(ray_num, 3),
        "rays_d": (d_cam[..., None, :] * pose[:3, :3]).sum(-1),
        "rays_t": t_norm.reshape(1, 1).expand(ray_num, 1),
        "rays_id": f.expand(ray_num),
        "image": data["images"].reshape(-1, 3).index_select(0, flat),
        "depth": data["depths"].reshape(-1).index_select(0, flat),
        "mask": data["masks"].reshape(-1).index_select(0, flat),
        "frame_idx": frame_idx,
    }


def load_synthetic(config: dict) -> DeformDataset:
    """The `data_dir: "<synthetic>"` scene of a config (morpheus.py:105-113)."""
    if config["data"]["data_dir"] != "<synthetic>":
        raise NotImplementedError(
            "on-disk datasets are not ported yet (ROADMAP.md queue A, A8)")
    res = int(config["data"].get("synthetic_res", 64))
    scene = make_synthetic_scene(
        num_frames=int(config["data"].get("synthetic_frames", 8)), H=res, W=res)
    return DeformDataset(config, scene)
