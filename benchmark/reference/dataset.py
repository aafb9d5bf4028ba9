"""An in-memory RGB-D sequence, real-view ray sampling and the virtual
views (the port's data/dataset.py: DeformDataset on a scene dict,
device_data, sample_real_view_rays, VirtualViewSampler)."""
from __future__ import annotations

import numpy as np
import torch

from . import cameras


class DeformDataset:
    """An in-memory scene dict (synthetic.py)."""

    def __init__(self, config: dict, scene: dict):
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


def _pose_rays(pose: torch.Tensor, d_cam: torch.Tensor, frame_idx: int,
               num_frames: int) -> dict:
    """Rays of every pixel of d_cam (N, 3) under one c2w pose, at frame
    frame_idx's time."""
    N = d_cam.shape[0]
    dev = d_cam.device
    return {
        "rays_o": pose[:3, 3].expand(N, 3),
        "rays_d": (d_cam[..., None, :] * pose[:3, :3]).sum(-1),
        "rays_t": torch.full((N, 1), frame_idx / num_frames, device=dev),
        "rays_id": torch.full((N,), frame_idx, dtype=torch.long, device=dev),
    }


def full_frame_rays(data: dict, num_frames: int, frame_idx: int) -> dict:
    """All rays of one frame (eval/video rendering)."""
    return _pose_rays(data["poses"][frame_idx], data["rays_d_cam"],
                      frame_idx, num_frames)


class VirtualViewSampler:
    """Virtual-view rays at a fixed novel-view scale (reference:
    dataset.py:435-578): a random frame and a random camera on its orbit
    (the SDS virtual step; the draws stay on the device), or a given frame
    at given polar angles (the test videos; host arithmetic)."""

    def __init__(self, dataset: DeformDataset, config: dict, scale: float,
                 device):
        self.config = config
        self.num_frames = dataset.num_frames
        self.H = int(scale * dataset.H)
        self.W = int(scale * dataset.W)
        K = cameras.scale_intrinsics(dataset.intrinsics, scale)
        rays = cameras.get_camera_rays(self.H, self.W, K[0, 0], K[1, 1],
                                       K[0, 2], K[1, 2]).reshape(-1, 3)
        self.device = device
        self.rays_d_cam = torch.as_tensor(rays, device=device)
        self.radius = np.asarray(dataset.radius, np.float32)
        self.theta = np.asarray(dataset.theta, np.float32)
        self.phi = np.asarray(dataset.phi, np.float32)
        # the per-frame orbit (radius, polar, azimuth) on the device, read
        # by index_select with the drawn frame
        self.orbit = torch.as_tensor(np.stack(
            [self.radius, self.theta, self.phi], -1), device=device)

    def sample(self, frame_idx: int | None = None, theta_deg=None,
               phi_deg=None, *, draws=None, radius_scale=None,
               theta_range=None, phi_range=None) -> dict:
        """Rays of one camera and its offsets from the frame's real view
        (polar, azimuth: degrees, azimuth wrapped to (-180, 180]; radius).
        With theta_deg and phi_deg, the camera at those polar angles
        (reference get_c2w_from_polar, dataset.py:526-532) of frame
        frame_idx; without, a random camera (cameras.sample_virtual_camera
        with draws) of frame frame_idx, or of a random frame (draw
        'vframe'), the angles in theta_range and phi_range (degrees; the
        config's data.theta_range and data.phi_range by default).
        radius_scale scales the orbit's radius."""
        data = self.config["data"]
        if theta_deg is not None and frame_idx is not None:
            radius = self.radius[frame_idx] * np.float32(
                data["novel_view_scale_factor"])
            if radius_scale is not None:
                radius = radius * np.float32(radius_scale)
            thetas = np.asarray(theta_deg, np.float32).reshape(1)
            phis = np.asarray(phi_deg, np.float32).reshape(1)
            pose = torch.as_tensor(
                cameras.c2w_from_polar(radius, thetas, phis)[0],
                device=self.device)
            out = _pose_rays(pose, self.rays_d_cam, frame_idx,
                             self.num_frames)
            delta_azimuth = phis - self.phi[frame_idx]
            delta_azimuth = np.where(delta_azimuth > 180, delta_azimuth - 360,
                                     delta_azimuth)
            out.update({
                "polar": thetas - self.theta[frame_idx],
                "azimuth": delta_azimuth.astype(np.float32),
                "radius": np.reshape(radius - self.radius[frame_idx], (1,)),
                "frame_idx": frame_idx, "H": self.H, "W": self.W})
            return out
        return self._sample_device(draws, frame_idx, theta_deg, phi_deg,
                                   radius_scale, theta_range, phi_range)

    def _sample_device(self, draws, frame_idx, theta_deg, phi_deg,
                       radius_scale, theta_range, phi_range) -> dict:
        data = self.config["data"]
        nf = self.num_frames
        if draws is None and (frame_idx is None or theta_deg is None):
            raise ValueError("a random frame or camera needs draws")
        if frame_idx is None:
            frame = draws.randint("vframe", (), 0, nf).to(self.device)
        else:
            frame = torch.tensor(frame_idx, device=self.device)
        f = frame.reshape(1).long()
        orbit = self.orbit.index_select(0, f)[0]              # (3,)
        radius = orbit[0] * float(np.float32(data["novel_view_scale_factor"]))
        if radius_scale is not None:
            radius = radius * float(np.float32(radius_scale))
        if theta_deg is None:
            c2w, thetas, phis = cameras.sample_virtual_camera(
                draws, radius,
                theta_range if theta_range is not None
                else data["theta_range"],
                phi_range if phi_range is not None else data["phi_range"],
                data["uniform_sphere_rate"])
        else:
            thetas = torch.tensor(theta_deg, dtype=torch.float32,
                                  device=self.device).reshape(1)
            phis = torch.tensor(phi_deg, dtype=torch.float32,
                                device=self.device).reshape(1)
            c2w = cameras.look_at(cameras.polar_to_cam_center(
                radius, torch.deg2rad(thetas), torch.deg2rad(phis)))
        pose = c2w[0]
        N = self.rays_d_cam.shape[0]
        delta_azimuth = phis - orbit[2]
        delta_azimuth = torch.where(delta_azimuth > 180, delta_azimuth - 360,
                                    delta_azimuth)
        return {
            "rays_o": pose[:3, 3].expand(N, 3),
            "rays_d": (self.rays_d_cam[..., None, :] * pose[:3, :3]).sum(-1),
            "rays_t": (frame.float() / nf).reshape(1, 1).expand(N, 1),
            "rays_id": f.expand(N),
            "polar": thetas - orbit[1], "azimuth": delta_azimuth,
            "radius": (radius - orbit[0]).reshape(1), "frame_idx": frame,
            "H": self.H, "W": self.W}
