"""Test-video rendering (port of morpheus_tpu/vis/video.py; reference:
morpheus.py:1238-1375 eval_step / render_test_video).

Frames render on the field's device with the EMA weights, in chunks of at
most 300 x 300 rays under no_grad, and come to the host once per frame.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import renderer
from ..data import dataset as data_lib
from ..utils import Draws

FPS = 25


def eval_render(field, occ, rcfg: renderer.RenderConfig, rays: dict,
                cano: bool = False, optimize_pose: bool = False,
                max_chunk: int = 300 * 300, bg_color=1.0, draws=None):
    """Chunked albedo render of a full frame (morpheus.py:1238-1269); numpy
    (image (N, 3), depth (N,), opacity (N,)). rays: rays_o/rays_d/rays_t/
    rays_id (N, ...). The rays are padded with copies of the last one to
    equal chunks, as the JAX package does, so the sample budget splits
    alike. draws() gives each chunk its draws; by default a Draws seeded 0,
    so every chunk's march jitter is the same, as the JAX eval's
    PRNGKey(0) for every chunk."""
    dev = field.pose.device
    N = rays["rays_o"].shape[0]
    n_chunks = max(1, -(-N // max_chunk))
    chunk = -(-N // n_chunks)
    pad = chunk * n_chunks - N

    def pad_a(a):
        if pad == 0:
            return a
        return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])], 0)

    ro, rd = pad_a(rays["rays_o"]), pad_a(rays["rays_d"])
    rt, ri = pad_a(rays["rays_t"]), pad_a(rays["rays_id"])
    eval_cfg = dataclasses.replace(
        rcfg, compute_normals=False, normal_smooth_3d=False,
        normal_smoothness=False, code_reg=False)
    draws = draws or (lambda: Draws(dev, 0))

    image = torch.empty((chunk * n_chunks, 3), device=dev)
    depth = torch.empty((chunk * n_chunks,), device=dev)
    opac = torch.empty((chunk * n_chunks,), device=dev)
    with torch.no_grad():
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            out = renderer.render_rays(
                field, occ, draws(), ro[sl], rd[sl], rt[sl], ri[sl], eval_cfg,
                bg_color=bg_color, cano=cano, optimize_pose=optimize_pose,
                train=False, real_view=False)
            image[sl] = out["image"]
            depth[sl] = out["depth"]
            opac[sl] = out["opacity"]
    return (image[:N].cpu().numpy(), depth[:N].cpu().numpy(),
            opac[:N].cpu().numpy())


def render_test_video(trainer, save_path: str, test_name: str = "test",
                      phis: float = 0.0, cano: bool = False,
                      real_view: bool = False, view_360: bool = False,
                      eval_clip: bool = False, clip_encoder=None, log=print):
    """Render the per-frame diagnostic videos {test_name}_ep{epoch}_rgb.mp4
    and _depth.mp4 (morpheus.py:1285-1375) with the EMA weights, like the
    reference: each frame's real camera (real_view, with the learned pose
    correction), the canonical field from an orbit (cano), an orbit of the
    deforming field (view_360), or a fixed azimuth phis (in turns). With
    eval_clip, each rendered frame is scored against the masked GT frame by
    clip_encoder's cosine similarity and the mean logged as `==> CLIP=`
    (morpheus.py:1339-1374). Returns (rgb frames, depth frames), uint8."""
    os.makedirs(save_path, exist_ok=True)
    name = f"{test_name}_ep{trainer.epoch:04d}"
    ds, cfg = trainer.dataset, trainer.config
    sampler = data_lib.VirtualViewSampler(ds, cfg, 1.0, trainer.device)
    clip_total = 0.0
    preds, preds_depth = [], []
    for i in range(ds.num_frames):
        if real_view:
            rays = data_lib.full_frame_rays(trainer.data, ds.num_frames, i)
            H, W = trainer.data["H"], trainer.data["W"]
        else:
            if cano:
                t, phi = 0, i / ds.num_frames
            elif view_360:
                t, phi = i, i / ds.num_frames
            else:
                t, phi = i, phis
            rays = sampler.sample(frame_idx=t,
                                  theta_deg=cfg["data"]["default_polar"],
                                  phi_deg=phi * 360.0)
            H, W = sampler.H, sampler.W
        img, dep, _ = eval_render(trainer.ema_field, trainer.occ,
                                  trainer.rcfg, rays, cano=cano,
                                  optimize_pose=real_view)
        img01 = np.clip(img.reshape(H, W, 3), 0, 1)
        preds.append((img01 * 255).astype(np.uint8))
        dep = dep.reshape(H, W)
        dep = (dep - dep.min()) / (dep.max() - dep.min() + 1e-6)
        preds_depth.append((dep * 255).astype(np.uint8))

        if eval_clip and clip_encoder is not None:
            # the GT frame on a white background, as the render's
            gt_mask = (np.asarray(ds.masks[i]) > 0.5).astype(np.float32)
            gt = np.asarray(ds.images[i]) * gt_mask[..., None] \
                + (1.0 - gt_mask[..., None])
            clip_total += clip_encoder.get_similarity_from_image(
                img01[None], gt[None].astype(np.float32))

    if eval_clip and clip_encoder is not None:
        log(f"==> CLIP={clip_total / ds.num_frames:.4f} ({name})")

    write_frames_video(os.path.join(save_path, f"{name}_rgb.mp4"),
                       np.stack(preds))
    write_frames_video(os.path.join(save_path, f"{name}_depth.mp4"),
                       np.stack([np.repeat(d[..., None], 3, -1)
                                 for d in preds_depth]))
    return preds, preds_depth


def write_frames_video(path: str, frames: np.ndarray, fps: int = FPS):
    """mp4 via OpenCV's bundled encoder (no ffmpeg binary needed); falls
    back to per-frame PNGs (the reference's write_video=False path,
    morpheus.py:1334-1336) when the encoder does not open."""
    import cv2

    T, H, W = frames.shape[:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    if vw.isOpened():
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return path
    base = path.rsplit(".", 1)[0]
    for i, f in enumerate(frames):
        cv2.imwrite(f"{base}_{i:04d}.png", cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    return base
