"""Loss terms of the training steps (port of morpheus_tpu/train/losses.py:
the flat-stream losses the renderer uses, and the dense (N, K) sdf_losses
and orientation_loss).

Under a process group (`red`, parallel.sharding.Reducer) a term's inputs
are this rank's share of the global batch, and it returns its share of the
global term: the local numerator over the global denominator."""
from __future__ import annotations

import torch

from . import volrender
from .local import LOCAL, Reducer


def _masked_mean(x, mask, eps=1e-8, red: Reducer = LOCAL):
    return torch.where(mask, x, 0.0).sum() / (red.total(mask.sum()) + eps)


def sdf_losses_flat(t_mid, target_d, predicted_sdf, truncation, valid,
                    seg: volrender.Segments, ray_mask=None,
                    red: Reducer = LOCAL):
    """TSDF free-space and truncation-band SDF losses on a flat ray-sorted
    stream (reference utils.py:91-113). t_mid/predicted_sdf/valid: (B,);
    target_d, ray_mask: (N,). Returns (fs_loss, sdf_loss)."""
    td = target_d[seg.ray_id]
    depth_mask = td > 0.0
    front_mask = t_mid < (td - truncation)
    front_mask = front_mask | ((td < 0.0) & (t_mid < 3.5))
    bound = torch.where(depth_mask, td - t_mid, 10.0)
    sdf_mask = (torch.abs(bound) <= truncation) & depth_mask
    if ray_mask is not None:
        sdf_mask = sdf_mask & (ray_mask[seg.ray_id] > 0.5)
    front_mask = front_mask & valid
    sdf_mask = sdf_mask & valid

    def per_ray_sum(x):
        return volrender.flat_segment_sum(x, seg)

    sum_of_samples = (per_ray_sum(front_mask.float())
                      + per_ray_sum(sdf_mask.float()) + 1e-8)
    rays_w_depth = red.total(torch.count_nonzero(target_d)) + 1e-8

    fs = torch.clamp(torch.maximum(torch.exp(-5.0 * predicted_sdf) - 1.0,
                                   predicted_sdf - bound), min=0.0)
    fs_loss = (per_ray_sum(torch.where(front_mask, fs, 0.0))
               / sum_of_samples).sum() / rays_w_depth
    sdf_l = torch.abs(predicted_sdf - bound)
    sdf_loss = (per_ray_sum(torch.where(sdf_mask, sdf_l, 0.0))
                / sum_of_samples).sum() / rays_w_depth
    return fs_loss, sdf_loss


def sdf_losses(t_mid, target_d, predicted_sdf, truncation, sample_mask,
               ray_mask=None):
    """sdf_losses_flat on a dense (N, K) grid of samples (reference
    utils.py:91-113). t_mid, predicted_sdf, sample_mask: (N, K); target_d,
    ray_mask: (N, 1). Returns (fs_loss, sdf_loss)."""
    depth_mask = target_d > 0.0
    front_mask = t_mid < (target_d - truncation)
    front_mask = front_mask | ((target_d < 0.0) & (t_mid < 3.5))
    bound = torch.where(depth_mask, target_d - t_mid, 10.0)
    sdf_mask = (torch.abs(bound) <= truncation) & depth_mask
    if ray_mask is not None:
        sdf_mask = sdf_mask & (ray_mask > 0.5)
    front_mask = front_mask & sample_mask
    sdf_mask = sdf_mask & sample_mask
    sum_of_samples = front_mask.sum(-1) + sdf_mask.sum(-1) + 1e-8
    rays_w_depth = torch.count_nonzero(target_d) + 1e-8
    fs = torch.clamp(torch.maximum(torch.exp(-5.0 * predicted_sdf) - 1.0,
                                   predicted_sdf - bound), min=0.0)
    fs_loss = (torch.where(front_mask, fs, 0.0).sum(-1)
               / sum_of_samples).sum() / rays_w_depth
    sdf_l = torch.abs(predicted_sdf - bound)
    sdf_loss = (torch.where(sdf_mask, sdf_l, 0.0).sum(-1)
                / sum_of_samples).sum() / rays_w_depth
    return fs_loss, sdf_loss


def orientation_loss(weights, normals, dirs, mask):
    """Normals facing away from the camera on a dense (N, K) grid
    (morpheus.py:709-712): the mean over rays of each ray's sum; the
    caller detaches the weights."""
    n_dot_d = (normals * dirs).sum(-1)
    term = torch.clamp(n_dot_d, min=0.0) ** 2 * torch.where(mask, weights,
                                                            0.0)
    return term.sum(-1).mean()


def orientation_loss_flat(weights, normals, dirs, valid, num_rays):
    """Normals facing the camera, weighted by (detached) render weights:
    the sum of all per-sample terms over the number of rays."""
    n_dot_d = (normals * dirs).sum(-1)
    term = torch.clamp(n_dot_d, min=0.0) ** 2 * torch.where(valid, weights, 0.0)
    return term.sum() / num_rays


def rgb_loss(pred_rgb, gt_rgb, red: Reducer = LOCAL):
    return red.mean((pred_rgb - gt_rgb) ** 2)


def mask_loss(pred_opacity, gt_mask, red: Reducer = LOCAL):
    """BCE on accumulated opacity (morpheus.py:958-960)."""
    p = torch.clamp(pred_opacity, 1e-5, 1.0 - 1e-5)
    return -red.mean(gt_mask * torch.log(p)
                     + (1.0 - gt_mask) * torch.log(1.0 - p))


def depth_loss(pred_depth, gt_depth, rays_o, rays_d, gt_mask,
               outside_radius: float = 1.1, red: Reducer = LOCAL):
    """Masked depth MSE with outlier rejection (morpheus.py:963-981)."""
    xyzs = rays_o + gt_depth[..., None] * rays_d
    pts_norm = torch.linalg.norm(xyzs, dim=-1)
    valid = (gt_depth > 0) & (pts_norm <= outside_radius) & (gt_mask > 0.5)
    return red.mean((torch.where(valid, pred_depth, 0.0)
                     - torch.where(valid, gt_depth, 0.0)) ** 2)


def entropy_loss(weights, mask, red: Reducer = LOCAL):
    a = torch.clamp(weights, 1e-5, 1 - 1e-5)
    ent = -a * torch.log2(a) - (1 - a) * torch.log2(1 - a)
    return _masked_mean(ent, mask, red=red)


def eikonal_loss(normal_raw, mask=None, red: Reducer = LOCAL):
    err = (torch.linalg.norm(normal_raw, dim=-1) - 1.0) ** 2
    if mask is None:
        return red.mean(err)
    return _masked_mean(err, mask, red=red)


def normal_perturb_loss(normals, normals_perturb, mask=None,
                        red: Reducer = LOCAL):
    d = torch.abs(normals - normals_perturb)
    if mask is None:
        return red.mean(d)
    return _masked_mean(d, mask[..., None].expand(d.shape), red=red)


def code_smoothness(code, code_prev, code_next):
    """Second-difference temporal code regularizer (morpheus.py:762-771)."""
    return ((2.0 * code - code_prev - code_next) ** 2).mean()
