"""Volume renderer with its inline regularizers: the real- and virtual-view
training paths and the eval renders (port of morpheus_tpu/renderer.py: render_rays
with merge_smooth and band_reuse, its cano/real_view flags and background,
_ortho_normal_dir, _band_reuse_normal_smoothness).

N rays are marched against the occupancy grid, compacted to a flat stream of
B = sample_budget*N samples, evaluated by one field closure (samples plus the
perturbed-smoothness sites) and composited per ray. Loss components come
back in the output dict; the trainer weights and sums them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .model.field import SHADING_ALBEDO, Field
from .ops import occupancy, volrender
from .train import losses
from .utils import safe_normalize


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    bound: float = 1.01
    step_size: float = 0.01
    march_steps: int = 256
    max_samples: int = 64
    trunc: float = 0.1
    smoothness_std: float = 0.005
    topo_none: bool = True
    num_frames: int = 1
    bg_radius: float = 1.4
    sample_budget: int = 0        # average field samples per ray (0 = N*K)
    budget_uniform_mix: float = 0.0
    occ_threshold: float = 0.01
    compute_normals: bool = True
    normal_smooth_3d: bool = True
    normal_smoothness: bool = True
    normal_smooth_2d: bool = False
    code_reg: bool = True
    outside_radius: float = 1.1
    smooth_budget: int = 0        # perturbed-normal sites per ray (0 = all)
    merge_smooth: bool = True
    band_budget: int = 0          # surface-band sites per ray (0 = all)
    band_reuse: bool = True
    normal_dir: bool = False
    normal_smooth_3d_t: bool = False
    deform_smooth: bool = False
    deform_smooth_t: bool = False
    topo_smooth_t: bool = False

    def __post_init__(self):
        for k in ("normal_dir", "normal_smooth_3d_t", "deform_smooth",
                  "deform_smooth_t", "topo_smooth_t"):
            if getattr(self, k):
                raise NotImplementedError(
                    f"{k}: dormant reference option, not ported (ROADMAP.md "
                    "queue A, item A14)")
        if not self.topo_none:
            raise NotImplementedError(
                "topo_none=False: not ported (ROADMAP.md queue A, item A14)")

    @staticmethod
    def from_config(config: dict, num_frames: int, bound: float
                    ) -> "RenderConfig":
        tr, tpu = config["train"], config["tpu"]
        return RenderConfig(
            bound=float(bound), step_size=config["render"]["step_size"],
            sample_budget=int(tpu.get("sample_budget", 0)),
            budget_uniform_mix=float(tpu.get("budget_uniform_mix", 0.0)),
            occ_threshold=float(tpu.get("occ_threshold", 0.01)),
            merge_smooth=bool(tpu.get("merge_smooth", True)),
            band_reuse=bool(tpu.get("band_reuse", True)),
            band_budget=int(tpu.get("band_budget", 0)),
            smooth_budget=int(tpu.get("smooth_budget", 0)),
            march_steps=tpu["march_steps"],
            max_samples=tpu["max_samples_per_ray"],
            trunc=tr["trunc"], smoothness_std=tr["smoothness_std"],
            topo_none=tr["topo_none"], num_frames=num_frames,
            bg_radius=config["model"]["bg_radius"],
            normal_smooth_3d=tr["normal_smooth_3d"] > 0,
            normal_smoothness=tr["normal_smoothness"] > 0,
            normal_smooth_2d=tr["normal_smooth_2d"] > 0,
            code_reg=tr["code_reg"] > 0,
            normal_dir=bool(tr["normal_dir"]),
            normal_smooth_3d_t=tr["normal_smooth_3d_t"] > 0,
            deform_smooth=tr["deform_smooth"] > 0,
            deform_smooth_t=tr["deform_smooth_t"] > 0,
            topo_smooth_t=tr["topo_smooth_t"] > 0,
        )


def _take(x: torch.Tensor, i: torch.Tensor | None) -> torch.Tensor:
    """Rows x[i] (all of x when i is None). index_select: its backward is an
    index_add, where advanced indexing's sorts the indices first."""
    return x if i is None else x.index_select(0, i)


def _subset_sel(draws, name: str, mask: torch.Tensor, budget: int):
    """A uniform random subset of `budget` of the entries where mask is set
    (random score, top-k); None when the budget keeps everything."""
    B = mask.shape[0]
    if not budget or budget >= B:
        return None
    score = torch.where(mask, draws.uniform(name, (B,)), -1.0)
    return occupancy.top_k_indices(score, budget)


def render_rays(field: Field, occ_state, draws, rays_o, rays_d, rays_t,
                rays_id, rcfg: RenderConfig, *, bg_color=None,
                ambient_ratio=1.0, shading_id: int = SHADING_ALBEDO,
                real_view: bool = True, cano: bool = False, rays_depth=None,
                rays_mask=None, optimize_pose: bool = False, max_level=None,
                train: bool = True) -> dict:
    """Render N rays; all array arguments are (N, ...). cano renders the
    canonical field (no deformation, no pose correction, no code
    smoothness); bg_color None is the background net for a canonical
    virtual view when the model has one (bg_radius > 0), white otherwise."""
    N = rays_o.shape[0]
    K = rcfg.max_samples

    if not cano and optimize_pose:
        rays_o, rays_d = field.pose_optimisation(rays_o, rays_d, rays_id)

    t_starts, t_ends, mask, score = occupancy.march_rays(
        draws, occ_state, rays_o, rays_d, rcfg.bound, rcfg.step_size,
        rcfg.march_steps, rcfg.max_samples,
        score_uniform_mix=rcfg.budget_uniform_mix,
        occ_threshold=rcfg.occ_threshold)

    budget = rcfg.sample_budget * N
    if budget and budget < N * K:
        cs = occupancy.compact_samples(t_starts, t_ends, mask, score, budget)
    else:
        ray_id = torch.arange(N, device=rays_o.device).repeat_interleave(K)
        cs = {"ray_id": ray_id, "t_starts": t_starts.reshape(-1),
              "t_ends": t_ends.reshape(-1), "valid": mask.reshape(-1),
              "starts": torch.arange(N + 1, device=rays_o.device) * K}
    ray_id, valid = cs["ray_id"], cs["valid"]
    seg = volrender.Segments(ray_id, cs["starts"], K)

    light_d = safe_normalize(rays_o + draws.normal("light", (3,)))
    t_mid = 0.5 * (cs["t_starts"] + cs["t_ends"])
    x_flat = _take(rays_o, ray_id) + _take(rays_d, ray_id) * t_mid[:, None]
    t_flat = _take(rays_t, ray_id)
    light_flat = _take(light_d, ray_id)
    dirs_unit = safe_normalize(rays_d)

    # the perturbed-smoothness sites are known before the field evaluation,
    # so they ride the samples' encode and gradient closure
    merge_smooth = (rcfg.merge_smooth and train and rcfg.compute_normals
                    and rcfg.normal_smooth_3d)
    s_sel = xp = n_p = None
    if merge_smooth:
        s_sel = _subset_sel(draws, "smooth_sel", valid,
                            rcfg.smooth_budget * N)
        x_s = _take(x_flat, s_sel)
        xp = x_s + draws.normal("perturb", tuple(x_s.shape)) \
            * rcfg.smoothness_std
        sdf, sigmas, rgbs, normals, deform, normal_raw, n_p = field(
            x_flat, t_flat, light_d=light_flat, ratio=ambient_ratio,
            shading_id=shading_id, cano=cano, compute_normals=True,
            max_level=max_level, extra_normal_x=xp)
    else:
        sdf, sigmas, rgbs, normals, deform, normal_raw = field(
            x_flat, t_flat, light_d=light_flat, ratio=ambient_ratio,
            shading_id=shading_id, cano=cano,
            compute_normals=rcfg.compute_normals, max_level=max_level)

    weights, _, _ = volrender.flat_render_weights(
        cs["t_starts"], cs["t_ends"], sigmas, valid, seg)
    opacity = volrender.flat_accumulate(weights, None, seg)         # (N, 1)
    depth = volrender.flat_accumulate(weights, t_mid[:, None], seg)[..., 0]
    rgb = volrender.flat_accumulate(weights, rgbs, seg)             # (N, 3)
    if bg_color is None:
        if rcfg.bg_radius > 0 and cano and not real_view:
            bg_color = field.background(rays_d, rays_t)
        else:
            bg_color = 1.0
    image = rgb + (1.0 - opacity) * bg_color

    out = {"image": image, "depth": depth, "opacity": opacity[..., 0],
           "weights": weights, "mask": valid, "sdf": sdf, "t_mid": t_mid,
           "ray_id": ray_id}
    if not train:
        return out

    if rcfg.compute_normals and normals is not None:
        out["loss_orient"] = losses.orientation_loss_flat(
            weights.detach(), normals, _take(dirs_unit, ray_id), valid, N)
        if rcfg.normal_smooth_3d:
            if not merge_smooth:
                s_sel = _subset_sel(draws, "smooth_sel", valid,
                                    rcfg.smooth_budget * N)
                x_s = _take(x_flat, s_sel)
                xp = x_s + draws.normal("perturb", tuple(x_s.shape)) \
                    * rcfg.smoothness_std
                n_p, _ = field.normal(xp, topo=None, cano=True,
                                      max_level=max_level)
            n_s, v_s = _take(normals, s_sel), _take(valid, s_sel)
            out["loss_normal_perturb"] = losses.normal_perturb_loss(n_s, n_p,
                                                                    v_s)
        if normal_raw is not None:
            out["normal_raw_eik"] = losses.eikonal_loss(normal_raw, valid)
        if rcfg.normal_smooth_2d and not real_view:
            # the rendered normal image of the 2-D smoothness
            # (morpheus.py:773-776)
            out["normal_image"] = volrender.flat_accumulate(
                weights, (normals + 1.0) / 2.0, seg)

    if rcfg.code_reg and not cano:
        t0 = rays_t[:1]
        dt = 1.0 / rcfg.num_frames
        out["loss_code"] = losses.code_smoothness(
            field.deform_code_at(t0), field.deform_code_at(t0 - dt),
            field.deform_code_at(t0 + dt))

    if rcfg.normal_smoothness and normals is not None:
        if not (rcfg.band_reuse and rcfg.band_budget):
            raise NotImplementedError(
                "the surface-band ladder (band_reuse off or band_budget 0) "
                "is not ported (ROADMAP.md queue A, item A14)")
        out["normal_reg"] = _band_reuse_normal_smoothness(
            field, draws, x_flat, t_flat, normals, valid, t_mid, depth,
            ray_id, rcfg, max_level)

    if rays_depth is not None:
        fs_loss, sdf_loss = losses.sdf_losses_flat(
            t_mid, rays_depth.reshape(-1), sdf, rcfg.trunc, valid, seg,
            ray_mask=rays_mask.reshape(-1) if rays_mask is not None else None)
        out["fs_loss"] = fs_loss
        out["sdf_loss"] = sdf_loss

    if deform is not None:
        m = valid[:, None].expand(deform.shape)
        out["deform_abs"] = (torch.where(m, torch.abs(deform), 0.0).sum()
                             / (m.sum() + 1e-8))
    return out


def _ortho_normal_dir(phase: torch.Tensor, normals: torch.Tensor):
    """Direction orthogonal to the normals at angle 2*pi*phase
    (morpheus.py:518-528); phase (..., 1) uniform in [0, 1)."""
    n = safe_normalize(normals)
    # (n_y, -n_x, 0): the reference's n[..., [1, 0, 2]] * [1, -1, 0], with
    # no index or constant tensor to copy to the card
    u = safe_normalize(torch.stack([n[..., 1], -n[..., 0], n[..., 2] * 0.0],
                                   -1))
    v = torch.linalg.cross(n, u, dim=-1)
    phi = phase * 2.0 * math.pi
    return torch.cos(phi) * u + torch.sin(phi) * v


def _band_reuse_normal_smoothness(field: Field, draws, x_flat, t_flat,
                                  normals, valid, t_mid, depth, ray_id,
                                  rcfg: RenderConfig, max_level):
    """Surface-band normal smoothness: the first normal is reused from the
    render samples within trunc/2 of the rendered depth (inside the
    outside_radius filter, budgeted to band_budget*N sites); only the
    ortho-perturbed second normal is evaluated (an sdf-only encode)."""
    depth_r = depth.detach()[ray_id]
    in_band = (valid & (torch.abs(t_mid - depth_r) < 0.5 * rcfg.trunc)
               & (torch.linalg.norm(x_flat, dim=-1) < rcfg.outside_radius))
    N = depth.shape[0]
    sel = _subset_sel(draws, "band_sel", in_band, rcfg.band_budget * N)
    x_b, t_b, n1, m_b = (_take(a, sel) for a in (x_flat, t_flat, normals,
                                                   in_band))
    w = _ortho_normal_dir(draws.uniform("band_phase", (n1.shape[0], 1)), n1)
    n2, _ = field.normal(x_b + w * rcfg.smoothness_std, t=t_b,
                         max_level=max_level)
    sq = ((n1 - n2) ** 2).sum(-1) / 3.0
    return torch.where(m_b, sq, 0.0).sum() / (m_b.sum() + 1e-8)
