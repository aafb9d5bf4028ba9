"""Volume renderer with its inline regularizers: the real- and virtual-view
training paths and the eval renders (port of morpheus_tpu/renderer.py:
render_rays with its cano/real_view flags and background, the merged and
separate perturbed-normal smoothness, the reference's dormant smoothness
terms, _ortho_normal_dir, and both surface-band smoothness forms: the
exact two-ladder _surface_band_normal_smoothness and the
_band_reuse_normal_smoothness redesign).

N rays are marched against the occupancy grid, compacted to a flat stream of
B = sample_budget*N samples (all N*K without a budget), evaluated by one
field closure (samples plus, when they are known before it, the
perturbed-smoothness sites) and composited per ray. Loss components come
back in the output dict; the trainer weights and sums them.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import trace
from .model.field import SHADING_ALBEDO, Field
from .ops import occupancy, volrender
from .parallel.sharding import LOCAL, Reducer
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
    # reuse the render samples' normals as the band's first normal (True),
    # or the reference's exact ladder of P = trunc*100+1 points a ray
    # around the rendered depth, two normal evaluations (False)
    band_reuse: bool = True
    # the reference's dormant options (morpheus.py:716-760)
    normal_dir: bool = False          # perturb along ortho-normal dirs
    normal_smooth_3d_t: bool = False  # normals under time-perturbed topo
    deform_smooth: bool = False       # deform at the perturbed points
    deform_smooth_t: bool = False     # deform at perturbed times
    topo_smooth_t: bool = False       # topo at perturbed times

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


def _subset_sel(draws, name: str, mask: torch.Tensor, budget: int, rows):
    """A uniform random subset of `budget` of the entries where mask is set
    (random score, top-k), taken over the global index space of `rows`
    (sharding.Rows: mask holds this rank's entries): (this rank's members,
    their Rows in the subset, mask at them), or (None, rows, mask) when
    the budget keeps everything. Under a process group the members have a
    fixed size (Rows.select): padding repeats a real entry and its mask is
    false, so that each consumer's masked terms take nothing from it."""
    B = rows.total
    if not budget or budget >= B:
        return None, rows, mask
    score = torch.where(rows.gather(mask), draws.uniform(name, (B,)), -1.0)
    sel, sel_rows = rows.select(occupancy.top_k_indices(score, budget))
    m, member = _take(mask, sel), sel_rows.members()
    return sel, sel_rows, m if member is None else m & member


def render_rays(field: Field, occ_state, draws, rays_o, rays_d, rays_t,
                rays_id, rcfg: RenderConfig, *, bg_color=None,
                ambient_ratio=1.0, shading_id: int = SHADING_ALBEDO,
                real_view: bool = True, cano: bool = False, rays_depth=None,
                rays_mask=None, optimize_pose: bool = False, max_level=None,
                train: bool = True, red: Reducer = LOCAL) -> dict:
    """Render N rays; all array arguments are (N, ...). cano renders the
    canonical field (no deformation, no pose correction, no code
    smoothness); bg_color None is the background net for a canonical
    virtual view when the model has one (bg_radius > 0), white otherwise.
    Under a process group (red) the N rays are this rank's rows of a global
    batch of N*world: the draws, the budgets and the selections are the
    global batch's, and each loss term is this rank's share of it
    (parallel/sharding.py)."""
    N = rays_o.shape[0]
    K = rcfg.max_samples
    rays = red.rows(N)
    n_rays = rays.total

    if not cano and optimize_pose:
        rays_o, rays_d = field.pose_optimisation(rays_o, rays_d, rays_id)

    t_starts, t_ends, mask, score = occupancy.march_rays(
        rays.draws(draws), occ_state, rays_o, rays_d, rcfg.bound,
        rcfg.step_size, rcfg.march_steps, rcfg.max_samples,
        score_uniform_mix=rcfg.budget_uniform_mix,
        occ_threshold=rcfg.occ_threshold)

    budget = rcfg.sample_budget * n_rays
    if budget and budget < n_rays * K:
        cs = occupancy.compact_samples(t_starts, t_ends, mask, score, budget,
                                       rays)
    else:
        ray_id = torch.arange(N, device=rays_o.device).repeat_interleave(K)
        cs = {"ray_id": ray_id, "t_starts": t_starts.reshape(-1),
              "t_ends": t_ends.reshape(-1), "valid": mask.reshape(-1),
              "starts": torch.arange(N + 1, device=rays_o.device) * K,
              "rows": rays.scaled(K)}
    ray_id, valid = cs["ray_id"], cs["valid"]
    stream = cs["rows"]           # the samples' places in the global stream
    seg = volrender.Segments(ray_id, cs["starts"], K, padded=stream.padded)

    light_d = safe_normalize(rays_o + draws.normal("light", (3,)))
    t_mid = 0.5 * (cs["t_starts"] + cs["t_ends"])
    x_flat = _take(rays_o, ray_id) + _take(rays_d, ray_id) * t_mid[:, None]
    t_flat = _take(rays_t, ray_id)
    light_flat = _take(light_d, ray_id)
    dirs_unit = safe_normalize(rays_d)

    # the isotropic perturbed-smoothness sites with zero topo are known
    # before the field evaluation, so they ride the samples' encode and
    # gradient closure; normal_dir needs the normals first, topo'd sites
    # their own topo, and fd normals have no closure to share
    merge_smooth = (rcfg.merge_smooth and train and rcfg.compute_normals
                    and rcfg.normal_smooth_3d and not rcfg.normal_dir
                    and rcfg.topo_none
                    and field.spec.normal_mode == "analytic")
    s_sel = xp = n_p = None
    if merge_smooth:
        s_sel, s_rows, v_s = _subset_sel(draws, "smooth_sel", valid,
                                         rcfg.smooth_budget * n_rays, stream)
        x_s = _take(x_flat, s_sel)
        xp = x_s + s_rows.draws(draws).normal("perturb", tuple(x_s.shape)) \
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

    def masked_mean(x):
        m = valid[:, None].expand(x.shape)
        return torch.where(m, x, 0.0).sum() / (red.total(m.sum()) + 1e-8)

    if rcfg.compute_normals and normals is not None:
        out["loss_orient"] = losses.orientation_loss_flat(
            weights.detach(), normals, _take(dirs_unit, ray_id), valid,
            n_rays)
        if rcfg.normal_smooth_3d:
            # canonical-space normals at perturbed sites (morpheus.py:
            # 714-741), on a uniform subset of the valid samples under
            # smooth_budget (an unbiased estimate of the same mean)
            if not merge_smooth:
                s_sel, s_rows, v_s = _subset_sel(
                    draws, "smooth_sel", valid, rcfg.smooth_budget * n_rays,
                    stream)
            s_draws = s_rows.draws(draws)
            x_s, t_s, n_s = (_take(a, s_sel) for a in (x_flat, t_flat,
                                                        normals))
            d_s = None if deform is None else _take(deform, s_sel)
            if not merge_smooth:
                if rcfg.normal_dir:
                    xp = x_s + _ortho_normal_dir(s_draws.uniform(
                        "perturb_phase", (x_s.shape[0], 1)), n_s) \
                        * rcfg.smoothness_std
                else:
                    xp = x_s + s_draws.normal("perturb", tuple(x_s.shape)) \
                        * rcfg.smoothness_std
                topo_p = (None if rcfg.topo_none
                          else field.get_topo(xp, t_s, max_level))
                n_p, _ = field.normal(xp, topo=topo_p, cano=True,
                                      max_level=max_level)
            out["loss_normal_perturb"] = losses.normal_perturb_loss(
                n_s, n_p, v_s, red)
            if rcfg.normal_smooth_3d_t:
                # normals under the topo of a perturbed time
                # (morpheus.py:743-748)
                t_jit = t_s + s_draws.uniform("t_perturb_3d", tuple(
                    t_s.shape)) / rcfg.num_frames
                n_t, _ = field.normal(x_s, topo=field.get_topo(
                    x_s, t_jit, max_level), cano=True, max_level=max_level)
                out["loss_normal_perturb_t"] = losses.normal_perturb_loss(
                    n_s, n_t, v_s, red)
            if rcfg.deform_smooth and not cano and d_s is not None:
                # the deformation at the perturbed points (morpheus.py:
                # 750-754)
                deform_p, _ = field.warp(xp, t_s, max_level)
                m_s = v_s[:, None].expand(d_s.shape)
                out["loss_deform_perturb"] = (
                    torch.where(m_s, torch.abs(d_s - deform_p), 0.0).sum()
                    / (red.total(m_s.sum()) + 1e-8))
        if normal_raw is not None:
            out["normal_raw_eik"] = losses.eikonal_loss(normal_raw, valid,
                                                        red)
        if rcfg.normal_smooth_2d and not real_view:
            # the rendered normal image of the 2-D smoothness
            # (morpheus.py:773-776)
            out["normal_image"] = volrender.flat_accumulate(
                weights, (normals + 1.0) / 2.0, seg)

    if (rcfg.deform_smooth_t or rcfg.topo_smooth_t) and not cano \
            and deform is not None:
        # deformation and topo under a perturbed time (morpheus.py:756-760)
        t_jit = t_flat + stream.draws(draws).uniform("t_perturb", tuple(
            t_flat.shape)) / rcfg.num_frames
        _, topo0 = field.warp(x_flat, t_flat, max_level)
        deform_t, topo_t = field.warp(x_flat, t_jit, max_level)
        if rcfg.deform_smooth_t:
            out["loss_deform_perturb_t"] = masked_mean(
                torch.abs(deform - deform_t))
        if rcfg.topo_smooth_t:
            out["loss_topo_perturb_t"] = masked_mean(torch.abs(topo0 - topo_t))

    if rcfg.code_reg and not cano:
        t0 = rays_t[:1]
        dt = 1.0 / rcfg.num_frames
        out["loss_code"] = losses.code_smoothness(
            field.deform_code_at(t0), field.deform_code_at(t0 - dt),
            field.deform_code_at(t0 + dt))

    if rcfg.normal_smoothness:
        # band_mask: the term's fixed candidate slots that lie in the band
        with trace.span("render.band"):
            if rcfg.band_reuse and rcfg.band_budget and normals is not None:
                out["normal_reg"], out["band_mask"] = \
                    _band_reuse_normal_smoothness(
                        field, draws, x_flat, t_flat, normals, valid, t_mid,
                        depth, ray_id, rcfg, max_level, stream, n_rays)
            else:
                out["normal_reg"], out["band_mask"] = \
                    _surface_band_normal_smoothness(
                        field, draws, rays_o, rays_d, rays_t, depth, rcfg,
                        max_level, rays)

    if rays_depth is not None:
        fs_loss, sdf_loss = losses.sdf_losses_flat(
            t_mid, rays_depth.reshape(-1), sdf, rcfg.trunc, valid, seg,
            ray_mask=rays_mask.reshape(-1) if rays_mask is not None else None,
            red=red)
        out["fs_loss"] = fs_loss
        out["sdf_loss"] = sdf_loss

    if deform is not None:
        out["deform_abs"] = masked_mean(torch.abs(deform))
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
                                  rcfg: RenderConfig, max_level, stream,
                                  n_rays: int):
    """Surface-band normal smoothness: the first normal is reused from the
    render samples within trunc/2 of the rendered depth (inside the
    outside_radius filter, budgeted to band_budget*N sites of the n_rays
    of the global batch; `stream`: the samples' Rows); only the
    ortho-perturbed second normal is evaluated (an sdf-only encode).
    Returns (the term, the mask of the samples in the band)."""
    depth_r = depth.detach()[ray_id]
    in_band = (valid & (torch.abs(t_mid - depth_r) < 0.5 * rcfg.trunc)
               & (torch.linalg.norm(x_flat, dim=-1) < rcfg.outside_radius))
    sel, b_rows, m_b = _subset_sel(draws, "band_sel", in_band,
                                   rcfg.band_budget * n_rays, stream)
    x_b, t_b, n1 = (_take(a, sel) for a in (x_flat, t_flat, normals))
    w = _ortho_normal_dir(b_rows.draws(draws).uniform(
        "band_phase", (n1.shape[0], 1)), n1)
    n2, _ = field.normal(x_b + w * rcfg.smoothness_std, t=t_b,
                         max_level=max_level)
    sq = ((n1 - n2) ** 2).sum(-1) / 3.0
    return (torch.where(m_b, sq, 0.0).sum()
            / (stream.red.total(m_b.sum()) + 1e-8)), in_band


@functools.lru_cache(maxsize=8)
def _ladder(trunc: float, P: int, device) -> torch.Tensor:
    """P rungs evenly over [-trunc/2, trunc/2], made once per device (a
    host-to-card copy waits for the card)."""
    return torch.as_tensor(np.linspace(-0.5 * trunc, 0.5 * trunc, P)
                           .astype(np.float32), device=device)


def _surface_band_normal_smoothness(field: Field, draws, rays_o, rays_d,
                                    rays_t, depth, rcfg: RenderConfig,
                                    max_level, rays):
    """The reference's surface-band normal smoothness (morpheus.py:530-556,
    JAX renderer.py:417-457): a ladder of P = trunc*100+1 points a ray,
    spaced over [-trunc/2, trunc/2] around the detached rendered depth and
    jittered by one draw of 0.01*U[0, 1) per rung; n1 is the normal of each
    point, n2 that of the point moved smoothness_std along a random
    direction orthogonal to n1. Points with |x| >= outside_radius are
    masked out (the reference drops them); under band_budget a random
    band_budget*N of the in-band points are evaluated (top-k of a random
    score, exact where the JAX package's approx_max_k is exact on the
    CPU), N the global batch's rays (`rays`: this rank's Rows of them).
    Returns (the term, the mask of the ladder's P*N points inside the
    radius)."""
    P = int(rcfg.trunc * 100 + 1)
    ladder = _ladder(rcfg.trunc, P, depth.device) \
        + 0.01 * draws.uniform("ladder_jitter", (P,))
    pts = ((depth.detach()[None, :] + ladder[:, None])[..., None]
           * rays_d[None] + rays_o[None]).reshape(-1, 3)         # (P*N, 3)
    ts = rays_t[None].expand((P,) + tuple(rays_t.shape)).reshape(-1, 1)
    band = torch.linalg.norm(pts, dim=-1) < rcfg.outside_radius
    sel, l_rows, in_band = _subset_sel(draws, "ladder_sel", band,
                                       rcfg.band_budget * rays.total,
                                       rays.repeated(P, depth.device))
    pts, ts = (_take(a, sel) for a in (pts, ts))
    n1, _ = field.normal(pts, t=ts, max_level=max_level)
    w = _ortho_normal_dir(l_rows.draws(draws).uniform(
        "ladder_phase", (n1.shape[0], 1)), n1)
    n2, _ = field.normal(pts + w * rcfg.smoothness_std, t=ts,
                         max_level=max_level)
    sq = ((n1 - n2) ** 2).sum(-1) / 3.0
    return (torch.where(in_band, sq, 0.0).sum()
            / (rays.red.total(in_band.sum()) + 1e-8)), band
