"""Deformable canonical SDF field with per-frame pose correction
(port of morpheus_tpu/model/field.py).

`Field` is an nn.Module whose parameter names follow the JAX package's
`init_field` tree (pose, deform_code, deform_net, topo_net, sdf_grid,
sdf_net, color_net, beta, color_grid, app_code, bg_net); convert.py maps one
to the other. Normals are the analytic gradient of the SDF, taken with
`torch.autograd.grad(..., create_graph=True)` over one closure, so that the
sdf value, the color features and any extra normal sites share one hash-grid
encode and its backward runs one histogram per stream; `normal_mode: fd`
takes central differences instead (JAX field.py:364-376).

The mixed-precision policy (FieldSpec.compute_dtype / mlp_dtype
'bfloat16', JAX field.py:75-85): compute_dtype casts the hash tables to
bf16 before the gather and implies mlp_dtype, which runs every MLP's
products in bf16 with f32 sums (ops/mlp.py). Parameters stay f32.
"""
from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from .cameras import euler_to_rotation
from . import codes, density, encodings, hashgrid
from .mlp import MLP
from .utils import safe_normalize

SHADING_ALBEDO, SHADING_LAMBERTIAN, SHADING_TEXTURELESS, SHADING_NORMAL = \
    0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static architecture (reference defaults, models/model.py:32-53)."""
    num_frames: int = 1
    bound: float = 1.01
    num_layers: int = 3
    num_layers_t: int = 6
    hidden_dim: int = 64
    hidden_dim_t: int = 128
    hidden_dim_tpo: int = 128
    num_layers_bg: int = 2
    hidden_dim_bg: int = 32
    geo_dim: int = 32
    deform_dim: int = 16
    amb_dim: int = 2
    use_t: bool = False
    use_app: bool = False
    use_joint: bool = True
    color_grid: bool = True
    encode_topo: bool = False
    encode_deform: bool = True
    bg_radius: float = 1.4
    multires_deform: int = 6
    multires_xyz: int = 6
    multires_bg: int = 6
    multires_bg_t: int = 6
    multires_t: int = 6
    grid: hashgrid.HashGridSpec = dataclasses.field(
        default_factory=lambda: hashgrid.HashGridSpec(
            input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
            log2_hashmap_size=15, desired_resolution=128))
    normal_mode: str = "analytic"   # 'analytic' | 'fd'
    fd_eps: float = 2e-3
    compute_dtype: str = "float32"  # 'bfloat16': bf16 tables and MLPs
    mlp_dtype: str = "float32"      # 'bfloat16': bf16 MLP products only
    # static hash-level truncation of the coarse-to-fine curriculum
    active_levels: int | None = None

    def __post_init__(self):
        if self.normal_mode not in ("analytic", "fd"):
            raise ValueError(f"normal_mode {self.normal_mode!r} not in "
                             "('analytic', 'fd')")
        for k in ("compute_dtype", "mlp_dtype"):
            if getattr(self, k) not in ("float32", "bfloat16"):
                raise ValueError(f"{k} {getattr(self, k)!r} not in "
                                 "('float32', 'bfloat16')")

    @property
    def cdt(self):
        """Hash-table gather type (None keeps f32)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    @property
    def mdt(self):
        """MLP product type (None keeps f32); compute_dtype implies it."""
        if "bfloat16" in (self.compute_dtype, self.mlp_dtype):
            return torch.bfloat16
        return None

    @property
    def in_dim_t(self) -> int:
        return encodings.freq_output_dim(1, self.multires_t) if self.use_t else 0

    @property
    def in_dim_deform(self) -> int:
        return (encodings.freq_output_dim(3, self.multires_deform)
                if self.encode_deform else 3)

    @property
    def code_sizes(self):
        n = self.num_frames
        return (max(n // 8, 1), max(n // 4, 1), n)

    @property
    def code_dim(self) -> int:
        return codes.multicode_dim(self.code_sizes, self.deform_dim)

    @property
    def in_dim_amb(self) -> int:
        return (encodings.freq_output_dim(self.amb_dim, 4)
                if self.encode_topo else self.amb_dim)

    @property
    def in_dim_xyz(self) -> int:
        return (encodings.freq_output_dim(3, self.multires_xyz)
                if self.use_joint else 3)

    @property
    def sdf_in_dim(self) -> int:
        return self.grid.output_dim + self.in_dim_amb + self.in_dim_xyz

    @property
    def color_enc_dim(self) -> int:
        return (self.grid.output_dim if self.color_grid
                else encodings.freq_output_dim(3, 6))

    @property
    def color_in_dim(self) -> int:
        return self.color_enc_dim + self.geo_dim + (self.deform_dim
                                                    if self.use_app else 0)

    @property
    def deform_in_dim(self) -> int:
        return self.in_dim_t + self.in_dim_deform + self.code_dim


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


class Field(nn.Module):
    def __init__(self, spec: FieldSpec, device="cuda"):
        super().__init__()
        self.spec = spec
        device = torch.device(device)
        s = spec
        self.pose = _param((s.num_frames, 6), device)
        self.deform_code = nn.ParameterList(
            [_param((n, s.deform_dim), device) for n in s.code_sizes])
        self.deform_net = MLP(s.deform_in_dim, 3, s.hidden_dim_t,
                              s.num_layers_t).to(device)
        self.topo_net = MLP(s.deform_in_dim, s.amb_dim, s.hidden_dim_tpo,
                            s.num_layers_t).to(device)
        self.sdf_grid = _param((s.grid.table_size, s.grid.level_dim), device)
        self.sdf_net = MLP(s.sdf_in_dim, 1 + s.geo_dim, s.hidden_dim,
                           s.num_layers).to(device)
        self.color_net = MLP(s.color_in_dim, 3, s.hidden_dim,
                             s.num_layers).to(device)
        self.beta = _param((), device)
        if s.color_grid:
            self.color_grid = _param((s.grid.table_size, s.grid.level_dim),
                                     device)
        if s.use_app:
            self.app_code = nn.ParameterList(
                [_param((n, s.deform_dim), device) for n in s.code_sizes])
        if s.bg_radius > 0:
            bg_in = (encodings.freq_output_dim(3, s.multires_bg)
                     + encodings.freq_output_dim(1, s.multires_bg_t))
            self.bg_net = MLP(bg_in, 3, s.hidden_dim_bg,
                              s.num_layers_bg).to(device)

    def reset_parameters(self, generator: torch.Generator):
        """Random init with the reference's distributions
        (models/model.py:96-193)."""
        s, dev = self.spec, self.pose.device
        with torch.no_grad():
            self.pose.zero_()
            for p in self.deform_code:
                p.copy_(torch.randn(p.shape, generator=generator, device=dev))
            self.deform_net.reset(generator)
            self.topo_net.reset(generator)
            self.sdf_grid.copy_(hashgrid.init_embeddings(generator, s.grid, dev))
            self.sdf_net.reset(generator, geo_init=True, geo_bias=0.4)
            self.color_net.reset(generator)
            self.beta.fill_(0.1)
            if s.color_grid:
                self.color_grid.copy_(hashgrid.init_embeddings(generator,
                                                               s.grid, dev))
            if s.use_app:
                for p in self.app_code:
                    p.copy_(torch.randn(p.shape, generator=generator,
                                        device=dev))
            if s.bg_radius > 0:
                self.bg_net.reset(generator)
        return self

    def with_spec(self, spec: FieldSpec) -> "Field":
        """A view of this field under another spec of the same shapes (level
        truncation, occupancy-query interpolation) sharing the parameters."""
        view = copy.copy(self)
        view.spec = spec
        return view

    # ---- pose correction (models/model.py:335-346) ----

    def pose_optimisation(self, rays_o, rays_d, frame_ids):
        data = self.pose.index_select(0, frame_ids.reshape(-1))
        R = euler_to_rotation(data[..., 0:3])
        rays_o = rays_o + data[..., 3:6]
        rays_d = (rays_d[..., None, :] * R).sum(-1)
        return rays_o, rays_d

    # ---- deformation / topology ----

    def deform_code_at(self, t):
        return codes.sample_multicode(list(self.deform_code), t)

    def _deform_inputs(self, x, t, max_level):
        s = self.spec
        x_enc = (encodings.freq_encode(x, s.multires_deform, max_level)
                 if s.encode_deform else x)
        feats = [x_enc]
        if s.use_t:
            feats.append(encodings.freq_encode(t, s.multires_t, max_level))
        feats.append(self.deform_code_at(t))
        return torch.cat(feats, dim=-1)

    def _topo(self, h, max_level):
        topo = self.topo_net(h, self.spec.mdt)
        if self.spec.encode_topo:
            topo = encodings.freq_encode(topo, 4, max_level)
        return topo

    def warp(self, x, t, max_level=None):
        """(deform, topo) of observation-space points at times t; topo is
        frequency-encoded under encode_topo (models/model.py:412-437)."""
        h = self._deform_inputs(x, t, max_level)
        return self.deform_net(h, self.spec.mdt), self._topo(h, max_level)

    def get_topo(self, x, t, max_level=None):
        """The ambient (topology) coordinates alone (models/model.py:
        252-271)."""
        return self._topo(self._deform_inputs(x, t, max_level), max_level)

    # ---- canonical field ----

    def grid_features(self, x, max_level=None, with_color: bool = True):
        """(enc_sdf, enc_color) of canonical points. With a color grid both
        tables share the corner indices, so they are gathered as one fused
        (T, 2C) table: one gather and one histogram per stream. Without
        color, only the sdf table is gathered."""
        s = self.spec
        if s.color_grid and with_color:
            emb = torch.cat([self.sdf_grid, self.color_grid], -1)
            gspec = dataclasses.replace(s.grid, level_dim=2 * s.grid.level_dim)
            out = hashgrid.encode(x, emb, gspec, bound=s.bound,
                                  max_level=max_level,
                                  active_levels=s.active_levels,
                                  compute_dtype=s.cdt)
            L, C = s.grid.num_levels, s.grid.level_dim
            o = out.reshape(x.shape[:-1] + (L, 2 * C))
            return (o[..., :C].reshape(x.shape[:-1] + (L * C,)),
                    o[..., C:].reshape(x.shape[:-1] + (L * C,)))
        enc = hashgrid.encode(x, self.sdf_grid, s.grid, bound=s.bound,
                              max_level=max_level,
                              active_levels=s.active_levels,
                              compute_dtype=s.cdt)
        return enc, None

    def sdf_head(self, x, enc, topo, max_level):
        s = self.spec
        if topo is None:
            topo = x.new_zeros(x.shape[:-1] + (s.in_dim_amb,))
        xin = (encodings.freq_encode(x, s.multires_xyz, max_level)
               if s.use_joint else x)
        h = self.sdf_net(torch.cat([xin, enc, topo], dim=-1), s.mdt)
        return h[..., 0], h[..., 1:]

    def sdf_geo(self, x, topo, max_level=None, with_color: bool = False):
        enc, _ = self.grid_features(x, max_level, with_color=with_color)
        return self.sdf_head(x, enc, topo, max_level)

    def _color(self, x, enc_col, geo_feat, max_level):
        s = self.spec
        if enc_col is None:
            enc_col = encodings.freq_encode(x, 6, max_level)
        feat = torch.cat([enc_col, geo_feat], dim=-1)
        if s.use_app:
            feat = torch.cat([feat, x.new_zeros(x.shape[:-1]
                                                + (s.deform_dim,))], -1)
        return torch.sigmoid(self.color_net(feat, s.mdt))

    def sigma_albedo(self, x, topo=None, return_color: bool = True,
                     max_level=None):
        """(sdf, sigma, albedo) of canonical points (one fused gather)."""
        enc_sdf, enc_col = self.grid_features(x, max_level,
                                              with_color=return_color)
        sdf, geo_feat = self.sdf_head(x, enc_sdf, topo, max_level)
        sigma = density.laplace_density(sdf, self.beta)
        rgb = (self._color(x, enc_col, geo_feat, max_level) if return_color
               else None)
        return sdf, sigma, rgb

    def query_density(self, x, t=None, cano: bool = False,
                      return_color: bool = True, max_level=None):
        """Density/SDF (and albedo) of observation-space points; a scalar t
        broadcasts to every point."""
        topo = None
        if not (cano or t is None):
            t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
            if t.dim() == 0 or t.numel() == 1:
                t = t.reshape(1, 1).expand(x.shape[0], 1)
            deform, topo = self.warp(x, t, max_level)
            x = x + deform
        sdf, sigma, rgb = self.sigma_albedo(x, topo, return_color, max_level)
        return {"sdf": sdf, "sigma": sigma, "albedo": rgb}

    # ---- normals ----

    def normal(self, x, t=None, cano: bool = False, topo=None,
               max_level=None):
        """(unit, raw) canonical-space normals; with t the points are warped
        first and topo is held fixed in the spatial gradient
        (models/model.py:387-398, 516-521). Under normal_mode 'fd' the raw
        normal is the central difference of the sdf over +-fd_eps along
        each axis, the shifted points clipped to the bound."""
        s = self.spec
        if t is not None and not cano:
            deform, topo = self.warp(x, t, max_level)
            x = x + deform
        if s.normal_mode == "fd":
            raw = []
            for d in range(3):
                off = x.new_zeros((1, 3))
                off[0, d] = s.fd_eps
                sp, _ = self.sdf_geo(torch.clamp(x + off, -s.bound, s.bound),
                                     topo, max_level)
                sn, _ = self.sdf_geo(torch.clamp(x - off, -s.bound, s.bound),
                                     topo, max_level)
                raw.append(0.5 * (sp - sn) / s.fd_eps)
            n_raw = torch.stack(raw, -1)
        else:
            with torch.enable_grad():
                if not x.requires_grad:
                    x = x.detach().requires_grad_(True)
                elif topo is not None and t is None:
                    # the caller's topo may be a function of x (get_topo at
                    # the same points): a copy of x that topo does not
                    # depend on holds topo fixed in the spatial gradient,
                    # as the JAX package's closure over topo does, and
                    # keeps the gradient's path back through x
                    x = x.clone()
                sdf, _ = self.sdf_geo(x, topo, max_level)
                n_raw = torch.autograd.grad(sdf.sum(), x,
                                            create_graph=True)[0]
        return torch.nan_to_num(safe_normalize(n_raw)), n_raw

    # ---- background (models/model.py:400-410) ----

    def background(self, d, t, max_level=None):
        s = self.spec
        h = encodings.freq_encode(d, s.multires_bg)
        h_t = encodings.freq_encode(t, s.multires_bg_t, max_level)
        return torch.sigmoid(self.bg_net(torch.cat([h, h_t], -1), s.mdt))

    # ---- full forward (models/model.py:483-533) ----

    def _analytic(self, x_cano, topo, max_level, extra_x):
        """(sdf, sigma, albedo, unit normal, raw normal, extra sites' unit
        normals or None) from one encode: the normals are the gradient of
        the sdf through the closure that also gives the color features."""
        s = self.spec
        B = x_cano.shape[0]
        E = 0 if extra_x is None else extra_x.shape[0]
        with torch.enable_grad():
            if E:
                x_all = torch.cat([x_cano, extra_x], 0)
                zeros = x_cano.new_zeros((E, s.in_dim_amb))
                topo_all = torch.cat(
                    [topo if topo is not None
                     else x_cano.new_zeros((B, s.in_dim_amb)), zeros], 0)
            else:
                x_all, topo_all = x_cano, topo
            if not x_all.requires_grad:
                x_all = x_all.detach().requires_grad_(True)
            enc_sdf, enc_col = self.grid_features(x_all, max_level)
            sdf, geo_feat = self.sdf_head(x_all, enc_sdf, topo_all, max_level)
            n_raw = torch.autograd.grad(sdf.sum(), x_all, create_graph=True)[0]
        n_extra = None
        if extra_x is not None:
            # (0, 3) for no sites: a rank may hold none of a selection
            n_extra = torch.nan_to_num(safe_normalize(n_raw[B:]))
            sdf, geo_feat, n_raw = sdf[:B], geo_feat[:B], n_raw[:B]
            if enc_col is not None:
                enc_col = enc_col[:B]
        sigma = density.laplace_density(sdf, self.beta)
        alb = self._color(x_cano, enc_col, geo_feat, max_level)
        n = torch.nan_to_num(safe_normalize(n_raw))
        return sdf, sigma, alb, n, n_raw, n_extra

    def forward(self, x, t, light_d=None, ratio=1.0,
                shading_id: int = SHADING_ALBEDO, cano: bool = False,
                compute_normals: bool = True, max_level=None,
                extra_normal_x=None):
        """(sdf, sigma, color, normal, deform, normal_raw[, normal_extra]).
        shading_id is a host int, or a 0-d device tensor (and ratio then
        may be one too).

        extra_normal_x (E, 3): further canonical sites (topo zero) whose
        normals ride the same encode and gradient closure as the samples;
        their unit normals come back as a seventh output. Only the
        analytic normals take them."""
        s = self.spec
        if cano:
            x_cano, deform, topo = x, None, None
        else:
            deform, topo = self.warp(x, t)
            x_cano = x + deform

        if not compute_normals:
            sdf, sigma, alb = self.sigma_albedo(x_cano, topo,
                                                max_level=max_level)
            if extra_normal_x is not None:
                return sdf, sigma, alb, None, deform, None, None
            return sdf, sigma, alb, None, deform, None
        if s.normal_mode == "fd":
            if extra_normal_x is not None:
                raise ValueError("extra_normal_x rides the analytic normals' "
                                 "closure; normal_mode 'fd' has none")
            sdf, sigma, alb = self.sigma_albedo(x_cano, topo,
                                                max_level=max_level)
            n, n_raw = self.normal(x_cano, topo=topo, cano=True,
                                   max_level=max_level)
            n_extra = None
        else:
            sdf, sigma, alb, n, n_raw, n_extra = self._analytic(
                x_cano, topo, max_level, extra_normal_x)

        if isinstance(shading_id, torch.Tensor):
            # drawn on the device (the virtual step): every shading, then
            # a select, as the JAX forward does for a traced shading_id
            lambertian = ratio + (1.0 - ratio) * torch.clamp(
                (n * light_d).sum(-1), min=0.0)
            color = torch.where(
                shading_id == SHADING_ALBEDO, alb, torch.where(
                    shading_id == SHADING_TEXTURELESS,
                    lambertian[..., None].expand(alb.shape), torch.where(
                        shading_id == SHADING_NORMAL, (n + 1.0) / 2.0,
                        alb * lambertian[..., None])))
        elif shading_id == SHADING_ALBEDO:
            color = alb
        else:
            lambertian = ratio + (1.0 - ratio) * torch.clamp(
                (n * light_d).sum(-1), min=0.0)
            if shading_id == SHADING_TEXTURELESS:
                color = lambertian[..., None].expand(alb.shape)
            elif shading_id == SHADING_NORMAL:
                color = (n + 1.0) / 2.0
            else:
                color = alb * lambertian[..., None]
        if extra_normal_x is not None:
            return sdf, sigma, color, n, deform, n_raw, n_extra
        return sdf, sigma, color, n, deform, n_raw
