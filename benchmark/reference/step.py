"""The plain reference of the epoch loop's steps: the port's real step (the
body that its CUDA graph replays) and its SDS virtual step, eager, in
float32 with TF32 off, on the kernels' plain twins (the port's
train/trainer.py, frozen: _refresh_occ, _real_update, _real_body,
virtual_step). It builds its own state from what the benchmark hands it
(the config, the scene, the field's parameters by name, the SDS prior's
guidance from its weights and the seed) and works out again what the port
derives in set-up: the occupancy grid and the prior's conditioning. The
SDS step's parts that belong to the prior (its conditioning, the views a
step renders and the loss on their render) are the prior's
(inputs.load_prior); the draws, the render, the regularisers and the
update every prior shares are here.

    ref = ReferenceTrainer(cfg, scene, field_state, seed, epoch, step,
                           device, guidance=g, prior=p)
    for _ in range(3):
        ref.step(kind)        # "real" or "virtual", in the epoch loop's order
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import occupancy, optim, renderer
from .dataset import (DeformDataset, VirtualViewSampler,
                      sample_real_view_rays)
from .density import laplace_beta
from .field import SHADING_ALBEDO, SHADING_LAMBERTIAN, SHADING_TEXTURELESS
from .field import Field, FieldSpec
from .hashgrid import HashGridSpec, active_count
from .losses import (depth_loss, entropy_loss, mask_loss, rgb_loss)
from .local import LOCAL
from .schedule import Curriculum
from .utils import Draws

OCC_CHUNK = 32768


def field_spec(config: dict, num_frames: int, bound: float) -> FieldSpec:
    """The field's spec of `config`, as the port's Trainer builds it."""
    m, tpu = config["model"], config["tpu"]
    grid = HashGridSpec(
        input_dim=3,
        num_levels=m.get("grid_num_levels", 16),
        level_dim=m.get("grid_level_dim", 2),
        base_resolution=m.get("grid_base_resolution", 16),
        log2_hashmap_size=m.get("grid_log2_hashmap_size", 15),
        desired_resolution=m.get("grid_desired_resolution", 128),
        grad_payload=tpu.get("grad_payload", "float32"),
        vjp_mode=tpu.get("vjp_mode", "hist_rows"))
    return FieldSpec(
        grid=grid, num_frames=num_frames, bound=bound,
        deform_dim=m["deform_dim"], amb_dim=m["amb_dim"],
        use_t=m["use_t"], use_app=m["use_app"], use_joint=m["use_joint"],
        color_grid=m["color_grid"], encode_topo=m["encode_topo"],
        bg_radius=m["bg_radius"],
        compute_dtype=tpu.get("compute_dtype", "float32"),
        mlp_dtype=tpu.get("mlp_dtype", "float32"))


class ReferenceTrainer:
    """One scene's optimisation state and its two kinds of step. guidance: the
    reference's guidance of the SDS prior `prior` (a prior's file, as
    inputs.load_prior gives it), or None."""

    def __init__(self, config: dict, scene: dict, field_state: dict,
                 seed: int, epoch: int, step: int, device, guidance=None,
                 prior=None):
        if config["train"]["optim"] != "adam":
            raise ValueError("the reference steps Adam only")
        self.config = config
        self.device = torch.device(device)
        self.dataset = DeformDataset(config, scene=scene)
        self.draws = Draws(self.device, seed)
        self.curr = Curriculum.from_config(config)
        self.bound = self.dataset.bound
        self.spec = field_spec(config, self.dataset.num_frames, self.bound)
        self.rcfg = renderer.RenderConfig.from_config(
            config, self.dataset.num_frames, self.bound)
        self.occ_interp = config["tpu"].get("occ_query_interp", "nearest")
        self.data = self.dataset.device_data(
            self.device, scale=config["data"]["known_view_scale"])
        self.field = Field(self.spec, self.device)
        self.field.load_state_dict({k: torch.as_tensor(v)
                                    for k, v in field_state.items()})
        named = list(self.field.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optim = optim.Adam(named)
        self.pending = [torch.zeros_like(p) for p in self.params]
        self.occ = occupancy.init_occupancy(config["tpu"]["occ_resolution"],
                                            self.device)
        self.epoch, self.global_step = epoch, step
        self._set_levels(self._active_levels())
        self.guidance, self.prior = guidance, prior
        self.embeddings = None
        self.sampler = None
        if guidance is not None:
            self.embeddings = prior.conditioning(self)
            d = config["data"]
            scale = (d["novel_view_scale_final"] if epoch > 800
                     else d["novel_view_scale"])
            self.sampler = VirtualViewSampler(self.dataset, config, scale,
                                              self.device)

    # ---- curriculum ----

    def _active_levels(self):
        if not self.curr.progressive_level:
            return None
        L = self.spec.grid.num_levels
        active = active_count(self.curr.max_level(self.epoch), L)
        return min(L, active + (active & 1))

    def _set_levels(self, active_levels):
        spec = self.spec
        if active_levels is not None and active_levels < spec.grid.num_levels:
            spec = dataclasses.replace(spec, active_levels=active_levels)
        self.step_field = self.field.with_spec(spec)
        interp = (spec.grid.interpolation if self.occ_interp == "linear"
                  else self.occ_interp)
        self.occ_field = self.field.with_spec(dataclasses.replace(
            spec, grid=dataclasses.replace(spec.grid, interpolation=interp)))

    # ---- occupancy ----

    @torch.no_grad()
    def _refresh_occ(self, step: int, t_scalar) -> None:
        tpu = self.config["tpu"]
        if step % tpu["occ_update_every"] != 0:
            return

        def dens(x):
            return torch.cat([
                self.occ_field.query_density(c, t=t_scalar,
                                             return_color=False)["sigma"]
                for c in x.split(OCC_CHUNK)])
        step_size = self.config["render"]["step_size"]
        if step < tpu["occ_warmup_steps"]:
            self.occ = occupancy.update_occupancy(
                self.occ, self.draws, dens, step, self.bound, step_size,
                warmup_steps=tpu["occ_warmup_steps"],
                ema_decay=tpu["occ_ema_decay"], threshold=tpu["occ_threshold"])
        else:
            self.occ = occupancy.update_occupancy_sampled(
                self.occ, self.draws, dens, self.bound, step_size,
                ema_decay=tpu["occ_ema_decay"],
                threshold=tpu["occ_threshold"],
                sample_fraction=tpu.get("occ_sample_fraction", 0.25),
                update_index=step // tpu["occ_update_every"])

    # ---- losses ----

    def _reg_loss(self, out, ori_w, beta_w):
        tr = self.config["train"]
        loss = beta_w * laplace_beta(self.field.beta)
        if "loss_orient" in out:
            loss = loss + ori_w * out["loss_orient"]
        for w, key in (("normal_smooth_3d", "loss_normal_perturb"),
                       ("normal_smooth_3d_t", "loss_normal_perturb_t"),
                       ("deform_smooth", "loss_deform_perturb"),
                       ("deform_smooth_t", "loss_deform_perturb_t"),
                       ("topo_smooth_t", "loss_topo_perturb_t")):
            if tr[w] > 0 and key in out:
                loss = loss + tr[w] * out[key]
        if tr["eik_weight"] > 0 and "normal_raw_eik" in out:
            loss = loss + tr["eik_weight"] * out["normal_raw_eik"]
        if tr["normal_smoothness"] > 0 and "normal_reg" in out:
            loss = loss + tr["normal_smoothness"] * out["normal_reg"]
        if tr["deform_weight"] > 0 and "deform_abs" in out:
            loss = loss + tr["deform_weight"] * out["deform_abs"]
        if tr["code_reg"] > 0 and "loss_code" in out:
            loss = loss + tr["code_reg"] * out["loss_code"]
        if tr["entropy_weight"] > 0:
            loss = loss + tr["entropy_weight"] * entropy_loss(
                out["weights"], out["mask"], LOCAL)
        return loss

    def _real_loss(self, max_level, weights):
        draws, tr = self.draws, self.config["train"]
        batch = sample_real_view_rays(draws, self.data,
                                      self.dataset.num_frames,
                                      tr["real_ray_num"])
        if tr["real_view_noise"] > 0:
            batch = dict(batch)
            batch["rays_o"] = batch["rays_o"] + draws.normal(
                "noise_o", (3,)) * tr["real_view_noise"]
            batch["rays_d"] = batch["rays_d"] + draws.normal(
                "noise_d", (3,)) * tr["real_view_noise"]
        N = batch["rays_o"].shape[0]
        bg_color = draws.uniform("bg", (N, 3))
        field = self.step_field
        out = renderer.render_rays(
            field, self.occ, draws, batch["rays_o"], batch["rays_d"],
            batch["rays_t"], batch["rays_id"], self.rcfg, bg_color=bg_color,
            ambient_ratio=1.0, shading_id=SHADING_LAMBERTIAN,
            rays_depth=batch["depth"], rays_mask=batch["mask"],
            optimize_pose=True, max_level=max_level, train=True)
        gt_mask = (batch["mask"] > 0.5).float()
        gt_rgb = (batch["image"] * gt_mask[:, None]
                  + bg_color * (1 - gt_mask[:, None]))
        gt_depth = batch["depth"]
        ori_w, rgb_w, beta_w = weights
        loss = rgb_w * rgb_loss(out["image"], gt_rgb, LOCAL)
        if tr["mask_weight"] > 0:
            loss = loss + tr["mask_weight"] * mask_loss(out["opacity"],
                                                        gt_mask, LOCAL)
        if tr["depth_weight"] > 0:
            loss = loss + tr["depth_weight"] * depth_loss(
                out["depth"], gt_depth, batch["rays_o"], batch["rays_d"],
                gt_mask, red=LOCAL)
        if tr["sdf_weight"] > 0:
            loss = loss + tr["sdf_weight"] * out["sdf_loss"]
        if tr["sdf_reg"] > 0:
            m = out["mask"].float()
            loss = loss + tr["sdf_reg"] * ((out["sdf"] ** 2 * m).sum()
                                           / (m.sum() + 1e-8))
        if tr["fs_weight"] > 0:
            loss = loss + tr["fs_weight"] * out["fs_loss"]
        if tr["surf_sdf_weight"] > 0:
            xyzs = batch["rays_o"] + gt_depth[:, None] * batch["rays_d"]
            pts_norm = torch.linalg.norm(xyzs, dim=-1)
            dm = ((gt_depth > 0) & (pts_norm <= self.rcfg.outside_radius)
                  & (gt_mask > 0.5))
            res = field.query_density(xyzs, t=batch["rays_t"],
                                      max_level=max_level)
            n_valid = dm.sum() + 1e-8
            surf_sdf = torch.where(dm, res["sdf"] ** 2, 0.0).sum() / n_valid
            cerr = ((res["albedo"] - gt_rgb) ** 2).sum(-1) / 3.0
            surf_color = torch.where(dm, cerr, 0.0).sum() / N
            loss = loss + tr["surf_sdf_weight"] * surf_sdf
            loss = loss + tr["surf_color_weight"] * surf_color
        return loss + self._reg_loss(out, ori_w, beta_w)

    def _grads(self, loss):
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(self.params, grads)]

    # ---- the SDS virtual step ----

    def sample_view(self, epoch) -> dict:
        """One novel view's rays and pose, within the epoch's ranges under
        progressive_view."""
        if self.curr.progressive_view:
            th, ph = self.curr.view_ranges(epoch)
            return self.sampler.sample(draws=self.draws, theta_range=th,
                                       phi_range=ph)
        return self.sampler.sample(draws=self.draws)

    def _virtual_loss(self, epoch, max_level):
        cfg, draws = self.config, self.draws
        tr = cfg["train"]
        batch = self.prior.views(self, epoch)
        N = batch["rays_o"].shape[0]
        albedo_phase = (np.float32(epoch) / np.float32(self.curr.n_epochs)
                        <= np.float32(self.curr.albedo_iter_ratio))
        u = draws.uniform("shade", ())
        a = draws.uniform("ambient", ())
        if albedo_phase:
            shading_id, ambient = SHADING_ALBEDO, 1.0
        else:
            shading_id = torch.where(
                u >= 1.0 - self.curr.textureless_ratio,
                SHADING_TEXTURELESS, SHADING_LAMBERTIAN)
            min_amb = self.curr.min_ambient_ratio
            ambient = min_amb + (1.0 - min_amb) * a
        rand_bg = draws.uniform("bg_virtual", (3,)).expand(N, 3)
        if cfg["model"]["bg_radius"] > 0:
            net_bg = self.step_field.background(batch["rays_d"],
                                                batch["rays_t"], max_level)
            use_net = draws.uniform("bg_select", ()) > 0.5
            bg_color = torch.where(use_net, net_bg, rand_bg)
        else:
            bg_color = rand_bg
        out = renderer.render_rays(
            self.step_field, self.occ, draws, batch["rays_o"],
            batch["rays_d"], batch["rays_t"], batch["rays_id"], self.rcfg,
            bg_color=bg_color, ambient_ratio=ambient, shading_id=shading_id,
            real_view=False, optimize_pose=False, max_level=max_level,
            train=True)
        loss_sds = self.prior.loss(self, batch, out, epoch)
        ori_w, rgb_w, beta_w = self.curr.loss_weights(epoch)
        loss = loss_sds + self._reg_loss(out, ori_w, beta_w)
        if tr["normal_smooth_2d"] > 0 and "normal_image" in out:
            ni = out["normal_image"].reshape(self.sampler.H,
                                             self.sampler.W, 3)
            loss = loss + tr["normal_smooth_2d"] * (
                ((ni[1:] - ni[:-1]) ** 2).mean()
                + ((ni[:, 1:] - ni[:, :-1]) ** 2).mean())
        return loss

    # ---- steps ----

    def real_step(self) -> torch.Tensor:
        """The epoch loop's real step: t_occ, the occupancy refresh when it is
        due, then the body that the port's graph holds, the carried
        gradients always folded in."""
        t_occ = self.draws.uniform("t_occ", ())
        self._refresh_occ(self.global_step, t_occ)
        c, e = self.curr, self.epoch
        lr = np.float32(c.learning_rate(e))
        max_level = np.float32(c.max_level(e))
        weights = tuple(np.float32(w) for w in c.loss_weights(e))
        loss = self._real_loss(float(max_level),
                               tuple(float(w) for w in weights))
        grads = self._grads(loss)
        torch._foreach_add_(grads, self.pending)
        torch._foreach_zero_(self.pending)
        self.optim.update(grads, float(lr))
        self.global_step += 1
        return loss.detach()

    def virtual_step(self) -> torch.Tensor:
        """One SDS step: its gradients over virtual_freq, zeroed when not all
        finite, on Adam at once with the deform groups frozen while the
        freeze holds, else carried into the next real step."""
        e = self.epoch
        lr = self.curr.learning_rate(e)
        max_level = self.curr.max_level(e)
        t_occ = self.draws.uniform("t_occ", ())
        self._refresh_occ(self.global_step, t_occ)
        loss = self._virtual_loss(e, max_level)
        grads = self._grads(loss)
        torch._foreach_div_(grads, float(self.config["train"]["virtual_freq"]))
        found = torch.zeros((), device=self.device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, torch.ones_like(found))
        ok = found == 0.0
        grads = [torch.where(ok, g, 0.0) for g in grads]
        if self.curr.freeze_deform(e):
            self.optim.update(grads, lr, frozen=optim.FREEZE_GROUPS, ok=ok)
            torch._foreach_zero_(self.pending)
        else:
            torch._foreach_add_(self.pending, grads)
        self.global_step += 1
        return loss.detach()

    def step(self, kind: str) -> torch.Tensor:
        return self.real_step() if kind == "real" else self.virtual_step()
