"""Per-scene optimisation, real-view step (port of
morpheus_tpu/train/trainer.py: Trainer construction, the occupancy cadence,
_real_loss / real_loss_from_batch / _reg_loss, the real step with its
non-finite skip, _active_levels and the epoch loop).

    trainer = Trainer(config, dataset)          # device="cuda" by default
    loss = trainer.train_one_epoch()
    trainer.save_ckpt(path); trainer.load_ckpt(path)

One real step: draw a ray batch, refresh the occupancy grid on its cadence,
render with all regularizers, take the gradient of the weighted loss and
apply Adam unless a gradient is non-finite. The step makes no host
synchronisation; the epoch loop reads the loss once at its end.

A checkpoint (save_ckpt, load_ckpt: the port of morpheus_tpu/train/
trainer.py:919-955) is a pickle of plain dicts, lists, numpy arrays and
numbers, so that reading it needs no class of either package.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from .. import renderer
from ..data import dataset as data_lib
from ..model.field import SHADING_LAMBERTIAN, Field, FieldSpec
from ..ops import density as density_lib
from ..ops import occupancy
from ..ops.hashgrid import HashGridSpec, active_count
from ..utils import Draws, resolve_device
from . import losses, optim
from .schedule import Curriculum

OCC_CHUNK = 32768


class Trainer:
    def __init__(self, config: dict, dataset: data_lib.DeformDataset,
                 device="cuda", seed: int | None = None,
                 draws: Draws | None = None, guidance=None,
                 workspace: str | None = None):
        if guidance is not None:
            raise NotImplementedError(
                "guidance (Zero123 SDS virtual steps) is not ported yet "
                "(ROADMAP.md queue A, items A9-A10)")
        if int(config["tpu"].get("data_parallel", 1)) > 1:
            raise NotImplementedError(
                "tpu.data_parallel > 1 is not ported yet (ROADMAP.md queue A, "
                "item A12)")
        self.config = config
        self.dataset = dataset
        self.workspace = workspace or os.path.join(config["exp"]["output"],
                                                   config["exp"]["exp_name"])
        self.device = resolve_device(device)
        seed = config["exp"].get("seed", 2024) if seed is None else seed
        self.draws = draws if draws is not None else Draws(self.device, seed)

        self.curr = Curriculum.from_config(config)
        self.bound = dataset.bound
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
        self.spec = FieldSpec(
            grid=grid, num_frames=dataset.num_frames, bound=self.bound,
            deform_dim=m["deform_dim"], amb_dim=m["amb_dim"],
            use_t=m["use_t"], use_app=m["use_app"], use_joint=m["use_joint"],
            color_grid=m["color_grid"], encode_topo=m["encode_topo"],
            bg_radius=m["bg_radius"],
            compute_dtype=tpu.get("compute_dtype", "float32"),
            mlp_dtype=tpu.get("mlp_dtype", "float32"))
        self.rcfg = renderer.RenderConfig.from_config(config,
                                                      dataset.num_frames,
                                                      self.bound)
        # occupancy density queries read one rounded corner per level
        # ('nearest', the default) or interpolate ('linear')
        self.occ_interp = tpu.get("occ_query_interp", "nearest")
        self.data = dataset.device_data(self.device,
                                        scale=config["data"]["known_view_scale"])

        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self.field = Field(self.spec, self.device).reset_parameters(gen)
        self._reset_state()
        self.occ = occupancy.init_occupancy(tpu["occ_resolution"], self.device)
        self.global_step = 0
        self.epoch = 0
        self._set_levels(None)

    def _reset_state(self):
        named = list(self.field.named_parameters())
        self.params = [p for _, p in named]
        self.optim = optim.Adam(named)
        # the EMA weights are the parameters of a second field, which the
        # test videos render
        self.ema_field = copy.deepcopy(self.field).requires_grad_(False)
        self.ema = list(self.ema_field.parameters())

    def load_params(self, state: dict):
        """Load parameters by name (see convert.params_from_jax); resets the
        optimizer moments and the EMA."""
        self.field.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()})
        self._reset_state()

    # ---- curriculum ----

    def _active_levels(self) -> int | None:
        """Host mirror of the float32 max_level schedule: the levels this
        epoch unlocks, rounded up to an even count (exact: the traced mask
        zero-fills the extra level)."""
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
        self.occ_field = self.field.with_spec(dataclasses.replace(
            spec, grid=dataclasses.replace(spec.grid,
                                           interpolation=self.occ_interp)))

    # ---- occupancy ----

    def _occ_density_fn(self, t_scalar):
        def fn(x):
            return torch.cat([
                self.occ_field.query_density(c, t=t_scalar,
                                             return_color=False)["sigma"]
                for c in x.split(OCC_CHUNK)])
        return fn

    @torch.no_grad()
    def _maybe_update_occ(self, occ, step: int, t_scalar, draws):
        tpu = self.config["tpu"]
        if step % tpu["occ_update_every"] != 0:
            return occ
        dens = self._occ_density_fn(t_scalar)
        step_size = self.config["render"]["step_size"]
        if step < tpu["occ_warmup_steps"]:
            return occupancy.update_occupancy(
                occ, draws, dens, step, self.bound, step_size,
                warmup_steps=tpu["occ_warmup_steps"],
                ema_decay=tpu["occ_ema_decay"], threshold=tpu["occ_threshold"])
        return occupancy.update_occupancy_sampled(
            occ, draws, dens, self.bound, step_size,
            ema_decay=tpu["occ_ema_decay"], threshold=tpu["occ_threshold"],
            sample_fraction=tpu.get("occ_sample_fraction", 0.25),
            update_index=step // tpu["occ_update_every"])

    # ---- losses ----

    def _real_loss(self, occ, draws, epoch, max_level):
        """Real-view loss on a freshly drawn ray batch."""
        tr = self.config["train"]
        batch = data_lib.sample_real_view_rays(
            draws, self.data, self.dataset.num_frames, tr["real_ray_num"])
        if tr["real_view_noise"] > 0:
            # one shared 3-vector of noise per step (morpheus.py:858-860)
            batch = dict(batch)
            batch["rays_o"] = batch["rays_o"] + draws.normal(
                "noise_o", (3,)) * tr["real_view_noise"]
            batch["rays_d"] = batch["rays_d"] + draws.normal(
                "noise_d", (3,)) * tr["real_view_noise"]
        N = batch["rays_o"].shape[0]
        bg_color = draws.uniform("bg", (N, 3))
        return self.real_loss_from_batch(occ, draws, epoch, max_level, batch,
                                         bg_color)

    def real_loss_from_batch(self, occ, draws, epoch, max_level, batch,
                             bg_color):
        """Weighted real-view loss of an explicit ray batch; (loss, out)."""
        field = self.step_field
        tr = self.config["train"]
        N = batch["rays_o"].shape[0]
        out = renderer.render_rays(
            field, occ, draws, batch["rays_o"], batch["rays_d"],
            batch["rays_t"], batch["rays_id"], self.rcfg, bg_color=bg_color,
            ambient_ratio=1.0, shading_id=SHADING_LAMBERTIAN,
            rays_depth=batch["depth"], rays_mask=batch["mask"],
            optimize_pose=True, max_level=max_level, train=True)

        gt_mask = (batch["mask"] > 0.5).float()
        gt_rgb = (batch["image"] * gt_mask[:, None]
                  + bg_color * (1 - gt_mask[:, None]))
        gt_depth = batch["depth"]
        ori_w, rgb_w, beta_w = self.curr.loss_weights(epoch)

        loss = rgb_w * losses.rgb_loss(out["image"], gt_rgb)
        if tr["mask_weight"] > 0:
            loss = loss + tr["mask_weight"] * losses.mask_loss(out["opacity"],
                                                               gt_mask)
        if tr["depth_weight"] > 0:
            loss = loss + tr["depth_weight"] * losses.depth_loss(
                out["depth"], gt_depth, batch["rays_o"], batch["rays_d"],
                gt_mask)
        if tr["sdf_weight"] > 0:
            loss = loss + tr["sdf_weight"] * out["sdf_loss"]
        if tr["sdf_reg"] > 0:
            m = out["mask"].float()
            loss = loss + tr["sdf_reg"] * ((out["sdf"] ** 2 * m).sum()
                                           / (m.sum() + 1e-8))
        if tr["fs_weight"] > 0:
            loss = loss + tr["fs_weight"] * out["fs_loss"]

        # surface-point losses (morpheus.py:1001-1027)
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

        loss = loss + self._reg_loss(out, ori_w, beta_w)
        return loss, out

    def _reg_loss(self, out, ori_w, beta_w):
        """Shared regularizers (morpheus.py:1090-1145)."""
        tr = self.config["train"]
        loss = beta_w * density_lib.laplace_beta(self.field.beta)
        if "loss_orient" in out:
            loss = loss + ori_w * out["loss_orient"]
        if tr["normal_smooth_3d"] > 0 and "loss_normal_perturb" in out:
            loss = loss + tr["normal_smooth_3d"] * out["loss_normal_perturb"]
        if tr["eik_weight"] > 0 and "normal_raw_eik" in out:
            loss = loss + tr["eik_weight"] * out["normal_raw_eik"]
        if tr["normal_smoothness"] > 0 and "normal_reg" in out:
            loss = loss + tr["normal_smoothness"] * out["normal_reg"]
        if tr["deform_weight"] > 0 and "deform_abs" in out:
            loss = loss + tr["deform_weight"] * out["deform_abs"]
        if tr["code_reg"] > 0 and "loss_code" in out:
            loss = loss + tr["code_reg"] * out["loss_code"]
        if tr["entropy_weight"] > 0:
            loss = loss + tr["entropy_weight"] * losses.entropy_loss(
                out["weights"], out["mask"])
        return loss

    # ---- steps ----

    def real_step(self, epoch) -> torch.Tensor:
        """One real-view optimizer step; returns the loss (on the device)."""
        draws = self.draws
        step = self.global_step
        lr = self.curr.learning_rate(epoch)
        max_level = self.curr.max_level(epoch)
        t_occ = draws.uniform("t_occ", ())
        self.occ = self._maybe_update_occ(self.occ, step, t_occ, draws)
        loss, _ = self._real_loss(self.occ, draws, epoch, max_level)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        self.optim.update(grads, lr)
        self.global_step += 1
        return loss.detach()

    def train_one_epoch(self, n_iters: int | None = None) -> float:
        """n_iters x (virtual_freq + real_freq) real steps, then the EMA.
        Without guidance the reference runs its virtual slots as real steps,
        and so does this."""
        tr = self.config["train"]
        n_iters = n_iters or tr.get("n_iters", 10)
        self._set_levels(self._active_levels())
        loss = torch.tensor(float("nan"))
        for _ in range(n_iters):
            for _ in range(tr["virtual_freq"] + tr["real_freq"]):
                loss = self.real_step(self.epoch)
        optim.ema_update(self.ema, self.params, tr["ema_decay"])
        return float(loss)

    def train(self, max_epochs: int | None = None, log=print):
        max_epochs = max_epochs or self.config["train"]["n_epochs"]
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            t0 = time.time()
            loss = self.train_one_epoch()
            log(f"epoch {epoch}/{max_epochs} loss={loss:.4f} "
                f"({time.time() - t0:.2f}s)")
        return self.field

    # ---- checkpoints (reference: morpheus.py:329-358) ----

    def state_dict(self) -> dict:
        """Everything a resumed run needs to continue as if never stopped:
        parameters, Adam's step and moments, the EMA, the occupancy grid,
        the step and epoch counters and the state of the random draws (the
        port has no virtual steps, so its host step is the global step)."""
        def arrays(ts):
            return {n: t.detach().cpu().numpy()
                    for n, t in zip(self.optim.names, ts)}
        draws = (self.draws.generator.get_state().numpy()
                 if isinstance(self.draws, Draws) else None)
        return {
            "params": arrays(self.params),
            "optim": {"name": "adam", "step": float(self.optim.step),
                      "mu": arrays(self.optim.mu),
                      "nu": arrays(self.optim.nu)},
            "ema": arrays(self.ema),
            "occ": {"occs": self.occ.occs.cpu().numpy(),
                    "binaries": self.occ.binaries.cpu().numpy()},
            "global_step": int(self.global_step),
            "epoch": int(self.epoch),
            "draws": draws,
            "host_step": int(self.global_step),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a state_dict() (or convert.load_jax_ckpt's dict, which
        has no draws state) in place."""
        if state["optim"]["name"] != "adam":
            raise NotImplementedError(
                f"optimizer {state['optim']['name']!r}: the port runs Adam "
                "only (ROADMAP.md queue A, item A15)")

        def load(dst, src):
            with torch.no_grad():
                for n, t in zip(self.optim.names, dst):
                    t.copy_(torch.as_tensor(np.asarray(src[n])))
        load(self.params, state["params"])
        load(self.optim.mu, state["optim"]["mu"])
        load(self.optim.nu, state["optim"]["nu"])
        load(self.ema, state["ema"])
        self.optim.step.fill_(float(state["optim"]["step"]))
        self.occ = occupancy.OccupancyState(
            occs=torch.as_tensor(np.asarray(state["occ"]["occs"]),
                                 device=self.device),
            binaries=torch.as_tensor(np.asarray(state["occ"]["binaries"]),
                                     device=self.device))
        self.global_step = int(state["global_step"])
        self.epoch = int(state["epoch"])
        if state.get("draws") is not None and isinstance(self.draws, Draws):
            self.draws.generator.set_state(
                torch.as_tensor(np.asarray(state["draws"])))

    def save_ckpt(self, path: str) -> None:
        """Write state_dict() to `path` atomically (a .tmp file, then
        os.replace), as morpheus_tpu/train/trainer.py:921-934 does."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.state_dict(), f)
        os.replace(tmp, path)

    def load_ckpt(self, path: str) -> None:
        """Resume from a checkpoint that save_ckpt wrote."""
        with open(path, "rb") as f:
            self.load_state_dict(pickle.load(f))
