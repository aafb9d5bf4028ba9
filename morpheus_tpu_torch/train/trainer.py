"""Per-scene optimisation (port of morpheus_tpu/train/trainer.py: Trainer
construction, the occupancy cadence, the real step, the Zero123 SDS
virtual step, _active_levels and the epoch loop).

    trainer = Trainer(config, dataset)          # device="cuda" by default
    trainer = Trainer(config, dataset, guidance=Zero123Guidance...)  # SDS
    loss = trainer.train_one_epoch()
    trainer.save_ckpt(path); trainer.load_ckpt(path)

One real step: draw a ray batch, refresh the occupancy grid on its cadence,
render with all regularizers, take the gradient of the weighted loss, add
the virtual steps' pending gradients and apply the optimizer (Adam or Adan,
train.optim) unless a gradient is non-finite. One virtual step (with guidance): draw a camera around a
random frame, render the whole view, score it with Zero123's SDS against
a keyframe, and either step the optimizer with the deformation groups
frozen
(while curriculum.freeze_deform) or add the gradients to pending_grads,
which the next real step folds in. Neither step synchronises with the
host; the epoch loop reads the loss once at its end.

Under tpu.chain_steps (the default; the JAX package's one lax.scan dispatch
of the real_freq real steps, trainer.py:343-370 and :864-900 there) the
epoch loop's real steps on a card replay a CUDA graph of the real step's
body (_StepGraph: the batch draws, the loss, its gradients, the fold of
the carried gradients and the optimizer update), captured once for each
active-level count after an eager warm-up step and evicted when the
count moves on. The body reads the curriculum's learning rate, max_level
and loss weights from device buffers (schedule.StepScalars) where the
JAX step reads its traced epoch; the occupancy refresh stays outside the
graph, on the host's cadence, and writes the grid in place, as does every
other writer of a tensor the graph reads. On the CPU the same body runs
eagerly (the graph's plain twin). chain_steps false runs the eager step.

Under tpu.data_parallel N the trainer is one of N ranks of a process
group (parallel/sharding.py; the port of trainer.py:114-130 and
_train_one_epoch_dp, :740-848, of the JAX package): every rank holds the
same state; a real step draws the global batch on the host
(sharding.host_sample_real_batch, from a numpy generator as the JAX copy
does), copies its own rows into static buffers on the device (_stage),
renders them with selections of a fixed size (sharding.Rows) and sums the
gradients of its share of the global loss over the ranks; a virtual step
renders one view a rank and averages. Under tpu.chain_steps an NCCL rank
replays a graph of that body, its all-reduces captured with it (the JAX
package's make_sharded_real_steps_chained); the real_freq steps' host
batches are drawn together first, as that scan takes them
(sharding.shard_batch_stacked), and each is copied in before its replay.
A rank of gloo (on the CPU, or ranks that share a card) runs the same
body eagerly: gloo's collectives cannot be captured. The single-device
trainer is the same code with no process group.

A checkpoint (save_ckpt, load_ckpt: the port of morpheus_tpu/train/
trainer.py:919-955) is a pickle of plain dicts, lists, numpy arrays and
numbers, so that reading it needs no class of either package; under data
parallelism rank 0 writes it and every rank reads it.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import time

import numpy as np
import torch
import torch.utils.checkpoint

from .. import renderer, trace
from ..data import dataset as data_lib
from ..model.field import (SHADING_ALBEDO, SHADING_LAMBERTIAN,
                           SHADING_TEXTURELESS, Field, FieldSpec)
from ..ops import density as density_lib
from ..ops import gather, hist, occupancy, segsum
from ..ops.hashgrid import HashGridSpec, active_count
from ..ops.rows import row_gather
from ..parallel import sharding
from ..utils import Draws, resolve_device
from . import losses, optim
from .schedule import Curriculum, StepScalars

OCC_CHUNK = 32768

# the hand-written kernels' wrappers, whose launch counters a replayed graph
# advances by the calls its capture recorded
KERNEL_WRAPPERS = (hist.level_histogram, gather.level_gather,
                   segsum.segment_sum_sorted, row_gather)
# the steps' compacted sample streams, whose fill the device counters
# <stream>.samples_valid and <stream>.samples_slots count (trace.fill)
SAMPLE_STREAMS = ("real", "sds")


class RecordedDraws:
    """Draws that a recomputation replays: the first pass through a
    checkpointed region records every draw, each later pass (a backward's
    recomputation, or one that an autograd.grad inside the region starts
    while the first pass runs) reads the same values back in the same order
    from a cursor of its own. torch.utils.checkpoint restores the global
    generators only, not a draw source's own."""

    def __init__(self, draws):
        self.draws, self.values, self.started = draws, [], False

    def start(self):
        if not self.started:
            self.started = True
            return self
        return _Replay(self.values)

    def uniform(self, name, shape):
        return self._keep(self.draws.uniform(name, shape))

    def normal(self, name, shape):
        return self._keep(self.draws.normal(name, shape))

    def randint(self, name, shape, low, high):
        return self._keep(self.draws.randint(name, shape, low, high))

    def _keep(self, v):
        self.values.append(v)
        return v


class _Replay:
    def __init__(self, values):
        self.values, self.i = values, 0

    def _next(self, *_):
        self.i += 1
        return self.values[self.i - 1]

    uniform = normal = randint = _next


class _StepGraph:
    """A CUDA graph of Trainer._real_body, captured on the trainer's
    current state. The draws' generator is registered with the graph, so
    that each replay advances it as the eager body would. replay() returns
    the loss, a buffer of the graph that the next replay overwrites. A
    wrapper's launch counter counts its host calls, and the reducer its
    all-reduces: the capture runs nothing, so its calls are taken back off
    the counters and added again at each replay (recorded, all_reduces).
    capture_s and pool_mb (the card memory the graph's private pool holds)
    are measured at capture, and the body's spans map its device nodes as
    it is captured (trace.capture_phases: phases, device_nodes, None where
    the map was lost). The graph holds for the step field's spec, the
    occupancy state and the reducer it was captured against, whose tensors
    (and the staged batch's) are written in place, never rebound, while it
    lives (fits)."""

    def __init__(self, trainer: "Trainer"):
        dev, red = trainer.device, trainer.dp
        self.spec, self.occ = trainer.step_field.spec, trainer.occ
        self.red = red
        self.graph = torch.cuda.CUDAGraph()
        if isinstance(trainer.draws, Draws):
            self.graph.register_generator_state(trainer.draws.generator)
        before = [f.launches for f in KERNEL_WRAPPERS]
        reduces = (red.all_reduces, red.all_reduce_bytes)
        nodes = trace.NodeMap()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph), trace.capture_phases(nodes):
            self.loss = trainer._real_body()
        torch.cuda.synchronize(dev)
        self.phases, self.device_nodes = nodes.phases, nodes.device_nodes
        self.capture_s = time.perf_counter() - t0
        self.pool_mb = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        self.recorded = [f.launches - b for f, b in zip(KERNEL_WRAPPERS,
                                                        before)]
        for f, b in zip(KERNEL_WRAPPERS, before):
            f.launches = b
        self.all_reduces = red.all_reduces - reduces[0]
        self.all_reduce_bytes = red.all_reduce_bytes - reduces[1]
        red.all_reduces, red.all_reduce_bytes = reduces

    def fits(self, trainer: "Trainer") -> bool:
        return (self.spec == trainer.step_field.spec
                and self.occ is trainer.occ and self.red is trainer.dp)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for f, n in zip(KERNEL_WRAPPERS, self.recorded):
            f.launches += n
        self.red.all_reduces += self.all_reduces
        self.red.all_reduce_bytes += self.all_reduce_bytes
        return self.loss


class Trainer:
    def __init__(self, config: dict, dataset: data_lib.DeformDataset,
                 device="cuda", seed: int | None = None,
                 draws: Draws | None = None, guidance=None,
                 workspace: str | None = None,
                 reducer: sharding.Reducer | None = None):
        """guidance: a guidance.zero123.Zero123Guidance on `device` (SDS
        virtual steps); None trains recon-only, its virtual slots running
        real steps as the reference's do. reducer: this rank's process
        group (sharding.Reducer); by default the one tpu.data_parallel
        asks for (sharding.Reducer.for_config: none for 1)."""
        from ..guidance.zero123 import Zero123Guidance
        if guidance is not None and not isinstance(guidance, Zero123Guidance):
            raise TypeError(f"guidance: a Zero123Guidance, not "
                            f"{type(guidance).__name__}")
        self.dp = (sharding.Reducer.for_config(config) if reducer is None
                   else reducer)
        sharding.check_rays(config, self.dp.world)
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
        # ('nearest', the default) or interpolate as the field does
        # ('linear': the field's own interpolation, as the JAX trainer's
        # occ_spec keeps it)
        self.occ_interp = tpu.get("occ_query_interp", "nearest")
        self.data = dataset.device_data(self.device,
                                        scale=config["data"]["known_view_scale"])
        if self.dp.active:
            # the real batches are drawn on the host, from a numpy
            # generator of the seed (trainer.py:130 of the JAX package; it
            # is not in the checkpoint there either)
            self.host_data = {
                k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in dataset.device_data(
                    "cpu", scale=config["data"]["known_view_scale"]).items()}
            self._np_rng = np.random.default_rng(int(seed))
        # this rank's rows of the real batch on the device, written in
        # place by _stage, and the pinned host buffers it copies from
        self._batch = self._staging = self._staged = None
        # host rows drawn ahead (train_one_epoch's block), taken in order
        self._drawn: list = []

        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self.field = Field(self.spec, self.device).reset_parameters(gen)
        self.dp.broadcast(list(self.field.parameters()))
        self._reset_state()
        self.occ = occupancy.init_occupancy(tpu["occ_resolution"], self.device)
        self.scalars = StepScalars(self.curr, self.device)
        self.chain = bool(tpu.get("chain_steps", True))
        # the chained step replays a graph on a card, with its NCCL
        # all-reduces under a process group; on the CPU and under gloo it
        # runs the graph's body eagerly
        self.graphed = (self.chain and self.device.type == "cuda"
                        and self.dp.backend in (None, "nccl"))
        # one line per capture: {"active_levels", "warmup_s", "capture_s",
        # "pool_mb", "launches", "all_reduces", "all_reduce_bytes",
        # "phases", "device_nodes"}
        self.captures: list = []
        trace.allocate(SAMPLE_STREAMS, self.device)
        self.global_step = 0
        # optimizer steps of the epoch loop, real and virtual, counted on
        # the host: the warm-up gate and the guidance-panel cadence read it
        self.host_step = 0
        self.epoch = 0
        self._set_levels(None)
        self._samplers: dict = {}
        self.guidance = guidance
        self.embeddings = None
        if guidance is not None:
            self.embeddings = self.precompute_embeddings(guidance)
            # the CLIP tower serves only that one pass: on the card its
            # ViT-L/14 weights (~1.2 GB) would stay for the whole run, so
            # it moves to the host (trainer.py:130-140 of the JAX package)
            guidance.clip.to("cpu")

    def _reset_state(self):
        named = list(self.field.named_parameters())
        self.params = [p for _, p in named]
        self.optim = optim.make(self.config["train"]["optim"], named)
        # the EMA weights are the parameters of a second field, which the
        # test videos render
        self.ema_field = copy.deepcopy(self.field).requires_grad_(False)
        self.ema = list(self.ema_field.parameters())
        # virtual-step gradients carried into the next real step once the
        # deform freeze ends (the reference accumulates .grad across the
        # virtual-to-real boundary, morpheus.py:1393-1424); _pending_live
        # says whether any was added since the last real step
        self.pending = [torch.zeros_like(p) for p in self.params]
        self._pending_live = False
        # graphs of the step, by active-level count: they hold the
        # addresses of the state just replaced
        self._graphs: dict = {}

    def load_params(self, state: dict):
        """Load parameters by name (see convert.params_from_jax); resets the
        optimizer moments, the EMA and the pending gradients."""
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
        interp = (spec.grid.interpolation if self.occ_interp == "linear"
                  else self.occ_interp)
        self.occ_field = self.field.with_spec(dataclasses.replace(
            spec, grid=dataclasses.replace(spec.grid, interpolation=interp)))

    def set_spec(self, grid=None, **field):
        """Replace spec-level options that leave every parameter's shape as
        it is - the hash grid's (`grid`: vjp_mode, interpolation, gridtype,
        align_corners) and the field's (normal_mode, ...) - in place, with
        the step's and the occupancy queries' fields at this epoch's
        levels."""
        self.spec = dataclasses.replace(
            self.spec, grid=dataclasses.replace(self.spec.grid, **(grid or {})),
            **field)
        self.field.spec = self.spec
        self._set_levels(self._active_levels())
        self._graphs.clear()

    # ---- occupancy ----

    def _occ_density_fn(self, t_scalar):
        def fn(x):
            return torch.cat([
                self.occ_field.query_density(c, t=t_scalar,
                                             return_color=False)["sigma"]
                for c in x.split(OCC_CHUNK)])
        return fn

    @torch.no_grad()
    def _refresh_occ(self, step: int, t_scalar, draws) -> None:
        """The occupancy refresh of `step` (_maybe_update_occ), written into
        self.occ's tensors in place: a graph of the step reads them where
        it saw them at capture. A step that is due runs it in the span
        occ.refresh."""
        if not self._occ_due(step):
            return
        with trace.span("occ.refresh"):
            new = self._maybe_update_occ(self.occ, step, t_scalar, draws)
            self.occ.occs.copy_(new.occs)
            self.occ.binaries.copy_(new.binaries)

    def _occ_due(self, step: int) -> bool:
        return step % self.config["tpu"]["occ_update_every"] == 0

    @torch.no_grad()
    def _maybe_update_occ(self, occ, step: int, t_scalar, draws):
        """`occ` refreshed at `step` if it is due (the warm-up's update
        before tpu.occ_warmup_steps, the sampled one after), else `occ`."""
        tpu = self.config["tpu"]
        if not self._occ_due(step):
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

    def _host_block(self, n: int) -> list:
        """This rank's rows of the next n global batches, drawn on the host
        (sharding.host_sample_real_batch from the seed's numpy generator,
        as the JAX copy draws them, one after another), stacked and split
        as the JAX package's chained scan takes them
        (sharding.shard_batch_stacked): n dicts of numpy arrays, the
        background under "bg"."""
        tr = self.config["train"]
        pairs = [sharding.host_sample_real_batch(
            self._np_rng, self.host_data, self.dataset.num_frames,
            tr["real_ray_num"]) for _ in range(n)]
        stack = {k: np.stack([b[k] for b, _ in pairs]) for k in pairs[0][0]}
        stack["bg"] = np.stack([bg for _, bg in pairs])
        rows = sharding.shard_batch_stacked(stack, self.dp.rank,
                                            self.dp.world)
        return [{k: v[i] for k, v in rows.items()} for i in range(n)]

    def _next_rows(self) -> dict:
        """This rank's rows of the next host batch: the next of those drawn
        ahead, else drawn now."""
        return self._drawn.pop(0) if self._drawn else self._host_block(1)[0]

    def _stage(self, rows: dict) -> None:
        """Copy this rank's rows of a host batch (_host_block's) into the
        trainer's batch buffers on the device (self._batch: made at the
        first call, then written in place; a graph of the step reads them
        there). On a card through pinned host buffers with copies that do
        not wait, the pinned buffers written again only once the last
        copies from them are done."""
        cuda = self.device.type == "cuda"
        if self._batch is None:
            dtypes = {k: torch.long if k == "rays_id"
                      else torch.from_numpy(np.asarray(v)).dtype
                      for k, v in rows.items()}
            self._batch = {k: torch.empty(np.shape(v), dtype=dtypes[k],
                                          device=self.device)
                           for k, v in rows.items()}
            if cuda:
                self._staging = {k: torch.empty(np.shape(v), dtype=dtypes[k],
                                                pin_memory=True)
                                 for k, v in rows.items()}
                self._staged = torch.cuda.Event()
        if not cuda:
            for k, v in rows.items():
                self._batch[k].copy_(torch.from_numpy(np.asarray(v)))
            return
        self._staged.synchronize()
        for k, v in rows.items():
            self._staging[k].numpy()[...] = v
            self._batch[k].copy_(self._staging[k], non_blocking=True)
        self._staged.record()

    def _real_batch(self, draws):
        """A fresh real-view ray batch and its background: (batch,
        bg_color). Under a process group, the batch buffers that _stage
        wrote (the JAX copy's data-parallel batch has no
        real_view_noise)."""
        tr = self.config["train"]
        if self.dp.active:
            batch = dict(self._batch)
            return batch, batch.pop("bg")
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
        return batch, draws.uniform("bg", (N, 3))

    def _real_loss(self, occ, draws, epoch, max_level):
        """Real-view loss on a freshly drawn ray batch."""
        batch, bg_color = self._real_batch(draws)
        return self.real_loss_from_batch(occ, draws, epoch, max_level, batch,
                                         bg_color)

    def real_loss_from_batch(self, occ, draws, epoch, max_level, batch,
                             bg_color, weights=None):
        """Weighted real-view loss of an explicit ray batch; (loss, out).
        Under a process group the batch is this rank's rows of the global
        batch and the loss this rank's share of the global loss: the sum
        over the ranks is the loss of the global batch. weights: the (ori,
        rgb, beta) loss weights (host floats or device scalars), by default
        the curriculum's at `epoch`."""
        field = self.step_field
        tr = self.config["train"]
        red = self.dp
        N = batch["rays_o"].shape[0]
        out = renderer.render_rays(
            field, occ, draws, batch["rays_o"], batch["rays_d"],
            batch["rays_t"], batch["rays_id"], self.rcfg, bg_color=bg_color,
            ambient_ratio=1.0, shading_id=SHADING_LAMBERTIAN,
            rays_depth=batch["depth"], rays_mask=batch["mask"],
            optimize_pose=True, max_level=max_level, train=True, red=red)
        trace.fill("real", out["mask"])

        gt_mask = (batch["mask"] > 0.5).float()
        gt_rgb = (batch["image"] * gt_mask[:, None]
                  + bg_color * (1 - gt_mask[:, None]))
        gt_depth = batch["depth"]
        ori_w, rgb_w, beta_w = (self.curr.loss_weights(epoch)
                                if weights is None else weights)

        loss = rgb_w * losses.rgb_loss(out["image"], gt_rgb, red)
        if tr["mask_weight"] > 0:
            loss = loss + tr["mask_weight"] * losses.mask_loss(
                out["opacity"], gt_mask, red)
        if tr["depth_weight"] > 0:
            loss = loss + tr["depth_weight"] * losses.depth_loss(
                out["depth"], gt_depth, batch["rays_o"], batch["rays_d"],
                gt_mask, red=red)
        if tr["sdf_weight"] > 0:
            loss = loss + tr["sdf_weight"] * out["sdf_loss"]
        if tr["sdf_reg"] > 0:
            m = out["mask"].float()
            loss = loss + tr["sdf_reg"] * ((out["sdf"] ** 2 * m).sum()
                                           / (red.total(m.sum()) + 1e-8))
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
            n_valid = red.total(dm.sum()) + 1e-8
            surf_sdf = torch.where(dm, res["sdf"] ** 2, 0.0).sum() / n_valid
            cerr = ((res["albedo"] - gt_rgb) ** 2).sum(-1) / 3.0
            surf_color = torch.where(dm, cerr, 0.0).sum() / (N * red.world)
            loss = loss + tr["surf_sdf_weight"] * surf_sdf
            loss = loss + tr["surf_color_weight"] * surf_color

        loss = loss + self._reg_loss(out, ori_w, beta_w, red)
        return loss, out

    def _reg_loss(self, out, ori_w, beta_w, red=sharding.LOCAL):
        """Shared regularizers (morpheus.py:1090-1145). Under a process
        group (red) the terms of the parameters alone - beta's and the
        deformation codes' - are rank 0's alone."""
        tr = self.config["train"]
        rank0 = red.rank == 0
        loss = beta_w * density_lib.laplace_beta(self.field.beta) if rank0 \
            else 0.0
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
        if tr["code_reg"] > 0 and "loss_code" in out and rank0:
            loss = loss + tr["code_reg"] * out["loss_code"]
        if tr["entropy_weight"] > 0:
            loss = loss + tr["entropy_weight"] * losses.entropy_loss(
                out["weights"], out["mask"], red)
        return loss

    # ---- Zero123 SDS virtual step ----

    @torch.no_grad()
    def precompute_embeddings(self, guidance) -> dict:
        """Per-keyframe CLIP embeddings and VAE latents of the masked
        frames at the guidance's image size (reference get_embeddings,
        morpheus.py:218-277): keyframes every kf_every frames plus the last
        frame; each frame's nearest keyframe."""
        import cv2

        from ..guidance import zero123 as z123
        ds = self.dataset
        kf = np.arange(0, ds.num_frames, self.config["train"]["kf_every"])
        if (ds.num_frames - 1) not in kf:
            kf = np.concatenate([kf, [ds.num_frames - 1]])
        gsz = guidance.spec.image_size
        imgs = []
        for i in kf:
            m = (ds.masks[i] > 0.5).astype(np.float32)
            masked = ds.images[i] * m[..., None] + (1.0 - m[..., None])
            imgs.append(cv2.resize(masked, (gsz, gsz),
                                   interpolation=cv2.INTER_AREA
                                   ).astype(np.float32))
        imgs = torch.as_tensor(np.stack(imgs).transpose(0, 3, 1, 2).copy(),
                               device=self.device)
        c_crossattn = torch.cat([z123.clip_image_embed(guidance, imgs[k:k + 1])
                                 for k in range(len(kf))], 0)
        c_concat = torch.cat([z123.vae_encode_mode(guidance, imgs[k:k + 1])
                              for k in range(len(kf))], 0)
        nearest = np.argmin(np.abs(kf[None, :]
                                   - np.arange(ds.num_frames)[:, None]), 1)

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)
        return {
            "kf": dev(kf, torch.long),
            "nearest_kf": dev(nearest, torch.long),   # frame -> kf slot
            "c_crossattn": c_crossattn,               # (K, 1, context)
            "c_concat": c_concat,                     # (K, 4, h, w)
            "ref_polars": dev(np.asarray(ds.theta, np.float32)[kf]),
            "ref_azimuths": dev(np.asarray(ds.phi, np.float32)[kf]),
            "ref_radii": dev(np.asarray(ds.radius, np.float32)[kf]),
        }

    def _novel_view_scale(self) -> float:
        d = self.config["data"]
        return (d["novel_view_scale_final"] if self.epoch > 800
                else d["novel_view_scale"])

    def virtual_sampler(self, scale: float) -> data_lib.VirtualViewSampler:
        if scale not in self._samplers:
            self._samplers[scale] = data_lib.VirtualViewSampler(
                self.dataset, self.config, scale, self.device)
        return self._samplers[scale]

    def _virtual_loss(self, occ, draws, epoch, max_level, sampler):
        """Virtual-view SDS loss of a random view of `sampler` (reference
        train_step(real_view=False), morpheus.py:1147-1236)."""
        if self.curr.progressive_view:
            th, ph = self.curr.view_ranges(epoch)
            batch = sampler.sample(draws=draws, theta_range=th, phi_range=ph)
        else:
            batch = sampler.sample(draws=draws)
        return self.virtual_loss_from_batch(occ, draws, epoch, max_level,
                                            batch, sampler.H, sampler.W)

    def virtual_loss_from_batch(self, occ, draws, epoch, max_level, batch,
                                H, W):
        """SDS loss of one explicit virtual view (H*W rays and the view's
        offsets from its frame), (loss, out) (get_virtual_view_loss,
        morpheus.py:1044-1088). Draws: 'shade', 'ambient', 'bg_virtual',
        'bg_select' (with a background net), the render's, 'kf_pick', and
        sds_loss's."""
        from ..guidance import zero123 as z123
        from ..guidance.resize import resize
        cfg = self.config
        tr, gd = cfg["train"], cfg["guidance"]
        g, emb = self.guidance, self.embeddings
        N = H * W

        # shading (morpheus.py:864-887): albedo in the first epochs, then
        # textureless with probability textureless_ratio, else lambertian
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

        # background (morpheus.py:889-903): one random color or the net's
        rand_bg = draws.uniform("bg_virtual", (3,)).expand(N, 3)
        if cfg["model"]["bg_radius"] > 0:
            net_bg = self.step_field.background(batch["rays_d"],
                                                batch["rays_t"], max_level)
            use_net = draws.uniform("bg_select", ()) > 0.5
            bg_color = torch.where(use_net, net_bg, rand_bg)
        else:
            bg_color = rand_bg

        def render(draws_, bg_color_, ambient_):
            return renderer.render_rays(
                self.step_field, occ, draws_, batch["rays_o"],
                batch["rays_d"], batch["rays_t"], batch["rays_id"],
                self.rcfg, bg_color=bg_color_, ambient_ratio=ambient_,
                shading_id=shading_id, real_view=False, optimize_pose=False,
                max_level=max_level, train=True)

        remat = cfg["tpu"].get("remat_virtual", True)
        with trace.span("sds.render"):
            if remat:
                # recompute the render in the backward instead of keeping
                # its activations (exact: the recomputation replays the
                # draws; the span is the first pass's alone)
                rec = RecordedDraws(draws)
                out = torch.utils.checkpoint.checkpoint(
                    lambda b, am: render(rec.start(), b, am), bg_color,
                    ambient, use_reentrant=False)
            else:
                out = render(draws, bg_color, ambient)
        trace.fill("sds", out["mask"])

        pred = torch.clamp(out["image"].reshape(1, H, W, 3), 0.0, 1.0)
        gsz = g.spec.image_size
        pred256 = resize(pred.permute(0, 3, 1, 2), (gsz, gsz), "bilinear")

        # keyframe: the frame's nearest, or the first ('cur_or_one',
        # morpheus.py:1044-1079)
        f = batch["frame_idx"]
        f = (f.reshape(1).long() if isinstance(f, torch.Tensor)
             else torch.tensor([int(f)], device=self.device))
        slot_near = emb["nearest_kf"].index_select(0, f)
        use_cur = draws.uniform("kf_pick", ()) > 0.5
        slot = torch.where(use_cur, slot_near, 0)

        def ref(name, s):
            return emb[name].index_select(0, s)[0]

        def dev(x):
            return torch.as_tensor(x, device=self.device).reshape(-1)[0]

        # the view's offsets from the chosen keyframe's view
        polar_t = dev(batch["polar"]) + ref("ref_polars", slot_near)
        azim_t = dev(batch["azimuth"]) + ref("ref_azimuths", slot_near)
        rad_t = dev(batch["radius"]) + ref("ref_radii", slot_near)
        polar_k = polar_t - ref("ref_polars", slot)
        azim_k = azim_t - ref("ref_azimuths", slot)
        azim_k = torch.where(azim_k > 180.0, azim_k - 360.0, azim_k)
        rad_k = rad_t - ref("ref_radii", slot)
        gs = z123.angle_grad_scale(
            polar_k, azim_k, rad_k, ref("ref_polars", slot),
            ref("ref_azimuths", slot), ref("ref_radii", slot),
            gd["zero123_grad_weight"])
        min_step, max_step = self.curr.sds_steps(epoch)
        loss_sds, diag = z123.sds_loss(
            g, draws, pred256, emb["c_crossattn"].index_select(0, slot),
            emb["c_concat"].index_select(0, slot), polar_k, azim_k, rad_k,
            min_step, max_step, guidance_scale=gd["zero123_guidance_scale"],
            grad_scale=gs, remat=remat)
        if cfg["exp"]["save_guidance"]:
            out["sds_diag"] = dict(diag, pred_rgb=pred256.detach())

        ori_w, rgb_w, beta_w = self.curr.loss_weights(epoch)
        loss = loss_sds + self._reg_loss(out, ori_w, beta_w)
        if tr["normal_smooth_2d"] > 0 and "normal_image" in out:
            ni = out["normal_image"].reshape(H, W, 3)
            loss = loss + tr["normal_smooth_2d"] * (
                ((ni[1:] - ni[:-1]) ** 2).mean()
                + ((ni[:, 1:] - ni[:, :-1]) ** 2).mean())
        return loss, out

    def save_guidance_panels(self, diag: dict, step: int) -> str:
        """Write the render | noised | denoised | |grad| panel of a virtual
        step to guidance/{step:06d}_zero123_{t}.png (morpheus.py:1221-1225,
        zero123_utils.py:215-231); returns the path."""
        import cv2

        from ..guidance import zero123 as z123
        panel = z123.guidance_panels(self.guidance, diag["pred_rgb"], diag)
        t_val = int(diag["t"][0])
        img = panel[0].permute(1, 2, 0).float().cpu().numpy()
        path = os.path.join(self.workspace, "guidance",
                            f"{step:06d}_zero123_{t_val}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, cv2.cvtColor(
            (np.clip(img, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        return path

    # ---- steps ----

    def real_step(self, epoch, batch=None, bg_color=None) -> torch.Tensor:
        """One real-view optimizer step, on a fresh batch or on `batch` and
        `bg_color`; returns the loss (on the device; of the global batch
        under a process group, whose gradients are summed over the ranks
        before the carried virtual-step gradients, already reduced, are
        added). Under a process group a fresh batch is this rank's rows of
        the next host batch (_next_rows), staged into the batch buffers."""
        if self.dp.active and batch is None:
            self._stage(self._next_rows())
        draws = self.draws
        t_occ = draws.uniform("t_occ", ())
        self._refresh_occ(self.global_step, t_occ, draws)
        c = self.curr
        loss = self._real_update(draws, c.learning_rate(epoch),
                                 c.max_level(epoch), c.loss_weights(epoch),
                                 self._pending_live, batch, bg_color)
        self._pending_live = False
        self.global_step += 1
        return loss

    def _real_update(self, draws, lr, max_level, weights, fold: bool,
                     batch=None, bg_color=None) -> torch.Tensor:
        """A real step after its occupancy refresh: the batch (drawn unless
        given), the loss, its gradients, the fold of the carried
        virtual-step gradients when `fold` (trainer.py:416-418 of the JAX
        package; a non-finite sum skips the update and the carried
        gradients are dropped all the same) and the optimizer update at
        `lr`. The curriculum's values are host floats or device scalars."""
        with trace.span("real.render"):
            if batch is None:
                batch, bg_color = self._real_batch(draws)
            loss, _ = self.real_loss_from_batch(self.occ, draws, None,
                                                max_level, batch, bg_color,
                                                weights)
        with trace.span("real.backward"):
            grads, loss = self.dp.reduce_grads(self._grads(loss), loss,
                                               mean=False)
        with trace.span("real.update"):
            if fold:
                torch._foreach_add_(grads, self.pending)
                torch._foreach_zero_(self.pending)
            self.optim.update(grads, lr)
        return loss.detach()

    def _real_body(self) -> torch.Tensor:
        """What a graph of the chained real step holds: _real_update with
        the curriculum's device scalars (self.scalars) and the carried
        gradients always added, as the JAX step adds them (zeros when none
        were carried: a gradient's -0 then becomes +0, and nothing else
        changes)."""
        s = self.scalars
        return self._real_update(self.draws, s.lr, s.max_level,
                                 s.loss_weights, True)

    def chained_real_step(self, epoch) -> torch.Tensor:
        """One real step of the epoch loop under tpu.chain_steps: draw
        t_occ, refresh the occupancy grid if this step is due (eagerly, in
        place), under a process group stage this rank's rows of the next
        host batch (_next_rows), then the body (_real_body) at
        `epoch`: on a card a replay of the graph of this active-level
        count, captured at its first step, which runs the body eagerly on
        a side stream as its warm-up; on the CPU and under gloo the body,
        eagerly. Returns the loss; a replay's is the graph's buffer, which
        the next replay overwrites, so a caller that keeps it clones it."""
        draws = self.draws
        t_occ = draws.uniform("t_occ", ())
        self._refresh_occ(self.global_step, t_occ, draws)
        if self.dp.active:
            self._stage(self._next_rows())
        self.scalars.set(epoch)
        loss = self._replay() if self.graphed else self._real_body()
        self._pending_live = False
        self.global_step += 1
        return loss

    def _replay(self) -> torch.Tensor:
        """The body by this active-level count's graph. A graph of another
        count, or one captured against another spec or occupancy state, is
        dropped first (the run has moved past it: trainer.py:827-848 of the
        JAX package); a missing one is captured after the warm-up step,
        whose loss is then returned."""
        al = self._active_levels()
        for k in [k for k, g in self._graphs.items()
                  if k != al or not g.fits(self)]:
            del self._graphs[k]
        if al in self._graphs:
            return self._graphs[al].replay()
        loss, self._graphs[al] = self._capture()
        return loss

    def _capture(self):
        """(the warm-up step's loss, its _StepGraph): the body once,
        eagerly, on a side stream (it loads the kernels and fills every
        cached constant: a copy from host memory cannot be captured), then
        the capture of the body, which runs nothing. A failed capture
        raises."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            loss = self._real_body()
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        warmup_s = time.perf_counter() - t0
        graph = _StepGraph(self)
        self.captures.append({
            "active_levels": self._active_levels(), "warmup_s": warmup_s,
            "capture_s": graph.capture_s, "pool_mb": graph.pool_mb,
            "launches": dict(zip((f.__name__ for f in KERNEL_WRAPPERS),
                                 graph.recorded)),
            "all_reduces": graph.all_reduces,
            "all_reduce_bytes": graph.all_reduce_bytes,
            "phases": graph.phases, "device_nodes": graph.device_nodes})
        return loss, graph

    def _grads(self, loss):
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(self.params, grads)]

    def virtual_step(self, epoch, sampler) -> tuple[torch.Tensor, dict]:
        """One SDS virtual step on a view of `sampler`; returns (loss on the
        device, the guidance panels' inputs or {}). The gradients are
        divided by virtual_freq and zeroed if any is non-finite; while the
        deform freeze is on they step the optimizer at once with
        FREEZE_GROUPS at
        rate 0 (and the carried gradients are cleared), after it they are
        added to the carried gradients (trainer.py:625-672 of the JAX
        package). Under a process group each rank renders its own view
        (sharding.ViewDraws) and the loss and the gradients are the mean
        over the views (sharding.py:142-238 of the JAX package)."""
        draws = self.draws
        lr = self.curr.learning_rate(epoch)
        max_level = self.curr.max_level(epoch)
        t_occ = draws.uniform("t_occ", ())
        self._refresh_occ(self.global_step, t_occ, draws)
        loss, out = self._virtual_loss(self.occ, self.dp.view_draws(draws),
                                       epoch, max_level, sampler)
        with trace.span("sds.grads"):
            grads, loss = self.dp.reduce_grads(self._grads(loss), loss,
                                               mean=True)
        with trace.span("sds.update"):
            torch._foreach_div_(grads,
                                float(self.config["train"]["virtual_freq"]))
            found = torch.zeros((), device=self.device)
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found, torch.ones_like(found))
            ok = found == 0.0
            # the GradScaler-parity skip: a non-finite SDS gradient neither
            # steps the optimizer nor enters the carry
            grads = [torch.where(ok, g, 0.0) for g in grads]
            if self.curr.freeze_deform(epoch):
                self.optim.update(grads, lr, frozen=optim.FREEZE_GROUPS,
                                  ok=ok)
                torch._foreach_zero_(self.pending)
                self._pending_live = False
            else:
                torch._foreach_add_(self.pending, grads)
                self._pending_live = True
        self.global_step += 1
        return loss.detach(), out.get("sds_diag", {})

    def train_one_epoch(self, n_iters: int | None = None) -> float:
        """n_iters x (virtual_freq virtual slots + real_freq real steps),
        then the EMA (trainer.py:850-907 of the JAX package, and its
        data-parallel twin _train_one_epoch_dp, :740-848: the same slots,
        with rank 0's guidance panels alone). A virtual slot
        runs an SDS step when there is guidance and the host step has
        passed warm_up_steps, a real step otherwise, as the reference's
        does. Under tpu.chain_steps every real step is chained_real_step
        (its graph replayed on a card), else real_step; under a process
        group the chained real_freq steps' host batches are drawn together
        before them, as the JAX package's scan takes them."""
        tr, exp = self.config["train"], self.config["exp"]
        n_iters = n_iters or tr.get("n_iters", 10)
        self._set_levels(self._active_levels())
        sampler = (self.virtual_sampler(self._novel_view_scale())
                   if self.guidance is not None else None)
        real_step = self.chained_real_step if self.chain else self.real_step
        loss = torch.tensor(float("nan"))
        for _ in range(n_iters):
            for _ in range(tr["virtual_freq"]):
                if sampler is not None \
                        and self.host_step >= tr["warm_up_steps"]:
                    loss, diag = self.virtual_step(self.epoch, sampler)
                    if (exp["save_guidance"] and diag and self.workspace
                            and self.dp.rank == 0
                            and self.host_step % exp["save_guide_intervel"]
                            == 0):
                        self.save_guidance_panels(diag, self.host_step)
                else:
                    loss = real_step(self.epoch)
                self.host_step += 1
            if self.chain and self.dp.active:
                self._drawn = self._host_block(tr["real_freq"])
            for _ in range(tr["real_freq"]):
                loss = real_step(self.epoch)
                self.host_step += 1
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
        parameters, the optimizer's name, step and per-parameter state (its
        SLOTS), the EMA, the occupancy grid,
        the carried virtual-step gradients, the step, host-step and epoch
        counters and the state of the random draws."""
        def arrays(ts):
            return {n: t.detach().cpu().numpy()
                    for n, t in zip(self.optim.names, ts)}
        draws = (self.draws.generator.get_state().numpy()
                 if isinstance(self.draws, Draws) else None)
        return {
            "params": arrays(self.params),
            "optim": {"name": self.optim.name,
                      "step": float(self.optim.step),
                      **{k: arrays(getattr(self.optim, k))
                         for k in self.optim.SLOTS}},
            "ema": arrays(self.ema),
            "occ": {"occs": self.occ.occs.cpu().numpy(),
                    "binaries": self.occ.binaries.cpu().numpy()},
            "global_step": int(self.global_step),
            "epoch": int(self.epoch),
            "draws": draws,
            "host_step": int(self.host_step),
            "pending_grads": arrays(self.pending),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a state_dict() (or convert.load_jax_ckpt's dict, which
        has no draws state) in place: every tensor keeps its address. The
        graphs of the step are dropped (the draws' state is replaced)."""
        self._graphs.clear()
        if state["optim"]["name"] != self.optim.name:
            raise ValueError(
                f"a checkpoint of optimizer {state['optim']['name']!r} into "
                f"a trainer of {self.optim.name!r} (train.optim)")

        def load(dst, src):
            with torch.no_grad():
                for n, t in zip(self.optim.names, dst):
                    t.copy_(torch.as_tensor(np.asarray(src[n])))
        load(self.params, state["params"])
        for k in self.optim.SLOTS:
            load(getattr(self.optim, k), state["optim"][k])
        load(self.ema, state["ema"])
        pending = state.get("pending_grads")
        if pending is None:
            torch._foreach_zero_(self.pending)
        else:
            load(self.pending, pending)
        self._pending_live = pending is not None and any(
            np.any(np.asarray(pending[n])) for n in self.optim.names)
        self.optim.step.fill_(float(state["optim"]["step"]))
        self.occ.occs.copy_(torch.as_tensor(np.asarray(state["occ"]["occs"])))
        self.occ.binaries.copy_(torch.as_tensor(
            np.asarray(state["occ"]["binaries"])))
        self.global_step = int(state["global_step"])
        self.host_step = int(state.get("host_step", self.global_step))
        self.epoch = int(state["epoch"])
        if state.get("draws") is not None and isinstance(self.draws, Draws):
            self.draws.generator.set_state(
                torch.as_tensor(np.asarray(state["draws"])))

    def save_ckpt(self, path: str) -> None:
        """Write state_dict() to `path` atomically (a .tmp file, then
        os.replace), as morpheus_tpu/train/trainer.py:921-934 does; under a
        process group rank 0 writes and every rank waits for it."""
        if self.dp.rank == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(self.state_dict(), f)
            os.replace(tmp, path)
        self.dp.barrier()

    def load_ckpt(self, path: str) -> None:
        """Resume from a checkpoint that save_ckpt wrote."""
        with open(path, "rb") as f:
            self.load_state_dict(pickle.load(f))
