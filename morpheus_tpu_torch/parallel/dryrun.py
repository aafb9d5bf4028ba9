"""Data-parallel dry run on the CPU (port of __graft_entry__.dryrun_multichip
and _dryrun_multichip_impl):

    python -m morpheus_tpu_torch.parallel.dryrun N

N gloo ranks train a tiny synthetic scene: one data-parallel real step
(finite loss, the occupancy grid updated by its warm-up refresh), steps
until the occupancy cadence refreshes the grid again, then one
data-parallel virtual (SDS) step with a tiny random Zero123; the state is
checked equal on every rank, and rank 0 prints the JAX copy's
`dryrun_multichip(N): real_loss=... virtual_loss=... OK` line.
"""
from __future__ import annotations

import sys

import torch

from . import sharding

RAYS_PER_RANK = 16


def tiny_config(world: int) -> dict:
    """__graft_entry__._tiny_config at RAYS_PER_RANK rays a rank, 4
    frames of 16x16, tpu.data_parallel = world; a virtual view at half
    scale (8x8)."""
    from ..config import merge_defaults
    return merge_defaults({
        "data": {"data_dir": "<synthetic>", "synthetic_frames": 4,
                 "synthetic_res": 16, "novel_view_scale": 0.5},
        "exp": {"seed": 0},
        "train": {"real_ray_num": RAYS_PER_RANK * world,
                  "normal_smoothness": 0.0, "normal_smooth_3d": 0.0},
        "model": {"bg_radius": 0.0, "grid_num_levels": 4,
                  "grid_log2_hashmap_size": 10,
                  "grid_desired_resolution": 32},
        "render": {"step_size": 0.04},
        "tpu": {"max_samples_per_ray": 16, "march_steps": 64,
                "occ_resolution": 16, "occ_warmup_steps": 4,
                "occ_update_every": 4, "data_parallel": world},
    })


def _rank(red, device, world):
    import dataclasses

    from ..data.dataset import load_synthetic
    from ..guidance.zero123 import TINY_SPEC, Zero123Guidance
    from ..train.trainer import Trainer

    torch.set_num_threads(1)
    cfg = tiny_config(world)
    spec = dataclasses.replace(TINY_SPEC, image_size=32)
    guidance = Zero123Guidance.init_random(spec, device, seed=7)
    if not red.agree(sharding.digest(guidance.state_dict())):
        raise AssertionError("the ranks' random Zero123 weights differ")
    trainer = Trainer(cfg, load_synthetic(cfg), device=device,
                      guidance=guidance, reducer=red)
    epoch = 1

    occ0 = trainer.occ.occs.clone()
    loss = trainer.real_step(epoch)
    if not torch.isfinite(loss):
        raise AssertionError(f"data-parallel real step: loss {loss}")
    if torch.equal(trainer.occ.occs, occ0):
        raise AssertionError("the data-parallel step did not update the "
                             "occupancy grid")
    # again once global_step crosses tpu.occ_update_every: the cadence,
    # not just the step-0 warm-up refresh
    every = cfg["tpu"]["occ_update_every"]
    while trainer.global_step % every != 0:
        loss = trainer.real_step(epoch)
    occ_pre = trainer.occ.occs.clone()
    loss = trainer.real_step(epoch)
    if torch.equal(trainer.occ.occs, occ_pre):
        raise AssertionError("the data-parallel step did not refresh the "
                             "occupancy grid at its cadence")

    sampler = trainer.virtual_sampler(cfg["data"]["novel_view_scale"])
    vloss, _ = trainer.virtual_step(epoch, sampler)
    if not torch.isfinite(vloss):
        raise AssertionError(f"data-parallel virtual step: loss {vloss}")
    if not sharding.replicas_equal(trainer):
        raise AssertionError("the ranks' states differ")
    if red.rank == 0:
        print(f"dryrun_multichip({world}): real_loss={float(loss):.4f} "
              f"virtual_loss={float(vloss):.4f} OK", flush=True)


def dryrun(world: int) -> None:
    """The dry run on `world` gloo ranks of the CPU."""
    sharding.launch(_rank, world, "cpu", args=(world,))


if __name__ == "__main__":
    dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
