"""The ranks' side of tests/test_torch_dp.py: functions that
morpheus_tpu_torch.parallel.sharding.launch runs in spawned gloo ranks on
the CPU (importable by the children: torch and the port only, no JAX).
Each writes what it saw to <out>/rank<r>.pkl for the test to read."""
import os
import pickle

import numpy as np
import torch

from morpheus_tpu_torch import renderer
from morpheus_tpu_torch.data.dataset import load_synthetic
from morpheus_tpu_torch.ops import occupancy
from morpheus_tpu_torch.parallel import sharding
from morpheus_tpu_torch.train.trainer import Trainer


class ReplayDraws:
    """Pre-drawn arrays handed out by name (tests/torch_parity.py's, with
    no JAX import)."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def _get(self, name, shape):
        a = np.asarray(self.arrays[name])
        assert a.shape == tuple(shape), (name, a.shape, shape)
        return torch.as_tensor(np.array(a))

    def uniform(self, name, shape):
        return self._get(name, shape).float()

    def normal(self, name, shape):
        return self._get(name, shape).float()

    def randint(self, name, shape, low, high):
        return self._get(name, shape).long()


def _write(red, out, result):
    with open(os.path.join(out, f"rank{red.rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _trainer(red, device, cfg, params=None, guidance_kw=None):
    guidance = None
    if guidance_kw is not None:
        from morpheus_tpu_torch.guidance import zero123 as tz
        guidance = tz.Zero123Guidance.init_random(
            tz.Zero123Spec(**guidance_kw), device, seed=5)
        assert red.agree(sharding.digest(guidance.state_dict()))
    tr = Trainer(cfg, load_synthetic(cfg), device=device, guidance=guidance,
                 reducer=red)
    if params is not None:
        tr.load_params(params)
    return tr


def real_steps(red, device, cfg, params, draws, epoch, out):
    """len(draws) data-parallel real steps from `params`, step i on the
    replayed global draws draws[i]: losses, occupancy values, parameters
    and whether the replicas agree."""
    torch.set_num_threads(1)
    tr = _trainer(red, device, cfg, params)
    losses, occs = [], []
    for d in draws:
        tr.draws = ReplayDraws(d)
        losses.append(float(tr.real_step(epoch)))
        occs.append(tr.occ.occs.numpy().copy())
    _write(red, out, {"losses": losses, "occs": occs,
                      "params": {k: v.numpy() for k, v in
                                 tr.field.state_dict().items()},
                      "equal": sharding.replicas_equal(tr)})


def record_selections(tr, draws, batch, bg, occ, epoch):
    """One real-view loss of `tr` on this rank's rows of the global batch
    (numpy arrays) with the replayed draws, recording the global positions
    each selection keeps on this rank: the compaction's (global ray * K +
    sample) and each _subset_sel's, by draw name. Returns (loss,
    {name: sorted global positions})."""
    seen = {}
    split, subset = sharding.Rows.split_sorted, renderer._subset_sel

    def rec_split(rows, perm, k):
        local, run = split(rows, perm, k)
        a = rows.index.start * k if rows.red.active else 0
        seen.setdefault("compaction", []).append(local + a)
        return local, run

    def rec_subset(d, name, mask, budget, rows):
        local, sel_rows = subset(d, name, mask, budget, rows)
        if local is not None:
            seen.setdefault(name, []).append(
                rows.global_index(mask.device)[local])
        return local, sel_rows

    sharding.Rows.split_sorted, renderer._subset_sel = rec_split, rec_subset
    try:
        rows = sharding.shard_rows(dict(batch, bg=bg), tr.dp.rank,
                                   tr.dp.world)
        t = {k: torch.as_tensor(v) for k, v in rows.items()}
        t["rays_id"] = t["rays_id"].long()
        R = tr.config["tpu"]["occ_resolution"]
        state = occupancy.OccupancyState(
            occs=torch.as_tensor(np.array(occ)),
            binaries=torch.as_tensor(occ > 0.01).reshape(R, R, R))
        loss, _ = tr.real_loss_from_batch(
            state, ReplayDraws(draws), epoch, float(tr.curr.max_level(epoch)),
            t, t.pop("bg"))
    finally:
        sharding.Rows.split_sorted, renderer._subset_sel = split, subset
    return loss.item(), {k: np.sort(torch.cat(v).numpy())
                         for k, v in seen.items()}


def selections(red, device, cfg, params, draws, batch, bg, occ, epoch, out):
    torch.set_num_threads(1)
    tr = _trainer(red, device, cfg, params)
    _write(red, out, record_selections(tr, draws, batch, bg, occ, epoch))


def virtual_step(red, device, cfg, params, guidance_kw, epoch, out):
    """One data-parallel virtual step of seeded draws: the gradients it
    hands the optimizer (deform freeze on) or carries (off), the loss, and
    whether the replicas agree."""
    torch.set_num_threads(1)
    tr = _trainer(red, device, cfg, params, guidance_kw)
    tr.epoch = epoch
    tr._set_levels(tr._active_levels())
    applied = []
    update = tr.optim.update

    def rec_update(grads, lr, **kw):
        applied.append([g.clone().numpy() for g in grads])
        return update(grads, lr, **kw)

    tr.optim.update = rec_update
    sampler = tr.virtual_sampler(tr._novel_view_scale())
    loss, _ = tr.virtual_step(epoch, sampler)
    grads = applied[0] if applied else [p.numpy() for p in tr.pending]
    _write(red, out, {"loss": float(loss), "grads": grads,
                      "applied": bool(applied),
                      "equal": sharding.replicas_equal(tr)})


def epoch_and_resume(red, device, cfg, guidance_kw, ckpt, out):
    """A data-parallel epoch of real and virtual slots and the EMA, the
    checkpoint (how often this rank wrote it), a fresh trainer on every
    rank resumed from it, and a resumed epoch."""
    torch.set_num_threads(1)
    tr = _trainer(red, device, cfg, guidance_kw=guidance_kw)
    tr.epoch = 1
    ema0 = [e.clone() for e in tr.ema]
    loss = tr.train_one_epoch()
    writes = []
    state_dict = tr.state_dict
    tr.state_dict = lambda: writes.append(1) or state_dict()
    tr.save_ckpt(ckpt)
    del tr.state_dict
    saved = sharding.digest(tr.state_dict())
    equal = sharding.replicas_equal(tr)
    resumed = _trainer(red, device, cfg, guidance_kw=guidance_kw)
    resumed.load_ckpt(ckpt)
    loaded = sharding.digest(resumed.state_dict())
    resumed.epoch = 2
    loss2 = resumed.train_one_epoch()
    _write(red, out, {
        "loss": loss, "loss2": loss2, "writes": len(writes),
        "host_step": tr.host_step, "global_step": tr.global_step,
        "ema_moved": not all(torch.equal(a, b)
                             for a, b in zip(ema0, tr.ema)),
        "equal": equal, "loaded_equal": loaded == saved,
        "resumed_equal": sharding.replicas_equal(resumed)})
