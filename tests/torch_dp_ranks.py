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
    each selection keeps on this rank, its members alone (a selection
    under a process group has a fixed size, padding after its members):
    the compaction's (global ray * K + sample) and each _subset_sel's, by
    draw name. Returns (loss, {name: sorted global positions})."""
    seen = {}
    split, subset = sharding.Rows.split_sorted, renderer._subset_sel

    def members(x, rows):
        m = rows.members()
        return x if m is None else x[m]

    def rec_split(rows, perm, k):
        local, run = split(rows, perm, k)
        a = rows.index.start * k if rows.red.active else 0
        seen.setdefault("compaction", []).append(members(local + a, run))
        return local, run

    def rec_subset(d, name, mask, budget, rows):
        local, sel_rows, m = subset(d, name, mask, budget, rows)
        if local is not None:
            seen.setdefault(name, []).append(members(
                rows.global_index(mask.device)[local], sel_rows))
        return local, sel_rows, m

    sharding.Rows.split_sorted, renderer._subset_sel = rec_split, rec_subset
    try:
        loss = _rows_loss(tr, draws, batch, bg, occ, epoch)
    finally:
        sharding.Rows.split_sorted, renderer._subset_sel = split, subset
    return loss.item(), {k: np.sort(torch.cat(v).numpy())
                         for k, v in seen.items()}


def _rows_loss(tr, draws, batch, bg, occ, epoch):
    """The real-view loss of `tr` on this rank's rows of the global batch
    (numpy arrays), the replayed draws and the occupancy values `occ`."""
    rows = sharding.shard_batch_stacked(
        {k: v[None] for k, v in dict(batch, bg=bg).items()}, tr.dp.rank,
        tr.dp.world)
    t = {k: torch.as_tensor(v[0]) for k, v in rows.items()}
    t["rays_id"] = t["rays_id"].long()
    R = tr.config["tpu"]["occ_resolution"]
    state = occupancy.OccupancyState(
        occs=torch.as_tensor(np.array(occ)),
        binaries=torch.as_tensor(occ > 0.01).reshape(R, R, R))
    loss, _ = tr.real_loss_from_batch(
        state, ReplayDraws(draws), epoch, float(tr.curr.max_level(epoch)),
        t, t.pop("bg"))
    return loss


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


# ---- the chained data-parallel step (tests/test_torch_dp_chain.py) ----

class StepDraws(ReplayDraws):
    """ReplayDraws of one step after another: each step's arrays from its
    first draw, t_occ, on."""

    def __init__(self, steps):
        super().__init__({})
        self.steps = list(steps)

    def _get(self, name, shape):
        if name == "t_occ":
            self.arrays = self.steps.pop(0)
        return super()._get(name, shape)


def chained_epoch(red, device, cfg, params, draws, epoch, out):
    """One epoch of len(draws) chained data-parallel real steps from
    `params` (tpu.chain_steps on), step i on the replayed global draws
    draws[i]: the last loss, the occupancy values, the parameters, the
    global step, the numpy generator's state, how many steps ran through
    chained_real_step and whether the replicas agree."""
    torch.set_num_threads(1)
    tr = _trainer(red, device, cfg, params)
    tr.draws = StepDraws(draws)
    tr.epoch = epoch
    chained = []
    step = tr.chained_real_step
    tr.chained_real_step = lambda *a, **k: chained.append(1) or step(*a, **k)
    loss = tr.train_one_epoch()
    _write(red, out, {"loss": loss, "occs": tr.occ.occs.numpy().copy(),
                      "params": {k: v.numpy() for k, v in
                                 tr.field.state_dict().items()},
                      "global_step": tr.global_step, "chained": len(chained),
                      "np_state": tr._np_rng.bit_generator.state,
                      "equal": sharding.replicas_equal(tr)})


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def chain_and_eager(red, device, cfg, epochs, out):
    """Two trainers of cfg from its seed, tpu.chain_steps on and off, each
    through `epochs`: which of their state tensors (parameters, EMA,
    occupancy, optimizer step and slots, carried gradients), losses,
    global steps and numpy generator states agree bit for bit, and
    whether each trainer's replicas agree."""
    torch.set_num_threads(1)
    runs = []
    for chain in (True, False):
        cfg_c = dict(cfg, tpu=dict(cfg["tpu"], chain_steps=chain))
        tr = _trainer(red, device, cfg_c)
        losses = []
        for epoch in epochs:
            tr.epoch = epoch
            losses.append(tr.train_one_epoch())
        runs.append((tr, losses))
    (a, la), (b, lb) = runs
    pairs = {"params": (a.params, b.params), "ema": (a.ema, b.ema),
             "occ": ([a.occ.occs, a.occ.binaries],
                     [b.occ.occs, b.occ.binaries]),
             "step": ([a.optim.step], [b.optim.step]),
             "pending": (a.pending, b.pending)}
    pairs.update({k: (getattr(a.optim, k), getattr(b.optim, k))
                  for k in a.optim.SLOTS})
    same = {k: all(torch.equal(_bits(x), _bits(y)) for x, y in zip(xs, ys))
            for k, (xs, ys) in pairs.items()}
    same.update(losses=la == lb, global_step=a.global_step == b.global_step,
                np_state=(a._np_rng.bit_generator.state
                          == b._np_rng.bit_generator.state))
    _write(red, out, {"same": same, "chain": [a.chain, b.chain],
                      "graphed": a.graphed, "global_step": a.global_step,
                      "equal": [sharding.replicas_equal(t) for t in (a, b)]})


def padding(red, device, cfg, params, draws, batch, bg, occ, epoch, out):
    """This rank's padded selections on one real-view loss: for each
    selection (the compaction, then each _subset_sel by draw name), its
    capacity, its count of members and whether the members come first;
    the compaction's padding inert (not valid, t 0, past every segment, no
    ray's slot), each subset's mask false at padding. Then the loss and
    its gradients again with every padding entry repeating another real
    entry: whether the two agree exactly and are finite."""
    from morpheus_tpu_torch.ops import volrender
    torch.set_num_threads(1)
    tr = _trainer(red, device, cfg, params)
    N = tr.config["train"]["real_ray_num"] // red.world
    K = tr.config["tpu"]["max_samples_per_ray"]
    seen, redirect = {}, [False]
    compact, subset = occupancy.compact_samples, renderer._subset_sel
    split = sharding.Rows.split_sorted

    def layout(m):
        count = int(m.sum())
        return {"cap": m.shape[0], "count": count,
                "members_first": bool(m[:count].all() and not m[count:].any())}

    def rec_split(rows, perm, k):
        local, run = split(rows, perm, k)
        if redirect[0]:
            local = torch.where(run.members(), local, 0)
        return local, run

    def rec_compact(*a, **kw):
        cs = compact(*a, **kw)
        m = cs["rows"].members()
        seg = volrender.Segments(cs["ray_id"], cs["starts"], K, padded=True)
        seen["compaction"] = dict(layout(m), inert=bool(
            not cs["valid"][~m].any() and not cs["t_starts"][~m].any()
            and not cs["t_ends"][~m].any()
            and int(cs["starts"][N]) == int(m.sum())
            and (seg.slot[~m] == N * K).all()
            and (seg.slot[m] < N * K).all()))
        return cs

    def rec_subset(d, name, mask, budget, rows):
        sel, sel_rows, m = subset(d, name, mask, budget, rows)
        if sel is not None:
            member = sel_rows.members()
            seen[name] = dict(layout(member), inert=not m[~member].any())
            if redirect[0]:
                sel = torch.where(member, sel, mask.shape[0] - 1)
        return sel, sel_rows, m

    occupancy.compact_samples, renderer._subset_sel = rec_compact, rec_subset
    sharding.Rows.split_sorted = rec_split
    results = []
    try:
        for r in (False, True):
            redirect[0] = r
            loss = _rows_loss(tr, draws, batch, bg, occ, epoch)
            grads = torch.autograd.grad(loss, tr.params, allow_unused=True)
            results.append((loss.detach(), [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(tr.params, grads)]))
    finally:
        occupancy.compact_samples, renderer._subset_sel = compact, subset
        sharding.Rows.split_sorted = split
    (l0, g0), (l1, g1) = results
    _write(red, out, {
        "selections": seen, "loss": float(l0),
        "same_loss": bool(torch.equal(l0, l1)),
        "same_grads": all(torch.equal(a, b) for a, b in zip(g0, g1)),
        "finite": bool(torch.isfinite(l0)) and all(
            bool(torch.isfinite(g).all()) for g in g0 + g1)})


class HostRead(RuntimeError):
    pass


# what reads a tensor back to the host: at the dispatcher (a tensor's
# value as a Python number, an output sized by the data) and at the Python
# API (tolist and numpy dispatch nothing on the CPU); and what makes a
# tensor of a numpy array, a step's host data (a kernel's plain twin makes
# its constants of Python ints, which on a card are kernel arguments)
HOST_OPS = ("aten::nonzero", "aten::_local_scalar_dense",
            "aten::masked_select")
HOST_CALLS = ("tolist", "item", "numpy")
HOST_MAKERS = ("as_tensor", "tensor", "from_numpy")


class NoHostRead:
    """A context in which an op that reads a tensor back to the host,
    makes one of a numpy array or copies one across devices raises
    HostRead: the CPU's stand-in for "a CUDA graph can capture this"."""

    def __enter__(self):
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode

        class Calls(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                name = getattr(func, "__name__", None)
                if name in HOST_CALLS or (
                        name in HOST_MAKERS
                        and isinstance(args[0], np.ndarray)):
                    raise HostRead(name)
                return func(*args, **(kwargs or {}))

        class Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func._schema.name
                if name in HOST_OPS:
                    raise HostRead(name)
                if name in ("aten::index", "aten::index_put_") and any(
                        isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in args[1]):
                    raise HostRead(f"{name} by a mask")
                if name in ("aten::_to_copy", "aten::copy_"):
                    devs = {a.device for a in list(args)
                            + list((kwargs or {}).values())
                            if isinstance(a, torch.Tensor)}
                    dev = (kwargs or {}).get("device")
                    if len(devs | ({dev} if dev is not None else set())) > 1:
                        raise HostRead(f"{name} across {devs | {dev}}")
                return func(*args, **(kwargs or {}))

        self.modes = [Calls(), Ops()]
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)


def catches(x: torch.Tensor) -> list:
    """Which of the host reads NoHostRead is to refuse it refuses on x."""
    caught = []
    for name, fn in (("nonzero", lambda: torch.nonzero(x)),
                     ("item", lambda: x[0].item()),
                     ("tolist", lambda: x.tolist()),
                     ("int", lambda: int(x[0])),
                     ("masked_select", lambda: torch.masked_select(x, x > 0)),
                     ("mask_index", lambda: x[x > 0]),
                     ("as_tensor", lambda: torch.as_tensor(np.ones(2)))):
        try:
            with NoHostRead():
                fn()
        except HostRead:
            caught.append(name)
    return caught


def body_reads_nothing_back(red, device, cfg, epoch, out):
    """One chained data-parallel step (the capture's warm-up), then this
    rank's next batch staged and the step's body (Trainer._real_body: the
    graph's contents) under NoHostRead; its loss, the host reads
    NoHostRead catches, whether the replicas agree."""
    torch.set_num_threads(1)
    tr = _trainer(red, device, cfg)
    tr.epoch = epoch
    tr._set_levels(tr._active_levels())
    tr.chained_real_step(epoch)
    tr._stage(tr._host_block(1)[0])
    with NoHostRead():
        loss = tr._real_body()
    tr.global_step += 1
    _write(red, out, {"loss": float(loss), "equal":
                      sharding.replicas_equal(tr),
                      "catches": catches(torch.arange(3.0))})
