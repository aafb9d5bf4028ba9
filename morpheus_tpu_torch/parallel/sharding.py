"""Data parallelism of one scene over the ranks of torch.distributed (port
of morpheus_tpu/parallel/sharding.py).

One process per rank, spawned (launch): NCCL for ranks on CUDA cards, one
card each; gloo on the CPU, and gloo for ranks that share one card when the
caller asks for that (launch's share_card). Every rank builds the same
trainer from the same seed (its parameters then broadcast from rank 0, in
place of replicate_state), draws the same random numbers from the same
seeded source, and so keeps the parameters, the optimizer's slots, the EMA
and the occupancy grid replicated, bit for bit (replicas_equal checks it).

- A real step (_sharded_real_body, make_sharded_real_step) splits the
  global ray batch: rank r takes its contiguous block of rows
  (shard_batch_stacked, the layout of JAX's P(None, "rays") on a stack of
  batches). Its loss is its share of the global
  batch's loss: each term's numerator over the global denominator
  (Reducer.total, Reducer.mean), the terms on the parameters alone on rank
  0 only, and each selection under a sample budget taken over the global
  batch, each rank keeping its members (Rows). The gradients are summed
  (Reducer.reduce_grads), so every rank applies the single-device step on
  the global batch.
- A virtual (SDS) step (make_sharded_virtual_step) renders one whole view
  per rank: every draw site draws the numbers of all `world` views and
  keeps its own (ViewDraws, in place of sample_virtual_batch and the
  fold_in of the device index), and the gradients and the loss are the
  mean over the views.

Every selection under a process group has a fixed size, its capacity,
and reads nothing back to the host (Rows.select, Rows.split_sorted): its
members first, then inert padding, with the count of members on the card.
So the data-parallel real step runs on a card as a replayed CUDA graph with
its all-reduces inside (train/trainer.py, tpu.chain_steps), as the JAX
package's make_sharded_real_steps_chained runs real_freq sharded steps in
one lax.scan over a stack of host batches (shard_batch_stacked). The
capacity is the exact worst case, so nothing is ever cut: the
compaction's is min(global budget, this rank's rays x K), a subset's
min(its budget, its stream's capacity). At world 1 nothing is padded; at
world W >= 2 a rank evaluates the field on up to the global budget's
entries, about 1/W of them its own.

With no process group (Reducer()) every collective is the identity and the
step is the single-device one; with a group of one rank the collectives
run and return their inputs' values.

Not ported: make_mesh and replicate_state (the process group and the
broadcast above), and the sharded mesh queries the JAX module's docstring
names (no JAX code shards them).
"""
from __future__ import annotations

import datetime
import hashlib
import socket

import numpy as np
import torch
import torch.distributed as dist

from .. import trace

# rank 0 alone exports the meshes (every frame at 256^3 at the final epoch)
# and renders the videos while the other ranks wait in the next collective
TIMEOUT = datetime.timedelta(hours=3)


class Reducer:
    """The collectives of a step over `group` (None: one process, where
    every collective is the identity)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self.backend = None if group is None else dist.get_backend(group)

    @property
    def active(self) -> bool:
        return self.group is not None

    @staticmethod
    def for_config(config: dict) -> "Reducer":
        """The reducer of a trainer of `config`: none under
        tpu.data_parallel 1, else the default process group, which must be
        up with that many ranks."""
        dp = int(config["tpu"].get("data_parallel", 1))
        if dp == 1:
            return Reducer()
        world = dist.get_world_size() if dist.is_initialized() else None
        if world != dp:
            have = ("none is up" if world is None
                    else f"the one up has {world}")
            raise RuntimeError(
                f"tpu.data_parallel={dp} needs a process group of {dp} "
                f"ranks and {have}: start them with `python -m "
                f"morpheus_tpu_torch ... tpu --data_parallel {dp}` or "
                "morpheus_tpu_torch.parallel.sharding.launch")
        return Reducer(dist.group.WORLD)

    def all_reduce(self, x: torch.Tensor) -> None:
        """x summed over the ranks, in place, counted on the host
        (trace.py's dp.all_reduces and dp.all_reduce_bytes)."""
        trace.count("dp.all_reduces")
        trace.count("dp.all_reduce_bytes", x.numel() * x.element_size())
        dist.all_reduce(x, group=self.group)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x, a count that carries no gradient."""
        if not self.active:
            return x
        x = x.detach().clone()
        self.all_reduce(x)
        return x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the mean over the global batch, of which x
        holds this rank's equal part."""
        return x.sum() / (x.numel() * self.world)

    def reduce_grads(self, grads: list, loss: torch.Tensor, mean: bool):
        """(gradients, loss) summed over the ranks (mean: averaged), in one
        all-reduce of a flat bucket."""
        if not self.active:
            return grads, loss
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().reshape(1).float()])
        self.all_reduce(flat)
        if mean:
            flat /= self.world
        parts = flat.split([g.numel() for g in grads] + [1])
        return ([p.view_as(g).to(g.dtype) for p, g in zip(parts, grads)],
                parts[-1].reshape(()))

    def broadcast(self, tensors: list) -> None:
        """Rank 0's values of `tensors`, in place on every rank."""
        if self.active:
            with torch.no_grad():
                for t in tensors:
                    dist.broadcast(t, 0, group=self.group)

    def barrier(self) -> None:
        if self.active:
            dist.barrier(group=self.group)

    def agree(self, text: str) -> bool:
        """Whether every rank passed the same text (a digest)."""
        if not self.active:
            return True
        out = [None] * self.world
        dist.all_gather_object(out, text, group=self.group)
        return len(set(out)) == 1

    def rows(self, n: int) -> "Rows":
        """This rank's n rows of the global batch of n*world."""
        start = self.rank * n
        return Rows(self, n * self.world, slice(start, start + n))

    def view_draws(self, draws):
        """The draws of this rank's view of a virtual step."""
        return ViewDraws(draws, self.rank, self.world) if self.active \
            else draws


# one process: every collective is the identity
LOCAL = Reducer()


class Rows:
    """This rank's entries of a 1-D index space of `total` entries spread
    over the ranks: their global positions `index` (a slice, or a long
    tensor), in this rank's order. Without a process group the rank holds
    every entry in order. A selection's Rows (select, split_sorted) is
    `padded`: it has a fixed size, its members first, then padding at
    global position `total`, a slot that gather drops."""

    def __init__(self, red: Reducer, total: int, index,
                 padded: bool = False):
        self.red, self.total, self.index = red, int(total), index
        self.padded = padded

    def __len__(self) -> int:
        if isinstance(self.index, slice):
            return self.index.stop - self.index.start
        return self.index.shape[0]

    def global_index(self, device) -> torch.Tensor:
        if isinstance(self.index, slice):
            return torch.arange(self.index.start, self.index.stop,
                                device=device)
        return self.index

    def members(self):
        """Which entries are members, a bool tensor (None: all are)."""
        return self.index < self.total if self.padded else None

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (total, ...) array (at padding a
        copy of its last row)."""
        if isinstance(self.index, slice):
            return full[self.index]
        i = self.index.clamp(max=self.total - 1) if self.padded \
            else self.index
        return full.index_select(0, i)

    def draws(self, draws):
        """A draw source whose sites draw the global (total, ...) values
        and keep this rank's rows."""
        return _RowDraws(draws, self) if self.red.active else draws

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global (total, ...) array of which x holds this rank's rows:
        each rank's rows scattered into zeros, summed over the ranks (an
        all-gather for a layout contiguous or not; exact, every entry has
        one rank; padding lands in a slot past `total`, cut off)."""
        if not self.red.active:
            return x
        dtype = torch.int32 if x.dtype == torch.bool else x.dtype
        z = torch.zeros((self.total + self.padded,) + tuple(x.shape[1:]),
                        dtype=dtype, device=x.device)
        z[self.index] = x.to(dtype)
        z = z[:self.total]
        self.red.all_reduce(z)
        return z.bool() if x.dtype == torch.bool else z

    def scaled(self, k: int) -> "Rows":
        """The layout of k consecutive entries for each entry (a
        contiguous layout's rows of a (rows, k) array, flattened)."""
        i = self.index
        return Rows(self.red, self.total * k, slice(i.start * k, i.stop * k))

    def repeated(self, p: int, device) -> "Rows":
        """The layout of a (p, total) array flattened, each of its p rows
        laid out as this one."""
        if not self.red.active:
            return Rows(self.red, p * self.total, slice(0, p * self.total))
        idx = (torch.arange(p, device=device)[:, None] * self.total
               + self.global_index(device)[None])
        return Rows(self.red, p * self.total, idx.reshape(-1))

    def select(self, sel: torch.Tensor):
        """This rank's members of a global selection `sel` (global
        positions, in the selection's order): (their local positions, the
        Rows of their places in the selection). Under a process group both
        have the fixed size min(len(sel), len(self)): the members in the
        selection's order, then padding at local position 0 (a copy of a
        real entry, for the caller to mask out: Rows.members)."""
        k = sel.shape[0]
        if not self.red.active:
            return sel, Rows(self.red, k, slice(0, k))
        dev = sel.device
        cap = min(k, len(self))
        inv = torch.full((self.total + 1,), -1, dtype=torch.long, device=dev)
        inv[self.global_index(dev)] = torch.arange(len(self), device=dev)
        loc = inv[sel]
        member = loc >= 0
        # the members' places in the selection, packed to the front in
        # order (a member's rank among the members is its slot; padding
        # goes to slot cap, cut off)
        slot = torch.where(member, torch.cumsum(member, 0) - 1, cap)
        pos = torch.full((cap + 1,), k, dtype=torch.long, device=dev)
        pos = pos.index_copy(0, slot, torch.arange(k, device=dev))[:cap]
        local = torch.where(pos < k, loc[pos.clamp(max=k - 1)], 0)
        return local, Rows(self.red, k, pos, padded=True)

    def split_sorted(self, perm: torch.Tensor, k: int):
        """This rank's run of an ascending stream `perm` of global
        positions in the layout scaled(k): (its local positions, the Rows
        of the run in the stream). Under a process group both have the
        fixed size min(len(perm), len(self)*k), the run found on the card
        (searchsorted), then padding at this rank's last local position
        (the stream stays ascending)."""
        n = perm.shape[0]
        if not self.red.active:
            return perm, Rows(self.red, n, slice(0, n))
        a, b = self.index.start * k, self.index.stop * k
        lo = torch.searchsorted(perm, a)
        hi = torch.searchsorted(perm, b)
        src = lo + torch.arange(min(n, b - a), device=perm.device)
        member = src < hi
        local = torch.where(member, perm[src.clamp(max=n - 1)] - a,
                            b - a - 1)
        return local, Rows(self.red, n, torch.where(member, src, n),
                           padded=True)


class _RowDraws:
    """Draws of Rows: a site asking for (n, ...) draws the global (total,
    ...) values and keeps this rank's n rows."""

    def __init__(self, draws, rows: Rows):
        self.draws, self.rows = draws, rows

    def _shape(self, shape):
        if shape[0] != len(self.rows):
            raise ValueError(f"{tuple(shape)}: rows of this rank's "
                             f"{len(self.rows)}")
        return (self.rows.total,) + tuple(shape[1:])

    def uniform(self, name, shape):
        return self.rows.take(self.draws.uniform(name, self._shape(shape)))

    def normal(self, name, shape):
        return self.rows.take(self.draws.normal(name, self._shape(shape)))

    def randint(self, name, shape, low, high):
        return self.rows.take(self.draws.randint(name, self._shape(shape),
                                                 low, high))


class ViewDraws:
    """The draws of view `view` of `views`: every site draws the values of
    all the views (a leading axis of `views`) from the shared source and
    keeps its own, so every rank's source advances alike."""

    def __init__(self, draws, view: int, views: int):
        self.draws, self.view, self.views = draws, int(view), int(views)

    def uniform(self, name, shape):
        return self.draws.uniform(name, (self.views,) + tuple(shape))[
            self.view]

    def normal(self, name, shape):
        return self.draws.normal(name, (self.views,) + tuple(shape))[
            self.view]

    def randint(self, name, shape, low, high):
        return self.draws.randint(name, (self.views,) + tuple(shape), low,
                                  high)[self.view]


# ---- batches ----

def host_sample_real_batch(rng: np.random.Generator, data: dict,
                           num_frames: int, ray_num: int):
    """One random frame and ray_num random pixels of it, drawn on the host
    (frame, pixels, then the background, as the JAX copy draws them):
    (batch of (ray_num, ...) arrays, bg (ray_num, 3)). `data`: numpy
    arrays of Trainer.host_data's layout."""
    frame = int(rng.integers(0, num_frames))
    n_pix = int(np.asarray(data["rays_d_cam"]).shape[0])
    pix = rng.integers(0, n_pix, size=ray_num)

    pose = np.asarray(data["poses"][frame])
    d_cam = np.asarray(data["rays_d_cam"])[pix]
    rays_o = np.broadcast_to(pose[:3, 3], (ray_num, 3)).copy()
    rays_d = np.einsum("nk,kj->nj", d_cam, pose[:3, :3].T)
    batch = {
        "rays_o": rays_o.astype(np.float32),
        "rays_d": rays_d.astype(np.float32),
        "rays_t": np.full((ray_num, 1), frame / num_frames, np.float32),
        "rays_id": np.full((ray_num,), frame, np.int32),
        "image": np.asarray(data["images"][frame])[pix],
        "depth": np.asarray(data["depths"][frame])[pix],
        "mask": np.asarray(data["masks"][frame])[pix],
    }
    bg_color = rng.uniform(size=(ray_num, 3)).astype(np.float32)
    return batch, bg_color


def shard_batch_stacked(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a stack of batches (leading axis n, the ray axis
    second): each array's contiguous block `rank` of `world` along its
    second axis, the layout of the JAX package's chained scan input; an
    array whose second axis does not divide stays whole."""
    out = {}
    for k, v in batch.items():
        if np.ndim(v) >= 2 and np.shape(v)[1] % world == 0:
            b = np.shape(v)[1] // world
            out[k] = v[:, rank * b:(rank + 1) * b]
        else:
            out[k] = v
    return out


# ---- replicated state ----

def digest(tree) -> str:
    """sha256 of a tree of dicts, lists, arrays, tensors and scalars."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            x = x.detach()
            if x.dtype == torch.bfloat16:
                x = x.view(torch.int16)
            walk(x.cpu().numpy())
        elif isinstance(x, np.ndarray):
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        else:
            h.update(repr(x).encode())

    walk(tree)
    return h.hexdigest()


def replicas_equal(trainer) -> bool:
    """Whether the trainer's state (parameters, optimizer slots and step,
    EMA, occupancy grid, carried gradients, counters, draws) is the same
    on every rank, bit for bit."""
    return trainer.dp.agree(digest(trainer.state_dict()))


# ---- the process group ----

def check_rays(config: dict, world: int) -> None:
    """The global ray batch splits evenly over the ranks."""
    if config["train"]["real_ray_num"] % world:
        raise ValueError(
            f"train.real_ray_num ({config['train']['real_ray_num']}) must "
            f"be divisible by tpu.data_parallel ({world})")


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, port: int, device,
         share_card: bool = False) -> tuple[Reducer, torch.device]:
    """Join the process group of `world` ranks at localhost:port; returns
    (its reducer, this rank's device): NCCL for ranks on CUDA cards of
    their own (card `rank`), gloo on the CPU and for ranks that share card
    0."""
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if share_card else rank)
        backend = "gloo" if share_card else "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=TIMEOUT,
        device_id=dev if backend == "nccl" else None)
    return Reducer(dist.group.WORLD), dev


def launch(fn, world: int, device="cuda", args=(),
           share_card: bool = False) -> None:
    """Run fn(reducer, device, *args) in `world` spawned ranks (fn and
    args picklable: fn a module-level function); raises if a rank
    fails. A CUDA run takes one card a rank, unless share_card puts every
    rank on card 0, over gloo."""
    if torch.device(device).type == "cuda" and not share_card:
        n = torch.cuda.device_count()
        if world > n:
            raise RuntimeError(f"tpu.data_parallel={world} but only {n} "
                               "CUDA devices are visible")
    torch.multiprocessing.spawn(
        _rank_main, args=(fn, world, free_port(), str(device), share_card,
                          tuple(args)),
        nprocs=world, join=True)


def _rank_main(rank, fn, world, port, device, share_card, args):
    red, dev = init(rank, world, port, device, share_card)
    if dev.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        fn(red, dev, *args)
    finally:
        dist.destroy_process_group()
