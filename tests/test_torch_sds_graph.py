"""The SDS virtual step's CUDA graph (train/trainer.py: virtual_step,
_virtual_body, _sds_replay, _HeldT) on the CPU, where a stub of
graphs.capture (tests/graph_stubs.py) stands in for CUDA's and the draws
come from a counter-based generator with a CUDA generator's offsets:

(a) the graphed step (the key's first step eager, then replays) bit for bit
    equal to the eager step over SDS steps interleaved with chained real
    steps, with the deform freeze on (remat_virtual on) and off (off),
    across epochs whose learning rate, loss weights and timestep bounds
    differ, with one capture;
(b) a capture for each key: the view size, the level count and the freeze;
(c) the step eager on the CPU, under a process group and under
    progressive_view;
(d) the counters sds.calls and sds.replays, and apply_unet inside a
    capture; the benchmark's reader of sds.graph_share;
(e) the keys of configs/snoopy.yaml's 2000 epochs, on the host.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import torch_parity as tp
from graph_stubs import stub_capture
from morpheus_tpu_torch import graphs, trace
from morpheus_tpu_torch.config import load_config, merge_defaults
from morpheus_tpu_torch.data.dataset import load_synthetic
from morpheus_tpu_torch.guidance import zero123 as z123
from morpheus_tpu_torch.train import trainer as trainer_lib
from morpheus_tpu_torch.train.schedule import Curriculum
from morpheus_tpu_torch.train.trainer import Trainer
from morpheus_tpu_torch.utils import Draws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _OffsetGenerator:
    def __init__(self, seed: int):
        self.seed, self.offset = seed, 0

    def get_offset(self) -> int:
        return self.offset

    def set_offset(self, offset: int) -> None:
        self.offset = offset

    def get_state(self) -> torch.Tensor:
        return torch.tensor([self.seed, self.offset])

    def set_state(self, state: torch.Tensor) -> None:
        self.seed, self.offset = (int(v) for v in state)


class OffsetDraws(Draws):
    """The trainer's kind of draws, whose values depend on the seed and the
    generator's offset alone, each advancing the offset by 4, as a CUDA
    generator's Philox offset does: the offsets that the SDS graph's held
    timestep reads, which a CPU generator lacks."""

    def __init__(self, seed: int):
        self.device = torch.device("cpu")
        self.generator = _OffsetGenerator(seed)

    def _gen(self) -> torch.Generator:
        g = self.generator
        gen = torch.Generator().manual_seed(g.seed * 1_000_003 + g.offset)
        g.offset += 4
        return gen

    def uniform(self, name, shape):
        return torch.rand(tuple(shape), generator=self._gen())

    def normal(self, name, shape):
        return torch.randn(tuple(shape), generator=self._gen())

    def randint(self, name, shape, low, high):
        return torch.randint(low, high, tuple(shape), generator=self._gen())


def sds_trainer(graphed: bool, freeze_epoch: int = 300, remat=True,
                reducer=None) -> Trainer:
    """tests/torch_parity.py's TINY scene with the tiny random Zero123, one
    SDS slot and one real step an iteration, snoopy's 2000-epoch
    curriculum (swap at 400: the late loss weights, and the timestep
    bounds falling from there), the freeze until `freeze_epoch`; the
    card's path (`graphed`) with the stub capture, else eager."""
    tiny = {k: dict(v) for k, v in tp.TINY.items()}
    tiny["tpu"].update(chain_steps=True, remat_virtual=remat)
    tiny["train"].update(tp.SDS_TRAIN, n_epochs=2000, warm_up_end=200,
                         freeze_epoch=freeze_epoch)
    tiny["model"]["bg_radius"] = 1.4
    tiny["data"]["novel_view_scale"] = tp.SDS_VIEW / 32
    cfg = merge_defaults(tiny)
    g = z123.Zero123Guidance.init_random(z123.Zero123Spec(**tp.SPEC_KW),
                                         "cpu", seed=1)
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu", guidance=g,
                 reducer=reducer)
    tr.draws = OffsetDraws(7)
    tr.graphed = graphed
    return tr


def run_steps(tr: Trainer, epochs) -> list:
    """An SDS step then a chained real step at each epoch; the SDS steps'
    losses and carried-gradient flags."""
    out = []
    for epoch in epochs:
        tr.epoch = epoch
        tr._set_levels(tr._active_levels())
        sampler = tr.virtual_sampler(tr._novel_view_scale())
        loss, _ = tr.virtual_step(epoch, sampler)
        out.append((loss.clone(), tr._pending_live))
        tr.chained_real_step(epoch)
    return out


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (freeze on, remat on): epochs 250 and 251 differ in learning rate; (off,
# off): 399 and 401 cross the swap (loss weights) and the bounds fall
@pytest.mark.parametrize("freeze,remat,epochs", [
    (True, True, (250, 251, 251, 250)),
    (False, False, (399, 401, 401, 399))])
def test_graphed_sds_step_is_the_eager_step_bit_for_bit(monkeypatch, freeze,
                                                        remat, epochs):
    made = []
    stub_capture(monkeypatch, made)
    a, b = sds_trainer(True, remat=remat), sds_trainer(False, remat=remat)
    c = a.curr
    assert all(c.freeze_deform(e) == freeze for e in epochs)
    assert c.learning_rate(epochs[0]) != c.learning_rate(epochs[1])
    if not freeze:
        assert c.loss_weights(epochs[0]) != c.loss_weights(epochs[1])
        assert c.sds_steps(epochs[0]) != c.sds_steps(epochs[1])
    ra, rb = run_steps(a, epochs), run_steps(b, epochs)
    assert len(made) == 2 and len(a.sds_captures) == 1      # SDS and real
    assert made[0].replays == len(epochs) - 1 and not b.sds_captures
    assert a.sds_captures[0]["freeze"] == freeze
    assert a.sds_captures[0]["remat"] == remat
    assert a.sds_captures[0]["t_offset"] > 0
    for (la, pa), (lb, pb) in zip(ra, rb):
        assert torch.equal(bits(la), bits(lb)) and pa == pb == (not freeze)
    assert a.global_step == b.global_step == 2 * len(epochs)
    assert a.draws.generator.offset == b.draws.generator.offset
    pairs = [("params", a.params, b.params), ("pending", a.pending, b.pending),
             ("step", [a.optim.step], [b.optim.step])]
    pairs += [(k, getattr(a.optim, k), getattr(b.optim, k))
              for k in a.optim.SLOTS]
    for name, xs, ys in pairs:
        for x, y in zip(xs, ys):
            assert torch.equal(bits(x), bits(y)), name


def test_held_timestep_is_the_eager_draw_over_the_current_bounds():
    """_HeldT.draw fills the timestep that the eager body draws at the
    offset it reaches, over the bounds given, and leaves the generator's
    offset as it was."""
    draws = OffsetDraws(3)
    draws.generator.offset = 40
    held = trainer_lib._HeldT(draws, "cpu")
    for _ in range(3):
        draws.uniform("x", (2,))
    eager = held.randint("sds_t", (1,), 20, 500)
    assert held.offset == 12 and draws.generator.offset == 56
    draws.generator.offset = 40
    held.draw(20, 500)
    assert draws.generator.offset == 40 and torch.equal(held.t, eager)
    held.draw(20, 30)
    want = OffsetDraws(3)
    want.generator.offset = 52
    assert torch.equal(held.t, want.randint("sds_t", (1,), 20, 30))


def test_sds_graph_cache_keys(monkeypatch):
    """A capture for a new view size, level count or freeze flag; the old
    key's graph dropped; none for what the device reads."""
    made = []
    stub_capture(monkeypatch, made)
    tr = sds_trainer(True)

    def keys():
        return [k[0] for k in tr._sds_graphs]
    run_steps(tr, (0,))                          # 2 of 4 levels
    assert keys() == [((12, 12), 2, True, True, True)]
    run_steps(tr, (1, 2))                        # 3 levels, rounded to 4
    assert keys() == [((12, 12), 4, True, True, True)]
    run_steps(tr, (299, 300))                    # albedo off
    assert keys() == [((12, 12), 4, False, True, True)]
    run_steps(tr, (301, 302))                    # the freeze off
    assert keys() == [((12, 12), 4, False, False, True)]
    n = len(tr.sds_captures)
    tr.config["data"]["novel_view_scale_final"] = 16 / 32
    run_steps(tr, (801,))                        # the final view scale
    assert keys() == [((16, 16), 4, False, False, True)]
    assert len(tr.sds_captures) == n + 1 == 5
    tr.load_state_dict(tr.state_dict())
    assert tr._sds_graphs == {}
    tr.set_spec(normal_mode="fd")
    run_steps(tr, (802,))
    assert len(tr.sds_captures) == 6
    tr.occ = tr.occ._replace(occs=tr.occ.occs.clone())
    run_steps(tr, (803,))
    assert len(tr.sds_captures) == 7 and len(tr._sds_graphs) == 1


def test_sds_step_eager_on_the_cpu_under_a_group_and_progressive_view(
        monkeypatch):
    import torch.distributed as dist
    from morpheus_tpu_torch.parallel import sharding
    stub_capture(monkeypatch, [])
    tr = sds_trainer(False)
    assert Trainer(tr.config, tr.dataset, device="cpu").graphed is False
    run_steps(tr, (250, 251))
    assert not tr.sds_captures and not tr._sds_graphs
    # draws from elsewhere (a replay of recorded draws) have no generator
    # that a graph could advance
    tr = sds_trainer(True)
    tr.draws = tp.ReplayDraws({})
    tr.draws._get = lambda name, shape: torch.rand(tuple(shape))
    tr.virtual_step(250, tr.virtual_sampler(tr._novel_view_scale()))
    assert not tr.sds_captures and not tr._sds_graphs
    # progressive_view's ranges are host floats of the epoch
    tr = sds_trainer(True)
    tr.curr = dataclasses.replace(tr.curr, progressive_view=True)
    run_steps(tr, (250, 251))
    assert not tr.sds_captures and not tr._sds_graphs
    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{sharding.free_port()}"), world_size=1, rank=0)
    try:
        tr = sds_trainer(True, reducer=sharding.Reducer(dist.group.WORLD))
        run_steps(tr, (250, 251))
        assert not tr.sds_captures and not tr._sds_graphs
    finally:
        dist.destroy_process_group()


def test_sds_counters_and_the_benchmark_reader(monkeypatch):
    made = []
    stub_capture(monkeypatch, made)
    tr = sds_trainer(True)
    trace.reset()
    run_steps(tr, (250, 251, 252))
    c = trace.read()
    assert c["sds.calls"] == 3.0 and c["sds.replays"] == 2.0
    assert c["unet.calls"] == 3.0 and c["unet.replays"] == 2.0
    path = os.path.join(ROOT, "benchmark", "metrics", "sds.graph_share.py")
    spec = importlib.util.spec_from_file_location("sds_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(None) == pytest.approx(100.0 * 2 / 3)
    trace.reset()
    assert mod.read(None) is None


def test_apply_unet_inside_a_capture_runs_its_body_and_counts_a_replay(
        monkeypatch):
    g = z123.Zero123Guidance.init_random(z123.Zero123Spec(**tp.SPEC_KW),
                                         "cpu", seed=2)
    gen = torch.Generator().manual_seed(0)
    h = g.spec.latent_size
    x = torch.randn(2, 8, h, h, generator=gen)
    t = torch.randint(0, 1000, (2,), generator=gen)
    c = torch.randn(2, 1, g.spec.context_dim, generator=gen)
    want = z123._unet_body(g, x, t, c)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    trace.reset()
    assert torch.equal(z123.apply_unet(g, x, t, c), want)
    counts = trace.read()
    assert counts["unet.calls"] == counts["unet.replays"] == 1.0
    assert g.unet_graphs.graphs == {}


def test_snoopy_sds_keys_over_a_run():
    """configs/snoopy.yaml's 2000 epochs take a handful of SDS graphs: the
    keys change with the albedo phase (200), the freeze (400), the view
    scale (800) and the level count, never with the timestep bounds."""
    cfg = load_config(os.path.join(ROOT, "configs", "snoopy.yaml"))
    curr = Curriculum.from_config(cfg)
    d, levels = cfg["data"], cfg["model"].get("grid_num_levels", 16)
    keys, bounds = [], set()
    for epoch in range(2001):
        scale = (d["novel_view_scale_final"] if epoch > 800
                 else d["novel_view_scale"])
        view = (int(scale * 360), int(scale * 360))
        key = trainer_lib.sds_key(
            curr, epoch, view, trainer_lib.active_levels(curr, epoch, levels),
            cfg["tpu"].get("remat_virtual", True))
        if not keys or keys[-1] != key:
            keys.append(key)
        bounds.add(curr.sds_steps(epoch))
    assert len(set(keys)) == len(keys) <= 20
    assert len(bounds) > 100
    assert {k[2] for k in keys} == {True, False}
    assert {k[3] for k in keys} == {True, False}
    assert {k[0] for k in keys} == {(72, 72), (180, 180)}
    assert np.all(np.diff([k[1] for k in keys if k[1] is not None]) >= 0)
