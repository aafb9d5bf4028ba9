"""tpu.chain_steps in the port (train/trainer.py: chained_real_step, the
graph of _real_body, train/schedule.py StepScalars), on the CPU, where the
chained step runs the graph's body eagerly (its plain twin):

(a) a chained epoch against the JAX package's chained epoch (one lax.scan
    dispatch of real_freq steps, tests/test_smoke_fast.py:115) from the same
    parameters and the JAX key sequence replayed: global_step equal, losses
    at rtol 1e-4, the occupancy EMA at rtol 1e-5, the parameters within
    2*n*lr after n steps (tests/test_torch_train_steps.py's tolerances);
(b) the chained step (device scalars, the carried gradients always added)
    bit for bit equal to the eager step (host scalars) over two epochs that
    cross occupancy refreshes and an epoch boundary where the learning
    rate, max_level's mask and the loss weights all change, under Adam and
    Adan. The fold is captured and always added, as the JAX step adds it:
    with nothing carried that adds +0 to each gradient, which turns a -0
    gradient into +0 and changes nothing else, so every tensor is compared
    bit for bit except Adan's prev_grad slot (the last clipped gradient
    itself), compared by value (-0 == +0);
(c) every tensor the step reads or writes keeps its address across
    refreshes, a virtual step, the EMA update and load_state_dict;
(d) the graph cache keys on the active-level count, evicts a superseded
    count, and is dropped on load_state_dict, set_spec and a rebound
    occupancy state (a stub capture on the CPU);
and a data-parallel (gloo) trainer's chained steps, eager.
"""
import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from graph_stubs import stub_capture
from morpheus_tpu_torch.config import merge_defaults
from morpheus_tpu_torch.data.dataset import load_synthetic
from morpheus_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


class StepDraws(tp.ReplayDraws):
    """ReplayDraws of one step after another: each step's arrays from its
    first draw, t_occ, on."""

    def __init__(self, steps):
        super().__init__({})
        self.steps = list(steps)

    def _get(self, name, shape):
        if name == "t_occ":
            self.arrays = self.steps.pop(0)
        return super()._get(name, shape)


def test_chained_epoch_matches_jax_chain():
    jcfg, jtr, ttr = tp.make_pair("float32", "hist_rows",
                                  {"tpu": {"chain_steps": True}})
    assert jtr.config["tpu"]["chain_steps"] and ttr.chain
    epoch, n = 3, jcfg["train"]["real_freq"]
    jtr.epoch = ttr.epoch = epoch
    key, steps = jtr.key, []
    for step in range(n):      # the scan body's key splits (trainer.py:360)
        key, k = jax.random.split(key)
        steps.append(tp.step_draws(k, jcfg, 4, 32 * 32, step))
    ttr.draws = StepDraws(steps)
    j_loss = jtr.train_one_epoch()
    t_loss = ttr.train_one_epoch()
    assert ttr.global_step == int(jtr.state.global_step) == n
    np.testing.assert_array_equal(np.asarray(jtr.key), np.asarray(key))
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    np.testing.assert_allclose(ttr.occ.occs.numpy(),
                               np.asarray(jtr.state.occ.occs), rtol=1e-5,
                               atol=1e-7)
    tp.assert_trees_close(dict(ttr.field.state_dict()), jtr.state.params,
                          rtol=0, atol=2 * n * float(
                              jtr.curr.learning_rate(epoch)), what="params")


def port_trainer(chain: bool, optim: str = "adam", **train) -> Trainer:
    """A port trainer of tests/torch_parity.py's TINY config with
    tpu.chain_steps `chain`, warm_up_end 2 and n_epochs 404: the late loss
    weights from epoch 203 (swap_epoch 202), and max_level*4 from 3.0 at
    epoch 202 to 3.005 at 203 (a third, then a fourth level unmasked; the
    active count is 4 either way)."""
    tiny = {k: dict(v) for k, v in tp.TINY.items()}
    tiny["tpu"]["chain_steps"] = chain
    tiny["train"].update(dict(optim=optim, n_epochs=404, warm_up_end=2),
                         **train)
    cfg = merge_defaults(tiny)
    return Trainer(cfg, load_synthetic(cfg), device="cpu")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("optim", ["adam", "adan"])
def test_chained_step_is_the_eager_step_bit_for_bit(optim):
    runs = {}
    for chain in (True, False):
        tr = port_trainer(chain, optim)
        losses = []
        for epoch in (202, 203):
            tr.epoch = epoch
            losses.append(tr.train_one_epoch())
        runs[chain] = tr, losses
    (a, la), (b, lb) = runs[True], runs[False]
    c = a.curr
    assert c.loss_weights(202) != c.loss_weights(203)
    assert c.learning_rate(202) != c.learning_rate(203)
    assert np.ceil(c.max_level(202) * 4) == 3
    assert np.ceil(c.max_level(203) * 4) == 4
    assert a._active_levels() == 4 and a.global_step == 6
    assert la == lb
    pairs = [("params", a.params, b.params), ("ema", a.ema, b.ema),
             ("occ", [a.occ.occs, a.occ.binaries],
              [b.occ.occs, b.occ.binaries]),
             ("step", [a.optim.step], [b.optim.step]),
             ("pending", a.pending, b.pending)]
    pairs += [(k, getattr(a.optim, k), getattr(b.optim, k))
              for k in a.optim.SLOTS if k != "prev_grad"]
    for name, xs, ys in pairs:
        for x, y in zip(xs, ys):
            assert torch.equal(bits(x), bits(y)), name
    if optim == "adan":
        assert all(torch.equal(x, y) for x, y in zip(a.optim.prev_grad,
                                                     b.optim.prev_grad))
    assert torch.equal(a.draws.generator.get_state(),
                       b.draws.generator.get_state())


def addresses(tr: Trainer) -> dict:
    out = {"params": [p.data_ptr() for p in tr.params],
           "ema": [e.data_ptr() for e in tr.ema],
           "pending": [p.data_ptr() for p in tr.pending],
           "step": [tr.optim.step.data_ptr()],
           "occ": [tr.occ.occs.data_ptr(), tr.occ.binaries.data_ptr()],
           "scalars": [t.data_ptr() for t in (tr.scalars.buf, tr.scalars.lr,
                                              tr.scalars.max_level,
                                              *tr.scalars.loss_weights)]}
    out.update({k: [t.data_ptr() for t in getattr(tr.optim, k)]
                for k in tr.optim.SLOTS})
    return out


def test_step_state_keeps_its_addresses():
    """Two SDS epochs of a virtual step and two chained real steps each
    (the deform freeze off, so the virtual step's gradients are carried
    into the real step), with refreshes at steps 0 (warm-up, a virtual
    step), 2 and 4 (sampled, real steps), the EMA update after each, then
    load_state_dict of another trainer's state: every address as it
    was."""
    from morpheus_tpu_torch.guidance.zero123 import (Zero123Guidance,
                                                     Zero123Spec)
    tiny = {k: dict(v) for k, v in tp.TINY.items()}
    tiny["tpu"]["chain_steps"] = True
    tiny["train"].update(tp.SDS_TRAIN, freeze_epoch=1, real_freq=2)
    tiny["model"]["bg_radius"] = 1.4
    tiny["data"]["novel_view_scale"] = tp.SDS_VIEW / 32
    cfg = merge_defaults(tiny)
    g = Zero123Guidance.init_random(Zero123Spec(**tp.SPEC_KW), "cpu", seed=1)
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu", guidance=g)
    before = addresses(tr)
    occ0 = tr.occ.occs.clone()
    for epoch in (3, 4):
        tr.epoch = epoch
        assert np.isfinite(tr.train_one_epoch())
    assert tr.global_step == 6 and not torch.equal(tr.occ.occs, occ0)
    assert addresses(tr) == before
    other = Trainer(cfg, load_synthetic(cfg), device="cpu", seed=5)
    other.epoch = 3
    other.train_one_epoch()
    tr.load_state_dict(other.state_dict())
    assert torch.equal(tr.occ.occs, other.occ.occs)
    assert addresses(tr) == before


def test_graph_cache_keys_on_active_levels(monkeypatch):
    tr = port_trainer(True, n_epochs=8)
    made = []
    tr.graphed = True            # the card's path, with the stub capture
    stub_capture(monkeypatch, made)
    tr.epoch = 0                 # max_level 0.5: 2 of the 4 levels
    tr.train_one_epoch()
    assert list(tr._graphs) == [2] and len(made) == 1
    assert made[0].replays == 2  # the warm-up step captured, 2 replays
    tr.train_one_epoch()
    assert len(made) == 1 and made[0].replays == 5
    tr.epoch = 1                 # 0.5625: 3 levels, rounded up to 4
    tr.train_one_epoch()
    assert list(tr._graphs) == [4] and len(made) == 2
    tr.epoch = 2                 # the same count: the same graph
    tr.train_one_epoch()
    assert len(made) == 2 and made[1].replays == 5
    tr.load_state_dict(tr.state_dict())
    assert tr._graphs == {}
    tr.train_one_epoch()
    assert list(tr._graphs) == [4] and len(made) == 3
    tr.set_spec(normal_mode="fd")
    assert tr._graphs == {}
    tr.train_one_epoch()
    assert len(made) == 4 and tr._graphs[4].graph is made[3]
    assert tr._graphs[4].spec.normal_mode == "fd"
    # a rebound occupancy state is not the one the graph reads
    tr.occ = tr.occ._replace(occs=tr.occ.occs.clone())
    tr.train_one_epoch()
    assert len(made) == 5 and list(tr._graphs) == [4]
    assert tr.global_step == 7 * 3


def test_data_parallel_trainer_steps_eagerly(capsys):
    """Under a process group of gloo (one rank here) the trainer keeps
    tpu.chain_steps: its epoch loop's real steps are chained_real_step,
    whose body runs eagerly (gloo's collectives cannot be captured), with
    no line printed, and the run equals its eager twin (chain_steps false)
    bit for bit."""
    import torch.distributed as dist
    from morpheus_tpu_torch.parallel import sharding
    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{sharding.free_port()}"), world_size=1, rank=0)
    try:
        runs = {}
        for chain in (True, False):
            tiny = {k: dict(v) for k, v in tp.TINY.items()}
            tiny["tpu"].update(chain_steps=chain)
            cfg = merge_defaults(tiny)
            tr = Trainer(cfg, load_synthetic(cfg), device="cpu",
                         reducer=sharding.Reducer(dist.group.WORLD))
            assert tr.chain == chain and not tr.graphed
            calls = []
            step = tr.chained_real_step
            tr.chained_real_step = lambda epoch: (
                calls.append(epoch) or step(epoch))
            tr.epoch = 3
            runs[chain] = tr, tr.train_one_epoch(), calls
        assert capsys.readouterr().out == ""
        (a, la, ca), (b, lb, cb) = runs[True], runs[False]
        assert ca == [3, 3, 3] and cb == []
        assert a.global_step == b.global_step == 3
        assert np.isfinite(la) and la == lb
        for x, y in zip(a.params + a.optim.mu + a.optim.nu,
                        b.params + b.optim.mu + b.optim.nu):
            assert torch.equal(bits(x), bits(y))
    finally:
        dist.destroy_process_group()


def test_trace_steps_of_chained_steps_on_the_cpu():
    """trace_step.trace_steps over chained steps (the bench's trace and
    chip_smoke.py's phase 15): the steps advance through chained_real_step,
    the result says so."""
    from morpheus_tpu_torch.scripts import trace_step
    tr = port_trainer(True)
    tr.epoch = 202
    called = []
    real = tr.chained_real_step
    tr.chained_real_step = lambda epoch: called.append(epoch) or real(epoch)
    res = trace_step.trace_steps(tr, n=2, top=1, log=lambda *a: None,
                                 chained=True)
    assert res["chained"] and res["steps"] == 2 and len(called) == 3


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_chain_compare(chip_smoke):
    """Phase 15's comparison on two tiny trainers: the chained and the
    eager run of the bit-for-bit test compare equal; losses apart fail
    the bitwise comparison, and the tolerant one reports them (one step's
    loss can flip with a sample selection); a parameter moved by one ulp
    fails the bitwise
    comparison and passes the tolerant one; a different generator state
    fails both."""
    runs = []
    for chain in (True, False):
        tr = port_trainer(chain)
        tr.epoch = 202
        tr.train_one_epoch()
        runs.append(tr)
    a, b = runs
    assert chip_smoke.chain_compare(b, a, bitwise=True)["failed"] == []
    assert chip_smoke.chain_compare(b, a, bitwise=True, losses=(
        [1.0], [1.0 + 1e-4]))["failed"] == ["losses"]
    tolerant = chip_smoke.chain_compare(b, a, bitwise=False, losses=(
        [1.0], [1.01]))
    assert tolerant["failed"] == []
    assert tolerant["losses_max_rel_diff"] == pytest.approx(0.01)
    with torch.no_grad():
        a.params[0].view(-1)[0] = torch.nextafter(
            a.params[0].view(-1)[0], torch.tensor(float("inf")))
    assert chip_smoke.chain_compare(b, a, bitwise=True)["failed"] == [
        "params_equal"]
    assert chip_smoke.chain_compare(b, a, bitwise=False)["failed"] == []
    a.draws.uniform("x", (1,))
    assert "generator_equal" in chip_smoke.chain_compare(
        b, a, bitwise=False)["failed"]


def test_chip_smoke_chain_only_runs_phase_15_alone(chip_smoke, tmp_path,
                                                   monkeypatch):
    import sys
    from morpheus_tpu_torch.data import dataset
    seen = []
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--chain-only"])
    monkeypatch.setattr(dataset, "load_synthetic", lambda cfg: "ds")
    monkeypatch.setattr(chip_smoke, "chain_phase",
                        lambda device, ds: seen.append(ds) or {})
    for other in ("check_hist", "check_gather", "check_segsum", "main_path",
                  "sds_phase", "cli_phase", "check_mesh_gather",
                  "bench_phase"):
        monkeypatch.setattr(chip_smoke, other, lambda *a, **k: 1 / 0)
    assert chip_smoke.run(torch.device("cpu"), "card", str(tmp_path)) == 0
    assert seen == ["ds"]
