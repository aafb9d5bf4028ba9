"""The port's one CUDA-graph capture (morpheus_tpu_torch/graphs.py) on the
CPU, with the torch.cuda calls it makes replaced by no-ops (fake_cuda: the
warm-up and the capture each run the body eagerly, a replay runs nothing):

(a) the rule for host counters: the counts that the capture's body made are
    taken back off as the capture ends and kept on the graph, each replay
    adds them again, and counts made outside the body (the warm-up's among
    them) are left alone; a failed capture raises;
(b) the trainer's captures line reads its launches, all_reduces and
    all_reduce_bytes from those counts, over a data-parallel (gloo, one
    rank) trainer forced onto the graphed path whose kernel names count as
    the wrappers do on a card.
"""
import contextlib

import pytest
import torch

import torch_parity as tp
from morpheus_tpu_torch import graphs, kernels, trace
from morpheus_tpu_torch.config import merge_defaults
from morpheus_tpu_torch.data.dataset import load_synthetic
from morpheus_tpu_torch.ops import hashgrid
from morpheus_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


class FakeStream:
    def wait_stream(self, other):
        pass


class FakeCUDAGraph:
    """Records the generators registered with it and counts its replays."""

    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


def fake_cuda(monkeypatch) -> None:
    """The torch.cuda calls of graphs.capture as no-ops, and a span map
    that counts no device node."""
    for name, value in (
            ("current_stream", lambda device=None: FakeStream()),
            ("Stream", lambda device=None: FakeStream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("synchronize", lambda device=None: None),
            ("empty_cache", lambda: None),
            ("memory_reserved", lambda device=None: 0),
            ("CUDAGraph", FakeCUDAGraph),
            ("graph", lambda g: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)
    node_map = trace.NodeMap
    monkeypatch.setattr(trace, "NodeMap", lambda: node_map(lambda: 0))


def since(before: dict) -> dict:
    """The host counters that moved since `before`, by how much."""
    return {k: v - before.get(k, 0.0) for k, v in trace.counts().items()
            if v != before.get(k, 0.0)}


def test_capture_takes_its_counts_off_and_each_replay_adds_them(
        monkeypatch):
    fake_cuda(monkeypatch)
    monkeypatch.setattr(trace, "_host", {})
    x, gen, ran = torch.zeros(3), torch.Generator(), []

    def body():
        ran.append(len(ran))
        trace.count("k.launches")
        trace.count("k.bytes", 12.0)
        with trace.span("phase.a"):
            x.add_(1.0)
        return x

    trace.count("outside", 5.0)
    out, g = graphs.capture(body, "cpu", generators=(gen,))
    # the warm-up and the capture each ran the body; the warm-up's counts
    # stay, the capture's were taken back off and kept
    assert ran == [0, 1] and out is x and g.out is x
    assert trace.counts() == {"outside": 5.0, "k.launches": 1.0,
                              "k.bytes": 12.0}
    assert g.counts == {"k.launches": 1.0, "k.bytes": 12.0}
    assert g.graph.generators == [gen]
    assert g.phases == [["phase.a", 0, 0]] and g.nested == []
    assert g.device_nodes == 0 and g.pool_mb == 0.0
    assert g.warmup_s >= 0.0 and g.capture_s >= 0.0
    assert trace._capture is None
    trace.count("outside")
    for n in (1, 2, 3):
        assert g.replay() is x
        assert trace.counts() == {"outside": 6.0, "k.launches": 1.0 + n,
                                  "k.bytes": 12.0 * (1 + n)}
    assert g.graph.replays == 3 and ran == [0, 1]
    # a reset counts from 0 again, and a replay still adds its capture's
    trace.reset()
    g.replay()
    assert trace.counts() == {"outside": 0.0, "k.launches": 1.0,
                              "k.bytes": 12.0}


def test_a_failed_capture_raises(monkeypatch):
    fake_cuda(monkeypatch)

    def body():
        if calls:
            raise RuntimeError("not capturable")
        calls.append(1)
        return torch.zeros(())

    calls = []
    with pytest.raises(RuntimeError, match="not capturable"):
        graphs.capture(body, "cpu")
    assert trace._capture is None


def test_captures_line_reads_the_capture_counts(monkeypatch):
    import torch.distributed as dist
    from morpheus_tpu_torch.parallel import sharding
    fake_cuda(monkeypatch)
    for name in kernels.SIGNATURES:      # counted as the card's wrappers do
        fn = getattr(hashgrid, name)

        def counted(*a, _name=name, _fn=fn, **kw):
            trace.count(_name + ".launches")
            return _fn(*a, **kw)
        monkeypatch.setattr(hashgrid, name, counted)
    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{sharding.free_port()}"), world_size=1, rank=0)
    try:
        tiny = {k: dict(v) for k, v in tp.TINY.items()}
        # no occupancy refresh after step 0: every count is the body's
        tiny["tpu"].update(chain_steps=True, occ_update_every=1000)
        cfg = merge_defaults(tiny)
        tr = Trainer(cfg, load_synthetic(cfg), device="cpu",
                     reducer=sharding.Reducer(dist.group.WORLD))
        tr.graphed = True            # the card's path, on fake CUDA calls
        tr.epoch, tr.global_step = 3, 1
        tr._set_levels(tr._active_levels())
        before = trace.counts()
        tr.chained_real_step(tr.epoch)       # the warm-up, then the capture
        one = since(before)                  # the warm-up's counts alone
        (cap,) = tr.captures
        graph = tr._graphs[cap["active_levels"]].graph
        assert graph.counts == one
        assert graph.graph.generators == [tr.draws.generator]
        assert set(cap["launches"]) == set(kernels.SIGNATURES)
        assert cap["launches"] == kernels.launches(one)
        assert cap["launches"]["row_gather"] > 0
        assert cap["launches"]["level_histogram"] > 0
        assert cap["launches"]["level_gather"] == 0
        assert cap["all_reduces"] == one["dp.all_reduces"] >= 1
        assert cap["all_reduce_bytes"] == one["dp.all_reduce_bytes"] > 0
        assert all(isinstance(cap[k], int)
                   for k in ("all_reduces", "all_reduce_bytes"))
        assert [p[0] for p in cap["phases"]] == [
            "real.render", "real.backward", "real.update"]
        assert cap["device_nodes"] == 0
        for n in (1, 2):
            tr.chained_real_step(tr.epoch)
            assert since(before) == {k: (1 + n) * v for k, v in one.items()}
        assert graph.graph.replays == 2 and len(tr.captures) == 1
    finally:
        dist.destroy_process_group()
