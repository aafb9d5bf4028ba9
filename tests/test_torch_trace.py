"""The port's own spans and counters (morpheus_tpu_torch/trace.py) on the
CPU: a span is a shared no-op without a profiler and the profiler's
record_function with one; a tiny SDS epoch under torch.profiler shows each
phase span as often as its steps run; the sample streams' fill counters
equal the summed masks and the streams' fixed sizes; a capture's node map
turns span entries and exits into node ranges (a fake node count stands in
for the count CUDA gives, which needs a card), and a count that fails loses
the map, not the body."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parity as tp
from morpheus_tpu_torch import renderer, trace
from morpheus_tpu_torch.config import merge_defaults
from morpheus_tpu_torch.data.dataset import load_synthetic
from morpheus_tpu_torch.guidance.zero123 import Zero123Guidance, Zero123Spec
from morpheus_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

SDS_SPANS = ("sds.render", "guidance.vae_encode", "guidance.unet",
             "sds.grads", "sds.update")
REAL_SPANS = ("real.render", "real.backward", "real.update")


def sds_trainer(remat: bool, n_iters: int = 2) -> Trainer:
    """A tiny SDS trainer on the CPU: n_iters x (1 SDS step + 1 chained
    real step, the graph's body eagerly), a refresh every 2nd step."""
    tiny = {k: dict(v) for k, v in tp.TINY.items()}
    tiny["train"].update(tp.SDS_TRAIN, n_iters=n_iters)
    tiny["model"]["bg_radius"] = 1.4
    tiny["data"]["novel_view_scale"] = tp.SDS_VIEW / 32
    tiny["tpu"].update(chain_steps=True, remat_virtual=remat)
    cfg = merge_defaults(tiny)
    g = Zero123Guidance.init_random(Zero123Spec(**tp.SPEC_KW), "cpu", seed=1)
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu", guidance=g)
    tr.epoch = 6
    return tr


def span_calls(prof) -> dict:
    return {e.key: e.count for e in prof.key_averages()}


def test_span_without_a_profiler_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        pass


def test_span_is_record_function_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("outer"):
                with trace.span("inner"):
                    torch.ones(4).sum()
    calls = span_calls(prof)
    assert calls["outer"] == 3 and calls["inner"] == 3


@pytest.mark.parametrize("remat", [False, True])
def test_sds_epoch_spans(remat):
    """Each SDS phase span once per SDS step (sds.render once under
    remat_virtual too: it wraps the checkpoint, and the backward's
    recomputation opens none), each real phase once per real step,
    occ.refresh once per step that is due."""
    tr = sds_trainer(remat)
    every = tr.config["tpu"]["occ_update_every"]
    step0 = tr.global_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_one_epoch()
    steps = tr.global_step - step0
    calls = span_calls(prof)
    for name in SDS_SPANS + REAL_SPANS:
        assert calls.get(name) == 2, (name, calls.get(name))
    due = sum((step0 + i) % every == 0 for i in range(steps))
    assert due == 2 and calls.get("occ.refresh") == due


def test_sample_fill_counters_on_the_eager_body(monkeypatch):
    """The fill counters against every render's own mask: the valid sums
    and, for the slots, the stream's fixed size sample_budget x rays a
    step."""
    tr = sds_trainer(False)
    seen = {"real": [], "sds": []}
    orig = renderer.render_rays

    def rec(*args, **kw):
        out = orig(*args, **kw)
        kind = "real" if kw.get("real_view", True) else "sds"
        seen[kind].append(float(out["mask"].sum()))
        return out
    monkeypatch.setattr(renderer, "render_rays", rec)
    trace.reset()
    tr.train_one_epoch()
    got = trace.read()
    budget = tr.config["tpu"]["sample_budget"]
    rays = {"real": tr.config["train"]["real_ray_num"],
            "sds": tp.SDS_VIEW * tp.SDS_VIEW}
    for kind in ("real", "sds"):
        assert len(seen[kind]) == 2
        assert got[f"{kind}.samples_valid"] == sum(seen[kind])
        assert got[f"{kind}.samples_slots"] == 2 * budget * rays[kind]
        assert 0 < got[f"{kind}.samples_valid"] \
            < got[f"{kind}.samples_slots"]


def test_counters_add_on_the_device_and_reset_in_place():
    trace.allocate(("t",), "cpu")
    counter = trace._device[("t.samples_valid", torch.device("cpu"))]
    trace.reset()
    trace.fill("t", torch.tensor([True, False, True]))
    trace.fill("t", torch.tensor([[True, True], [False, False]]))
    got = trace.read()
    assert got["t.samples_valid"] == 4.0 and got["t.samples_slots"] == 7.0
    trace.reset()
    assert trace._device[("t.samples_valid", torch.device("cpu"))] \
        is counter
    assert trace.read()["t.samples_valid"] == 0.0
    assert trace.read()["t.samples_slots"] == 0.0


class FakeNodes:
    """A node count that the test advances by hand."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        return self.n


def test_node_map_of_fake_capture():
    nodes = FakeNodes()
    with trace.capture_phases(trace.NodeMap(nodes)) as m:
        nodes.n = 2                      # nodes before any span
        with trace.span("a"):
            nodes.n = 5
            with trace.span("inner"):
                nodes.n = 9
        with trace.span("b"):
            nodes.n = 12
        nodes.n = 13
    assert m.phases == [["a", 2, 9], ["b", 9, 12]]
    assert m.nested == [["inner", 5, 9]]
    assert m.device_nodes == 13
    assert trace._capture is None
    assert trace.span("a") is trace.span("b")


def test_node_map_closes_a_span_left_by_an_exception():
    """A span that an exception leaves (a non-reentrant checkpoint stops
    its recomputation early by raising) ends where the exception passed
    it, and the spans around it keep their own ends."""
    nodes = FakeNodes()
    with trace.capture_phases(trace.NodeMap(nodes)) as m:
        with trace.span("a"):
            nodes.n = 3
            with pytest.raises(ValueError):
                with trace.span("inner"):
                    nodes.n = 4
                    raise ValueError("stop")
            nodes.n = 6
        with trace.span("b"):
            nodes.n = 8
    assert m.phases == [["a", 0, 6], ["b", 6, 8]]
    assert m.nested == [["inner", 3, 4]]


class OpCount(TorchDispatchMode):
    """Counts the operators dispatched: a stand-in for the nodes a capture
    would add."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_node_map_of_the_real_body():
    """The chained real step's body under a fake capture: three
    contiguous phases, render, backward, update, in that order, each
    holding work, within the body's count; the band term's span
    (render.band) nested inside the render, holding work, and not among
    the phases."""
    tr = sds_trainer(False)
    tr.scalars.set(tr.epoch)
    ops = OpCount()
    with ops, trace.capture_phases(trace.NodeMap(lambda: ops.n)) as m:
        tr._real_body()
    names = [p[0] for p in m.phases]
    assert names == list(REAL_SPANS)
    (_, a0, a1), (_, b0, b1), (_, c0, c1) = m.phases
    assert a0 < a1 == b0 < b1 == c0 < c1 <= m.device_nodes
    [(name, n0, n1)] = m.nested
    assert name == "render.band" and a0 < n0 < n1 < a1


@pytest.mark.parametrize("remat", [False, True])
def test_node_map_of_the_sds_body(remat):
    """The SDS step's body (the SDS graph's) under a fake capture: its
    five phases in order, each closed and holding work, within the body's
    count; under remat_virtual too, where the render's recomputations
    (one inside the forward's band term, one in the backward) open their
    band spans nested inside render and backward."""
    tr = sds_trainer(remat)
    tr.scalars.set(tr.epoch)
    sampler = tr.virtual_sampler(tr._novel_view_scale())
    ops = OpCount()
    with ops, trace.capture_phases(trace.NodeMap(lambda: ops.n)) as m:
        tr._virtual_body(tr.epoch, sampler, tr.draws)
    assert [p[0] for p in m.phases] == list(SDS_SPANS)
    ends = [x for _, a, b in m.phases for x in (a, b)]
    assert ends == sorted(ends) and ends[-1] <= m.device_nodes
    assert all(a < b for _, a, b in m.phases)
    bands = [n for n in m.nested if n[0] == "render.band"]
    assert bands and all(a < b for _, a, b in bands)
    render, grads = m.phases[0], m.phases[3]
    assert all(render[1] < a < b <= render[2] or grads[1] < a < b <= grads[2]
               for _, a, b in bands)


def test_a_failing_node_count_loses_the_map_not_the_body():
    """A node count that raises midway (CUDA refusing a call) leaves the
    map empty, with a warning that says why, and the body runs to its
    end, its spans closed."""
    tr = sds_trainer(False)
    tr.scalars.set(tr.epoch)
    calls = []

    def count():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("cuGraphGetNodes failed: CUresult 1")
        return len(calls)
    with pytest.warns(UserWarning, match="CUresult 1"):
        with trace.capture_phases(trace.NodeMap(count)) as m:
            loss = tr._real_body()
    assert torch.isfinite(loss)
    assert m.phases is None and m.nested is None
    assert m.device_nodes is None
    assert "CUresult 1" in m.lost and len(calls) == 3
    assert trace._capture is None
