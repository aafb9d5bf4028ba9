"""benchmark/program_spans.py on synthetic records: idle time charged to
the innermost program span, a graph's replays grouped by launch and split
by the node map, a replay that lost a record skipped, and None when under
half the replays match."""
import pytest
import torch

from benchmark import program_spans as ps
from benchmark.trace import Trace, merged


def make_trace(device, spans, window):
    """A Trace of device records (start, end, name, launch time) and host
    spans {name: [(start, end)]}, in us."""
    tr = Trace.__new__(Trace)
    tr.device = list(device)
    tr.spans = {k: list(v) for k, v in spans.items()}
    tr.window = window
    tr.busy = merged((s, e) for s, e, _, _ in tr.device)
    tr.cpu_ops = []
    return tr


class Run:
    def __init__(self, trace, captures=()):
        self.trace = trace
        self.rec = {"captures": list(captures)}


def test_idle_charged_to_the_innermost_program_span():
    # busy [10, 20], [30, 40], [70, 80] in a window [0, 100]: gaps at 0
    # (10 us), 20 (10), 40 (30), 80 (20). sds.grads [15, 60] holds the
    # gaps at 20 and 40, guidance.unet [35, 50] (inside it, opened later)
    # the one at 40; virtual_step, a benchmark span, holds them all and is
    # no program span.
    dev = [(10, 20, "k", 9), (30, 40, "k", 29), (70, 80, "k", 69)]
    spans = {"sds.grads": [(15, 60)], "guidance.unet": [(35, 50)],
             "virtual_step": [(0, 100)], "bench.window": [(0, 100)]}
    run = Run(make_trace(dev, spans, (0, 100)))
    assert ps.idle_by_span(run.trace) == {"sds.grads": 10.0,
                                          "guidance.unet": 30.0}
    assert ps.idle_ms(run, "guidance.unet") == pytest.approx(0.030)
    assert ps.idle_ms(run, "sds.grads") == pytest.approx(0.010)
    assert ps.idle_ms(run, "sds.render") is None      # no calls
    spans["sds.render"] = [(75, 90), (90, 95)]   # 20 us over 2 calls
    run = Run(make_trace(dev, spans, (0, 100)))
    assert ps.idle_ms(run, "sds.render") == pytest.approx(0.010)


def replay(t0, launch, durations, gap=1.0):
    """One replay's records back to back from t0, all launched at
    `launch`."""
    out, t = [], t0
    for d in durations:
        out.append((t, t + d, "k", launch))
        t += d + gap
    return out


CAPTURE = {"active_levels": 10, "device_nodes": 5,
           "phases": [["real.render", 0, 2], ["real.backward", 2, 4],
                      ["real.update", 4, 5]]}


def test_replays_split_by_the_node_map():
    # two replays of 5 records, launched at 100 and 200; an eager refresh
    # kernel launched at 150 inside the span is no replay
    dev = (replay(110, 100, [1, 2, 3, 4, 5])
           + [(160, 170, "refresh", 150)]
           + replay(210, 200, [2, 2, 6, 4, 10]))
    spans = {"chained_real_step": [(99, 199), (199, 299)],
             "bench.window": [(0, 400)]}
    run = Run(make_trace(dev[::-1], spans, (0, 400)),
              [dict(CAPTURE, device_nodes=7, active_levels=8), CAPTURE])
    assert ps.graph_phase_ms(run, "real.render") == pytest.approx(
        (3 + 4) / 2 / 1e3)
    assert ps.graph_phase_ms(run, "real.backward") == pytest.approx(
        (7 + 10) / 2 / 1e3)
    assert ps.graph_phase_ms(run, "real.update") == pytest.approx(
        (5 + 10) / 2 / 1e3)
    # without a node map (a program older than it) nothing is read
    assert ps.graph_phase_ms(Run(run.trace, [{"active_levels": 10}]),
                             "real.render") is None
    assert ps.graph_phase_ms(Run(None, [CAPTURE]), "real.render") is None


def test_a_replay_that_lost_a_record_is_skipped():
    lost = replay(310, 300, [1, 1, 1, 1, 1])
    del lost[2]
    dev = (replay(110, 100, [1, 2, 3, 4, 5]) + replay(210, 200,
                                                      [1, 2, 3, 4, 5])
           + lost)
    spans = {"chained_real_step": [(99, 199), (199, 299), (299, 399)]}
    run = Run(make_trace(dev, spans, (0, 400)), [CAPTURE])
    # the two whole replays alone: 1 + 2 per replay, not the third's 1 + 1
    assert ps.graph_phase_ms(run, "real.render") == pytest.approx(3 / 1e3)


def test_none_when_under_half_the_replays_match():
    dev = replay(110, 100, [1, 2, 3, 4, 5])
    for k in range(2, 4):
        lost = replay(100 * k + 10, 100 * k, [1, 1, 1, 1, 1])
        del lost[0]
        dev += lost
    spans = {"chained_real_step": [(99, 199), (199, 299), (299, 399)]}
    run = Run(make_trace(dev, spans, (0, 400)), [CAPTURE])
    assert ps.graph_phase_ms(run, "real.render") is None
    # one of two matching is half: read
    spans = {"chained_real_step": [(99, 199), (199, 299)]}
    run = Run(make_trace(dev[:9], spans, (0, 400)), [CAPTURE])
    assert ps.graph_phase_ms(run, "real.update") == pytest.approx(5 / 1e3)


def test_sample_fill_reads_the_programs_counters():
    from morpheus_tpu_torch import trace
    trace.reset()
    assert ps.sample_fill("real") is None
    trace.allocate(("real",), "cpu")
    trace.fill("real", torch.tensor([True, True, False, True]))
    assert ps.sample_fill("real") == pytest.approx(75.0)
    trace.reset()


def test_node_map_check_compares_names_phase_by_phase():
    from benchmark import check_tracing
    # the eager body: render a, b; backward c, d; update e, each launched
    # inside its span
    names = ["a", "b", "c", "d", "e"]
    eager = make_trace(
        [(10 * i + 5, 10 * i + 8, n, 10 * i + 1)
         for i, n in enumerate(names)],
        {"real.render": [(0, 19)], "real.backward": [(20, 39)],
         "real.update": [(40, 49)], "bench.window": [(0, 50)]}, (0, 50))

    def graph(order):
        dev = []
        for k in range(2):
            dev += [(100 * k + 10 + i, 100 * k + 11 + i, n, 100 * k + 5)
                    for i, n in enumerate(order)]
        return make_trace(dev, {"chained_real_step": [(0, 99), (100, 199)],
                                "bench.window": [(0, 200)]}, (0, 200))

    got = check_tracing.compare(eager, graph(names), [CAPTURE])
    assert got["ok"] and got["whole"] and got["kept"] == 2
    # a copy the graph runs as a kernel of its own name is still a copy
    copied = make_trace(
        [(d[0], d[1], "Memcpy DtoD (Device -> Device)" if d[2] == "b"
          else d[2], d[3]) for d in eager.device], eager.spans, (0, 50))
    got = check_tracing.compare(
        copied, graph(["a", "memcpy128", "c", "d", "e"]), [CAPTURE])
    assert got["ok"]
    assert got["eager_records"] == {"real.render": 2, "real.backward": 2,
                                    "real.update": 1}
    assert got["boundaries"]["real.backward"] == {"first": "c", "last": "d"}
    # a boundary one record off: the map's render would end at c
    got = check_tracing.compare(
        eager, graph(names),
        [dict(CAPTURE, phases=[["real.render", 0, 3],
                               ["real.backward", 3, 4],
                               ["real.update", 4, 5]])])
    assert not got["ok"]
    assert got["differ"][0] == {"phase": "real.render", "at": 2,
                                "graph": ["c"], "eager": []}
    # a phase that leaves a record out of every range
    got = check_tracing.compare(
        eager, graph(names),
        [dict(CAPTURE, phases=[["real.render", 0, 2],
                               ["real.backward", 2, 4]])])
    assert not got["ok"] and not got["whole"]
