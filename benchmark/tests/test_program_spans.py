"""benchmark/program_spans.py on synthetic records: each of the program's
step graphs (the real step's, the SDS step's) has its replays grouped by
launch and split by the node map of its newest capture line, a replay
that lost a record skipped, and None when under half the replays match;
and benchmark/check_tracing.py's comparison of a node map with the eager
body's spans."""
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
    def __init__(self, trace, captures=(), sds_captures=()):
        self.trace = trace
        self.rec = {"captures": list(captures),
                    "sds_captures": list(sds_captures)}


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
                      ["real.update", 4, 5]],
           "nested": [["render.band", 1, 2]]}
# the SDS step's map: the view's draws (node 0) and the resize (node 3)
# lie in no phase; the band term nested in sds.render
SDS_CAPTURE = {"view": [72, 72], "active_levels": 10, "device_nodes": 8,
               "phases": [["sds.render", 1, 3],
                          ["guidance.vae_encode", 4, 5],
                          ["guidance.unet", 5, 6], ["sds.grads", 6, 7],
                          ["sds.update", 7, 8]],
               "nested": [["render.band", 2, 3]]}
GRAPH = {"real": ("chained_real_step", CAPTURE, "real.render"),
         "sds": ("virtual_step", SDS_CAPTURE, "sds.render")}


def graph_run(graph, trace, caps):
    return (Run(trace, caps) if graph == "real"
            else Run(trace, [CAPTURE], caps))


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
    assert ps.graph_ms(run, "real", "real.render") == pytest.approx(
        (3 + 4) / 2 / 1e3)
    assert ps.graph_ms(run, "real", "real.backward") == pytest.approx(
        (7 + 10) / 2 / 1e3)
    assert ps.graph_ms(run, "real", "real.update") == pytest.approx(
        (5 + 10) / 2 / 1e3)
    assert ps.graph_ms(run, "real", "render.band") == pytest.approx(
        (2 + 2) / 2 / 1e3)
    assert ps.graph_ms(run, "real", "occ.refresh") is None
    # without a node map (a program older than it) nothing is read
    assert ps.graph_ms(Run(run.trace, [{"active_levels": 10}]), "real",
                       "real.render") is None
    assert ps.graph_ms(Run(None, [CAPTURE]), "real", "real.render") is None


def sds_trace(durations, extra=()):
    """SDS replays launched at 100, 200, ... inside virtual_step spans,
    each after the held timestep's draw (its own launch, 5 us earlier),
    with `extra` records."""
    dev, spans = list(extra), []
    for k, ds in enumerate(durations, start=1):
        dev.append((100 * k + 2, 100 * k + 3, "randint", 100 * k - 5))
        dev += replay(100 * k + 10, 100 * k, ds)
        spans.append((100 * k - 10, 100 * k + 90))
    return make_trace(dev, {"virtual_step": spans,
                            "bench.window": [(0, 100 * len(durations)
                                              + 100)]},
                      (0, 100 * len(durations) + 100))


def test_sds_replays_split_by_the_sds_capture():
    # an eager occupancy refresh before the first replay (launched at 91)
    tr = sds_trace([[1, 2, 3, 4, 5, 6, 7, 8], [2, 2, 2, 2, 2, 2, 2, 10]],
                   extra=[(92, 99, "refresh", 91)])
    run = Run(tr, [CAPTURE], [SDS_CAPTURE])
    want = {"sds.render": (5, 4), "render.band": (3, 2),
            "guidance.vae_encode": (5, 2), "guidance.unet": (6, 2),
            "sds.grads": (7, 2), "sds.update": (8, 10)}
    for name, (a, b) in want.items():
        assert ps.graph_ms(run, "sds", name) == pytest.approx(
            (a + b) / 2 / 1e3), name
    # the real step's graph is not in this trace
    assert ps.graph_ms(run, "real", "real.render") is None
    # a program older than the SDS step's capture lines
    assert ps.graph_ms(Run(tr, [CAPTURE]), "sds", "sds.render") is None


def test_the_newest_sds_capture_line_is_read():
    tr = sds_trace([[1, 2, 3, 4, 5, 6, 7, 8]] * 2)
    older = dict(SDS_CAPTURE, view=[180, 180],
                 phases=[["sds.render", 0, 4]] + SDS_CAPTURE["phases"][1:])
    run = Run(tr, [CAPTURE], [older, SDS_CAPTURE])
    assert ps.graph_ms(run, "sds", "sds.render") == pytest.approx(5 / 1e3)
    run = Run(tr, [CAPTURE], [SDS_CAPTURE, older])
    assert ps.graph_ms(run, "sds", "sds.render") == pytest.approx(10 / 1e3)
    # a newest line that lost its map reads nothing, not an older map
    lost = dict(SDS_CAPTURE, phases=None, nested=None, device_nodes=None)
    run = Run(tr, [CAPTURE], [SDS_CAPTURE, lost])
    assert ps.graph_ms(run, "sds", "sds.render") is None


@pytest.mark.parametrize("graph", ["real", "sds"])
def test_a_replay_that_lost_a_record_is_skipped(graph):
    span, cap, phase = GRAPH[graph]
    n = cap["device_nodes"]
    lost = replay(310, 300, [1] * n)
    del lost[2]
    dev = (replay(110, 100, list(range(1, n + 1)))
           + replay(210, 200, list(range(1, n + 1))) + lost)
    spans = {span: [(99, 199), (199, 299), (299, 399)]}
    run = graph_run(graph, make_trace(dev, spans, (0, 400)), [cap])
    # the two whole replays alone: their records in the phase's range
    # (1 + 2 of the real step's, 2 + 3 of the SDS step's), not the
    # third's ones
    _, first, end = next(p for p in cap["phases"] if p[0] == phase)
    assert ps.graph_ms(run, graph, phase) == pytest.approx(
        sum(range(first + 1, end + 1)) / 1e3)


@pytest.mark.parametrize("graph", ["real", "sds"])
def test_none_when_under_half_the_replays_match(graph):
    span, cap, _ = GRAPH[graph]
    n = cap["device_nodes"]
    dev = replay(110, 100, [1] * (n - 1) + [5])
    for k in range(2, 4):
        lost = replay(100 * k + 10, 100 * k, [1] * n)
        del lost[0]
        dev += lost
    spans = {span: [(99, 199), (199, 299), (299, 399)]}
    last = cap["phases"][-1][0]
    run = graph_run(graph, make_trace(dev, spans, (0, 400)), [cap])
    assert ps.graph_ms(run, graph, last) is None
    # one of two matching is half: read
    spans = {span: [(99, 199), (199, 299)]}
    run = graph_run(graph, make_trace(dev[:2 * n - 1], spans, (0, 400)),
                    [cap])
    assert ps.graph_ms(run, graph, last) == pytest.approx(5 / 1e3)


def test_real_readings_do_not_change_with_an_sds_capture():
    real = (replay(1010, 1000, [1, 2, 3, 4, 5])
            + replay(1110, 1100, [2, 2, 6, 4, 10]))
    real_spans = {"chained_real_step": [(999, 1099), (1099, 1199)]}
    names = ["real.render", "real.backward", "real.update", "render.band"]
    alone = Run(make_trace(real, dict(real_spans, **{
        "bench.window": [(0, 1300)]}), (0, 1300)), [CAPTURE])
    before = {n: ps.graph_ms(alone, "real", n) for n in names}
    sds = sds_trace([[1, 2, 3, 4, 5, 6, 7, 8]] * 3)
    both = make_trace(sds.device + real, dict(
        real_spans, virtual_step=sds.spans["virtual_step"],
        **{"bench.window": [(0, 1300)]}), (0, 1300))
    run = Run(both, [CAPTURE], [SDS_CAPTURE])
    assert {n: ps.graph_ms(run, "real", n) for n in names} == before
    assert None not in before.values()
    assert ps.graph_ms(run, "sds", "guidance.unet") == pytest.approx(6 / 1e3)


def test_sample_fill_reads_the_programs_counters():
    from morpheus_tpu_torch import trace
    trace.reset()
    assert ps.sample_fill("real") is None
    trace.allocate(("real",), "cpu")
    trace.fill("real", torch.tensor([True, True, False, True]))
    assert ps.sample_fill("real") == pytest.approx(75.0)
    trace.reset()


NAMES = ["a", "b", "c", "d", "e"]
EAGER_SPANS = {"real.render": [(0, 19)], "render.band": [(10, 19)],
               "real.backward": [(20, 39)], "real.update": [(40, 49)],
               "check.body": [(0, 50)], "bench.window": [(0, 50)]}


def eager_trace(names=NAMES, spans=EAGER_SPANS):
    """The eager body: render a, b (b in the band); backward c, d; update
    e, each launched inside its span."""
    return make_trace([(10 * i + 5, 10 * i + 8, n, 10 * i + 1)
                       for i, n in enumerate(names)], spans, (0, 50))


def graph_trace(order):
    dev = []
    for k in range(2):
        dev += [(100 * k + 10 + i, 100 * k + 11 + i, n, 100 * k + 5)
                for i, n in enumerate(order)]
    return make_trace(dev, {"chained_real_step": [(0, 99), (100, 199)],
                            "bench.window": [(0, 200)]}, (0, 200))


def test_node_map_check_compares_names_span_by_span():
    from benchmark import check_tracing
    eager = eager_trace()
    got = check_tracing.compare(eager, graph_trace(NAMES), [CAPTURE],
                                "chained_real_step")
    assert got["ok"] and got["whole"] and got["kept"] == 2
    assert got["in_order"] == 2
    # records that the graph runs side by side inside a span may start in
    # another order: the same names as often
    got = check_tracing.compare(eager, graph_trace(["a", "b", "d", "c", "e"]),
                                [CAPTURE], "chained_real_step")
    assert got["ok"] and got["in_order"] == 0
    # a copy the graph runs as a kernel of its own name is still a copy
    copied = make_trace(
        [(d[0], d[1], "Memcpy DtoD (Device -> Device)" if d[2] == "b"
          else d[2], d[3]) for d in eager.device], eager.spans, (0, 50))
    got = check_tracing.compare(
        copied, graph_trace(["a", "memcpy128", "c", "d", "e"]), [CAPTURE],
        "chained_real_step")
    assert got["ok"]
    assert got["eager_records"] == {"real.render": 2, "real.backward": 2,
                                    "real.update": 1, "render.band": 1,
                                    "(between phases)": 0}
    assert got["boundaries"]["real.backward"] == {"first": "c", "last": "d"}
    # a boundary one record off: the map's render would end at c
    got = check_tracing.compare(
        eager, graph_trace(NAMES),
        [dict(CAPTURE, phases=[["real.render", 0, 3],
                               ["real.backward", 3, 4],
                               ["real.update", 4, 5]])],
        "chained_real_step")
    assert not got["ok"]
    assert got["differ"][0] == {"phase": "real.render", "graph": ["c"],
                                "eager": []}
    # a nested span one record off
    got = check_tracing.compare(
        eager, graph_trace(NAMES),
        [dict(CAPTURE, nested=[["render.band", 0, 2]])],
        "chained_real_step")
    assert not got["ok"] and got["whole"]
    assert got["differ"] == [{"phase": "render.band", "graph": ["a"],
                              "eager": []}]
    # a map that lacks a span the body opened
    got = check_tracing.compare(
        eager, graph_trace(NAMES),
        [dict(CAPTURE, phases=[["real.render", 0, 2],
                               ["real.backward", 2, 4]])],
        "chained_real_step")
    assert not got["ok"] and got["unmapped"] == ["real.update"]
    # overlapping phases
    got = check_tracing.compare(
        eager, graph_trace(NAMES),
        [dict(CAPTURE, phases=[["real.render", 0, 3],
                               ["real.backward", 2, 4],
                               ["real.update", 4, 5]])],
        "chained_real_step")
    assert not got["ok"] and not got["whole"]
    # an eager trace short of the graph's device nodes
    short = make_trace(eager.device[:-1], EAGER_SPANS, (0, 50))
    got = check_tracing.compare(short, graph_trace(NAMES), [CAPTURE],
                                "chained_real_step")
    assert not got["ok"] and not got["whole"]
    # the replays of another span: none match
    got = check_tracing.compare(eager, graph_trace(NAMES), [CAPTURE],
                                "virtual_step")
    assert not got["ok"] and "why" in got


def test_an_eager_trace_that_lost_a_record_is_traced_again(monkeypatch):
    from benchmark import check_tracing
    lost = eager_trace(NAMES[:2] + NAMES[3:])       # c lost
    assert len(lost.in_span("check.body")) == 4
    traces = iter([lost, eager_trace(), lost])
    monkeypatch.setattr(check_tracing, "profiled", lambda fn: next(traces))
    assert not check_tracing.holds_all(lost, CAPTURE)
    got, tries = check_tracing.eager_trace(lambda: None, CAPTURE)
    assert tries == 2 and check_tracing.holds_all(got, CAPTURE)
    # never whole: the last of EAGER_TRIES traces
    traces = iter([lost] * check_tracing.EAGER_TRIES)
    got, tries = check_tracing.eager_trace(lambda: None, CAPTURE)
    assert tries == check_tracing.EAGER_TRIES and got is lost


def test_node_map_check_compares_the_records_between_phases():
    """The SDS step's map leaves records out of its phases (the view's
    draws, the resize): they are compared with the eager body's records
    launched in no phase."""
    from benchmark import check_tracing
    names = ["draw", "render", "band", "resize", "vae", "unet", "grads",
             "update"]
    spans = {"sds.render": [(10, 29)], "render.band": [(20, 29)],
             "guidance.vae_encode": [(40, 49)],
             "guidance.unet": [(50, 59)], "sds.grads": [(60, 69)],
             "sds.update": [(70, 79)], "check.body": [(0, 80)],
             "bench.window": [(0, 80)]}
    eager = make_trace([(10 * i + 5, 10 * i + 8, n, 10 * i + 1)
                        for i, n in enumerate(names)], spans, (0, 80))

    def graph(order):
        dev = []
        for k in range(2):
            dev += [(100 * k + 10 + i, 100 * k + 11 + i, n, 100 * k + 5)
                    for i, n in enumerate(order)]
        return make_trace(dev, {"virtual_step": [(0, 99), (100, 199)],
                                "bench.window": [(0, 200)]}, (0, 200))
    assert check_tracing.holds_all(eager, SDS_CAPTURE)
    got = check_tracing.compare(eager, graph(names), [SDS_CAPTURE],
                                "virtual_step")
    assert got["ok"] and got["whole"] and got["in_order"] == 2
    assert got["eager_records"]["(between phases)"] == 2
    # a resize the graph runs as another kernel
    got = check_tracing.compare(
        eager, graph(names[:3] + ["resize2"] + names[4:]), [SDS_CAPTURE],
        "virtual_step")
    assert not got["ok"]
    assert got["differ"] == [{"phase": "(between phases)",
                              "graph": ["resize2"], "eager": ["resize"]}]
