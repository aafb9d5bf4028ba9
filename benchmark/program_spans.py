"""Readers of the program's own spans and counters (morpheus_tpu_torch/
trace.py), shared by the per-layer metrics that read them.

- graph_ms: the device busy time of a span inside one of the program's
  step graphs per replay, from the node map that the trainer wrote on the
  graph's capture line (GRAPHS: the real step's and the SDS step's);
- sample_fill: the share of a compacted sample stream's fixed slots that
  held real samples, from the program's counters.

A program without these node maps or counters (one older than them) gives
None, and nothing raises.
"""
from __future__ import annotations

from .trace import busy_us

# the program's CUDA graphs of a step: the harness's span around the step
# method that replays it, and the run record's key that holds the
# trainer's capture lines of that graph (Trainer.captures, .sds_captures)
GRAPHS = {"real": ("chained_real_step", "captures"),
          "sds": ("virtual_step", "sds_captures")}


def graph_replays(tr, span: str, captures) -> tuple | None:
    """(node map, kept replays) of the graph replayed inside span `span`.
    The node map is the newest line of `captures`: the graph that the
    epoch loop replays at the end of the run (the held epoch's key; a
    capture of another key evicts the old graph); None where that line
    has no map (a program older than it, or a map lost). The device
    records launched in the span are grouped by their launch (a replay's
    records share its cudaGraphLaunch's time); a group of exactly
    device_nodes records, sorted by device start, is kept, and its record
    k belongs to the span whose [first, end) holds k. None when fewer than
    half of the span's calls match (the profiler loses a record now and
    then, and a group without it is skipped)."""
    cap = captures[-1] if captures else None
    if tr is None or not cap or not cap.get("phases") \
            or not cap.get("device_nodes"):
        return None
    groups = {}
    for d in tr.in_span(span):
        groups.setdefault(d[3], []).append(d)
    kept = [sorted(g) for g in groups.values()
            if len(g) == cap["device_nodes"]]
    replays = tr.span_calls(span)
    if not replays or 2 * len(kept) < replays:
        return None
    return cap, kept


def graph_ms(run, graph: str, name: str) -> float | None:
    """Device busy ms per replay of span `name` inside graph `graph` (a key
    of GRAPHS): the busy union of each kept replay's records in the span's
    node range (graph_replays). `name` is looked up among the capture
    line's phases, then among its nested spans; the first range of that
    name is read."""
    span, key = GRAPHS[graph]
    got = graph_replays(run.trace, span, run.rec.get(key))
    if got is None:
        return None
    cap, kept = got
    for spans in (cap["phases"], cap.get("nested") or []):
        for n, first, end in spans:
            if n == name:
                return sum(busy_us((s, e) for s, e, _, _ in g[first:end])
                           for g in kept) / len(kept) / 1e3
    return None


def sample_fill(prefix: str) -> float | None:
    """100 x `prefix`.samples_valid / `prefix`.samples_slots over the run
    (the program's trace.read())."""
    try:
        from morpheus_tpu_torch import trace
    except ImportError:
        return None
    c = trace.read()
    if not c.get(prefix + ".samples_slots"):
        return None
    return 100.0 * c.get(prefix + ".samples_valid", 0.0) \
        / c[prefix + ".samples_slots"]
