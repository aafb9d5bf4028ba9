"""Readers of the program's own spans and counters (morpheus_tpu_torch/
trace.py), shared by the per-layer metrics that read them.

- idle_ms: the device's idle time inside the traced window charged to the
  innermost program span open on the host at each idle gap's start (as
  Trace.idle_gaps charges the benchmark's spans), per call of the span;
- graph_phase_ms: the device busy time of each phase of the real step's
  CUDA graph per replay, from the node map that the trainer wrote on its
  captures line;
- sample_fill: the share of a compacted sample stream's fixed slots that
  held real samples, from the program's counters.

A program without these spans or counters (one older than them) gives
None, and nothing raises.
"""
from __future__ import annotations

import bisect

from .trace import busy_us

# the program's spans (morpheus_tpu_torch/trace.py span names)
PROGRAM_SPANS = ("sds.render", "guidance.vae_encode", "guidance.unet",
                 "sds.grads", "sds.update", "occ.refresh", "real.render",
                 "real.backward", "real.update")
REAL_SPAN = "chained_real_step"


def idle_gaps(tr) -> list:
    """(start, length) of each idle gap of the device inside the window,
    in us (Trace.idle_gaps' gaps)."""
    w0, w1 = tr.window
    gaps, last = [], w0
    for s, e in tr.busy:
        if s > last:
            gaps.append((last, min(s, w1) - last))
        last = max(last, e)
        if last >= w1:
            break
    if last < w1:
        gaps.append((last, w1 - last))
    return [(t, g) for t, g in gaps if g > 0]


def idle_by_span(tr, names=PROGRAM_SPANS) -> dict:
    """{span: idle us charged to it}: each gap to the innermost of spans
    `names` open at its start (of the intervals that hold it, the one that
    opened last)."""
    spans = {n: sorted(tr.spans[n]) for n in names if tr.spans.get(n)}
    out = {}
    for t, g in idle_gaps(tr):
        best = None
        for name, iv in spans.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1] and (
                    best is None or iv[i][0] > best[1]):
                best = (name, iv[i][0])
        if best is not None:
            out[best[0]] = out.get(best[0], 0.0) + g
    return out


def idle_ms(run, name: str) -> float | None:
    """Idle ms charged to program span `name`, per call of it."""
    tr = run.trace
    if tr is None or not tr.span_calls(name):
        return None
    return idle_by_span(tr).get(name, 0.0) / 1e3 / tr.span_calls(name)


def graph_replays(run) -> tuple | None:
    """(node map, kept replays) of the real step's CUDA graph. The node map
    is the newest captures line's: the graph that the epoch loop replays at
    the end of the run, at the held epoch's active-level count (a capture
    of another count evicts the old graph). The device records launched in
    the chained real step's span are grouped by their launch (a replay's
    records share its cudaGraphLaunch's time); a group of exactly
    device_nodes records, sorted by device start, is kept, and its record
    k belongs to the phase whose [first, end) holds k. None when fewer
    than half of the replays match (the profiler loses a record now and
    then, and a group without it is skipped)."""
    tr = run.trace
    caps = [c for c in run.rec.get("captures", [])
            if c.get("phases") and c.get("device_nodes")]
    if tr is None or not caps:
        return None
    cap = caps[-1]
    groups = {}
    for d in tr.in_span(REAL_SPAN):
        groups.setdefault(d[3], []).append(d)
    kept = [sorted(g) for g in groups.values()
            if len(g) == cap["device_nodes"]]
    replays = tr.span_calls(REAL_SPAN)
    if not replays or 2 * len(kept) < replays:
        return None
    return cap, kept


def graph_phase_ms(run, phase: str) -> float | None:
    """Device busy ms per replay of the real step graph's `phase`: the busy
    union of each kept replay's records in the phase's node range
    (graph_replays)."""
    got = graph_replays(run)
    if got is None:
        return None
    cap, kept = got
    for name, first, end in cap["phases"]:
        if name == phase:
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
