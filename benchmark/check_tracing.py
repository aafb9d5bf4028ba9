"""Two checks of the program's own tracing (morpheus_tpu_torch/trace.py) on a
card, at each named cell's point:

- node_map: the node map of each of the program's step graphs (the real
  step's and, with guidance, the SDS step's: program_spans.GRAPHS) puts
  each span where the program's spans put it. The graph's body, run
  eagerly under torch.profiler, where each span is a record_function,
  gives each span's device records by name; replays of the captured
  graph, their records split by the node map on the trainer's capture
  line (program_spans.graph_replays, as the *.device_ms metrics read
  them), must give the same names as often, span by span: the phases, the
  nested spans and the records between the phases (the SDS step's view
  draws, resize and keyframe pick). The order is reported (in_order: the
  replays whose order matches) but does not decide, since a graph may run
  records side by side. The eager body must launch as many records as
  the graph holds device nodes and open no span that the map lacks. A
  copy or a fill is named by its kind alone: a graph runs a
  device-to-device copy as a kernel of its own name (memcpy128,
  memcpy32_post) where the eager body's is "Memcpy DtoD". The eager body
  is traced up to three times, and the first trace that holds every
  record is compared (the profiler loses a record now and then; where no
  trace does, the last one). The SDS body runs the UNet's forward as its
  capture does, the body itself: run eagerly on a card, apply_unet would
  replay the UNet's own graph, with its inputs copied in and its output
  cloned.
- cost: what the tracing adds to an epoch with no profiler recording: a
  span's check on the host (a due refresh's occ.refresh; a replay opens
  none); trace.fill on the SDS step's stream and on the real step's
  (device time a call inside a CUDA graph, as a replay runs it); summed
  over an epoch's steps and due refreshes (epoch_ms). And while a profiler
  records the host and the card: a span's record_function on the host,
  over the epoch's due refreshes (traced_epoch_ms).

    python3 benchmark/check_tracing.py snoopy_sds.e300 snoopy_sds.e1900 \\
        [--seed N] [--replays 30]

Each cell's program is built as a run's set-up builds it, its guidance
from the seed, at the cell's epoch; the first of its chained real steps
and of its SDS steps captures each graph. One `node_map: {json}` line a
graph and one `cost: {json}` line a cell; exits 1 where a span differs or
no replay matched.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from collections import Counter

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, inputs, program_spans  # noqa: E402
from benchmark.trace import Trace, traced  # noqa: E402

# traces of an eager body, at most, until one holds every record
EAGER_TRIES = 3
# the span around the traced function, and the name under which the
# records of a body that lie in none of its phases are compared
BODY, BETWEEN = "check.body", "(between phases)"


def profiled(fn) -> Trace:
    """fn() in a traced window of its own, inside span BODY, after one
    small kernel: the profiler can lose a window's first device record."""
    with traced(True) as box:
        with torch.profiler.record_function(harness.WINDOW_SPAN):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            with torch.profiler.record_function(BODY):
                fn()
                torch.cuda.synchronize()
    return Trace(box["prof"], harness.WINDOW_SPAN, (BODY,))


def kind(name: str) -> str:
    """A device record's name, a copy's or a fill's by its kind alone."""
    low = name.lower()
    return next((k for k in ("memcpy", "memset") if low.startswith(k)), name)


def map_spans(cap: dict) -> list:
    """[[name, first, end], ...]: a capture line's phases, then its nested
    spans."""
    return list(cap["phases"]) + list(cap.get("nested") or [])


def between(eager: Trace, cap: dict) -> list:
    """The eager body's records launched in none of the map's phases."""
    inside = {d for name, _, _ in cap["phases"] for d in eager.in_span(name)}
    return [d for d in eager.in_span(BODY) if d not in inside]


def unmapped(eager: Trace, cap: dict) -> list:
    """The spans that the eager body opened and the node map lacks."""
    (b0, b1), = eager.spans[BODY]
    mapped = {name for name, _, _ in map_spans(cap)}
    return sorted(name for name, iv in eager.spans.items()
                  if name not in mapped | {BODY, harness.WINDOW_SPAN}
                  and any(b0 <= s and e <= b1 for s, e in iv))


def holds_all(eager: Trace, cap: dict) -> bool:
    """Whether the eager trace holds as many records as the graph has
    device nodes, and each span of the node map as many as its range."""
    return len(eager.in_span(BODY)) == cap["device_nodes"] and all(
        len(eager.in_span(name)) == end - first
        for name, first, end in map_spans(cap))


def eager_trace(body, cap: dict) -> tuple:
    """(trace, tries): body() traced until a trace holds every record
    (holds_all), at most EAGER_TRIES times; the last trace where none
    does."""
    for tries in range(1, EAGER_TRIES + 1):
        eager = profiled(body)
        if holds_all(eager, cap):
            break
    return eager, tries


def compare(eager: Trace, graph: Trace, captures: list, span: str) -> dict:
    """Each kept replay of the graph replayed in span `span`, its records
    split span by span by the node map of the newest of `captures`,
    against the eager body's records launched inside the same span: the
    same names as often in each span. Their order is compared too but
    does not decide: inside a span the graph may run records side by side
    (cuDNN's FFT convolutions in the VAE fork a branch), and the records
    of a replay are ordered by their start."""
    got = program_spans.graph_replays(graph, span, captures)
    if got is None:
        return {"ok": False, "why": "under half the replays matched"}
    cap, kept = got
    spans = map_spans(cap)
    n = cap["device_nodes"]
    eager_names = {name: [kind(d[2]) for d in sorted(eager.in_span(name))]
                   for name, _, _ in spans}
    eager_names[BETWEEN] = [kind(d[2]) for d in sorted(between(eager, cap))]
    want = {k: Counter(v) for k, v in eager_names.items()}
    ranges = sorted((a, b) for _, a, b in cap["phases"])
    in_phase = {k for a, b in ranges for k in range(a, b)}
    out = {"device_nodes": n, "phases": cap["phases"],
           "nested": cap.get("nested") or [],
           "replays": graph.span_calls(span), "kept": len(kept),
           "eager_records": {k: len(v) for k, v in eager_names.items()},
           "whole": len(eager.in_span(BODY)) == n
           and ranges[0][0] >= 0 and ranges[-1][1] <= n
           and all(b <= c for (_, b), (c, _) in zip(ranges, ranges[1:])),
           "unmapped": unmapped(eager, cap), "in_order": 0, "differ": []}
    for g in kept:
        ordered = True
        parts = [(name, g[first:end]) for name, first, end in spans]
        parts.append((BETWEEN, [d for k, d in enumerate(g)
                                if k not in in_phase]))
        for name, recs in parts:
            names = [kind(d[2]) for d in recs]
            ordered &= names == eager_names[name]
            have = Counter(names)
            if have != want[name]:
                d = {"phase": name,
                     "graph": sorted((have - want[name]).elements())[:2],
                     "eager": sorted((want[name] - have).elements())[:2]}
                if d not in out["differ"]:
                    out["differ"].append(d)
        out["in_order"] += ordered
    g = kept[0]
    out["boundaries"] = {name: {"first": g[first][2][:120],
                                "last": g[end - 1][2][:120]}
                         for name, first, end in spans if end > first}
    out["ok"] = out["whole"] and not out["unmapped"] and not out["differ"]
    out["differ"] = out["differ"][:6]
    return out


def host_us(fn, n: int) -> float:
    """Host us a call of fn, over n calls (the device's work not waited
    for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, n: int) -> float:
    """Device us a call of fn, over n calls between two events."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n * 1e3


def graph_us(fn, n: int, replays: int = 10) -> float:
    """Device us a call of fn inside a CUDA graph of n calls."""
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return device_us(g.replay, replays) / n


def cost(tr, cfg) -> dict:
    """The tracing's cost an epoch of `tr`'s cell, with no profiler."""
    from morpheus_tpu_torch import trace
    kinds = harness.epoch_kinds(cfg, True)
    n_sds, n_real = kinds.count("virtual"), kinds.count("real")
    due = -(-len(kinds) // cfg["tpu"]["occ_update_every"])
    budget = cfg["tpu"]["sample_budget"] or cfg["tpu"]["max_samples_per_ray"]
    sampler = tr.virtual_sampler(tr._novel_view_scale())
    dev = tr.device
    masks = {"sds": torch.rand(budget * sampler.H * sampler.W,
                               device=dev) < 0.99,
             "real": torch.rand(budget * cfg["train"]["real_ray_num"],
                                device=dev) < 0.99}

    def span():
        with trace.span("occ.refresh"):
            pass
    out = {"span_host_us": host_us(span, 100_000),
           "sds_fill_graph_us": graph_us(
               lambda: trace.fill("sds", masks["sds"]), 200),
           "real_fill_graph_us": graph_us(
               lambda: trace.fill("real", masks["real"]), 200),
           "sds_steps": n_sds, "real_steps": n_real, "due_refreshes": due,
           "slots": {k: m.numel() for k, m in masks.items()}}
    out["epoch_ms"] = (n_sds * out["sds_fill_graph_us"]
                       + n_real * out["real_fill_graph_us"]
                       + due * out["span_host_us"]) / 1e3
    out["step_us"] = out["epoch_ms"] * 1e3 / len(kinds)
    with traced(True):
        out["span_traced_us"] = host_us(span, 20_000)
    out["traced_epoch_ms"] = due * out["span_traced_us"] / 1e3
    trace.reset()
    return out


@contextlib.contextmanager
def unet_body(guidance):
    """apply_unet runs the UNet's body eagerly, as it does inside the SDS
    step's capture, in place of a replay of the UNet's own graph."""
    own = guidance.unet_graphs
    guidance.unet_graphs = lambda body, x, t, context, _: body(x, t, context)
    try:
        yield
    finally:
        guidance.unet_graphs = own


def node_map(tr, graph: str, step, body, replays: int) -> dict:
    """check's node_map of one of the trainer's graphs (a key of
    program_spans.GRAPHS): step() twice (its first captures the graph),
    body() eagerly (eager_trace), then `replays` steps in the graph's
    span."""
    span, key = program_spans.GRAPHS[graph]
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    captures = list(getattr(tr, key))
    if not captures or not captures[-1].get("device_nodes"):
        return {"graph": graph, "ok": False, "why": "no node map"}
    eager, tries = eager_trace(body, captures[-1])

    def replayed():
        for _ in range(replays):
            with torch.profiler.record_function(span):
                step()
    out = compare(eager, profiled(replayed), captures, span)
    return {"graph": graph, "eager_tries": tries, **out}


def check(name: str, seed: int, replays: int) -> tuple:
    cell = inputs.load_cell(name)
    cfg = inputs.run_config(cell)
    scene = inputs.make_scene(cfg)
    fstate = inputs.field_state(cfg, scene["num_frames"],
                                float(np.float32(1.01)), seed, "cuda")
    guided = harness.guided(cfg)
    gstate, gfields = harness.guidance_inputs(cell, cfg, seed, "cuda")
    tr = harness.build_program(cell, cfg, scene, fstate, gstate, seed, "cuda",
                               gfields)
    del fstate, gstate
    tr._set_levels(tr._active_levels())
    card = harness.card_line("cuda")

    def real_body():
        tr.scalars.set(tr.epoch)
        tr._real_body()

    maps = [node_map(tr, "real", lambda: tr.chained_real_step(tr.epoch),
                     real_body, replays)]
    if guided:
        sampler = tr.virtual_sampler(tr._novel_view_scale())

        def sds_body():
            tr.scalars.set(tr.epoch)
            with unet_body(tr.guidance):
                tr._virtual_body(tr.epoch, sampler,
                                 tr.dp.view_draws(tr.draws))
        maps.append(node_map(
            tr, "sds", lambda: tr.virtual_step(tr.epoch, sampler), sds_body,
            replays))
    maps = [{"cell": name, "seed": seed, "card": card, **m} for m in maps]
    spent = {"cell": name, "card": card, **cost(tr, cfg)}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return maps, spent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--replays", type=int, default=30)
    args = ap.parse_args(argv)
    from morpheus_tpu_torch import kernels
    kernels.build_all()
    harness.set_tf32(False)
    ok = True
    for i, name in enumerate(args.cells):
        maps, spent = check(name, args.seed + i, args.replays)
        for m in maps:
            print("node_map:", json.dumps(m), flush=True)
            ok &= m["ok"]
        print("cost:", json.dumps(spent), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
