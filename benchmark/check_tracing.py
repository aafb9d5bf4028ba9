"""Two checks of the program's own tracing (morpheus_tpu_torch/trace.py) on a
card, at each named cell's point:

- node_map: the node map of the real step's CUDA graph puts each phase
  where the program's spans put it. The graph's body, run once eagerly
  under torch.profiler, where each span is a record_function, gives each
  phase's device records by name, in order; replays of the captured graph,
  their records split by the node map on the trainer's captures line
  (program_spans.graph_replays, as the real_*.device_ms metrics read them),
  must give the same names in the same order, phase by phase, and the
  phases must hold every record of a replay. A copy or a fill is named by
  its kind alone: a graph runs a device-to-device copy as a kernel of its
  own name (memcpy128, memcpy32_post) where the eager body's is "Memcpy
  DtoD".
- cost: what the tracing adds to an epoch with no profiler recording: a
  span's check on the host; trace.fill on the SDS step's stream (eager:
  host time a call, and device time) and on the real step's (device time a
  call inside a CUDA graph, as a replay runs it); summed over an epoch's
  steps, spans and due refreshes (epoch_ms). And while a profiler records
  the host and the card: a span's record_function on the host, over the
  epoch's spans (traced_epoch_ms; a replay opens none).

    python3 benchmark/check_tracing.py snoopy_sds.e300 snoopy_sds.e1900 \\
        [--seed N] [--replays 30]

Each cell's program is built as a run's set-up builds it, without the
guidance (the real step does not use it), at the cell's epoch; its first
chained real step captures the graph. One `node_map: {json}` and one
`cost: {json}` line a cell; exits 1 where a phase differs or no replay
matched.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, inputs, program_spans  # noqa: E402
from benchmark.trace import Trace, traced  # noqa: E402

# the spans an SDS step opens (sds.render, guidance.vae_encode,
# guidance.unet, sds.grads, sds.update); a due refresh opens occ.refresh
SDS_STEP_SPANS = 5


def profiled(fn) -> Trace:
    """fn() in a traced window of its own."""
    with traced(True) as box:
        with torch.profiler.record_function(harness.WINDOW_SPAN):
            fn()
            torch.cuda.synchronize()
    return Trace(box["prof"], harness.WINDOW_SPAN)


def kind(name: str) -> str:
    """A device record's name, a copy's or a fill's by its kind alone."""
    low = name.lower()
    return next((k for k in ("memcpy", "memset") if low.startswith(k)), name)


def compare(eager: Trace, graph: Trace, captures: list) -> dict:
    """Each kept replay's records, phase by phase, against the eager body's
    records launched inside the same span."""
    got = program_spans.graph_replays(
        types.SimpleNamespace(trace=graph, rec={"captures": captures}))
    if got is None:
        return {"ok": False, "why": "under half the replays matched"}
    cap, kept = got
    want = {name: [kind(d[2]) for d in sorted(eager.in_span(name))]
            for name, _, _ in cap["phases"]}
    covered = sorted((a, b) for _, a, b in cap["phases"])
    out = {"device_nodes": cap["device_nodes"], "phases": cap["phases"],
           "replays": graph.span_calls(program_spans.REAL_SPAN),
           "kept": len(kept),
           "eager_records": {k: len(v) for k, v in want.items()},
           "whole": covered[0][0] == 0
           and covered[-1][1] == cap["device_nodes"]
           and all(b == c for (_, b), (c, _) in zip(covered, covered[1:])),
           "differ": []}
    for g in kept:
        for name, first, end in cap["phases"]:
            names = [kind(d[2]) for d in g[first:end]]
            if names != want[name]:
                i = next((i for i, (a, b) in enumerate(zip(names,
                                                           want[name]))
                          if a != b), min(len(names), len(want[name])))
                out["differ"].append({"phase": name, "at": i,
                                      "graph": names[i:i + 2],
                                      "eager": want[name][i:i + 2]})
    g = kept[0]
    out["boundaries"] = {name: {"first": g[first][2][:120],
                                "last": g[end - 1][2][:120]}
                         for name, first, end in cap["phases"]}
    out["ok"] = out["whole"] and not out["differ"]
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
    budget = cfg["tpu"]["sample_budget"]
    sampler = tr.virtual_sampler(tr._novel_view_scale())
    dev = tr.device
    masks = {"sds": torch.rand(budget * sampler.H * sampler.W,
                               device=dev) < 0.99,
             "real": torch.rand(budget * cfg["train"]["real_ray_num"],
                                device=dev) < 0.99}

    def span():
        with trace.span("sds.render"):
            pass
    out = {"span_host_us": host_us(span, 100_000),
           "sds_fill_host_us": host_us(
               lambda: trace.fill("sds", masks["sds"]), 2000),
           "sds_fill_device_us": device_us(
               lambda: trace.fill("sds", masks["sds"]), 2000),
           "real_fill_graph_us": graph_us(
               lambda: trace.fill("real", masks["real"]), 200),
           "sds_steps": n_sds, "real_steps": n_real, "due_refreshes": due,
           "slots": {k: m.numel() for k, m in masks.items()}}
    out["epoch_ms"] = (n_sds * (out["sds_fill_host_us"]
                                + out["sds_fill_device_us"]
                                + SDS_STEP_SPANS * out["span_host_us"])
                       + n_real * out["real_fill_graph_us"]
                       + due * out["span_host_us"]) / 1e3
    out["step_us"] = out["epoch_ms"] * 1e3 / len(kinds)
    with traced(True):
        out["span_traced_us"] = host_us(span, 20_000)
    out["traced_epoch_ms"] = (n_sds * SDS_STEP_SPANS + due) \
        * out["span_traced_us"] / 1e3
    trace.reset()
    return out


def check(name: str, seed: int, replays: int) -> tuple:
    cell = inputs.load_cell(name)
    cfg = inputs.run_config(cell)
    scene = inputs.make_scene(cfg)
    fstate = inputs.field_state(cfg, scene["num_frames"],
                                float(np.float32(1.01)), seed, "cuda")
    tr = harness.build_program(cell, cfg, scene, fstate, None, seed, "cuda")
    del fstate
    tr._set_levels(tr._active_levels())
    for _ in range(2):                  # the first captures
        tr.chained_real_step(tr.epoch)
    torch.cuda.synchronize()

    def eager_body():
        tr.scalars.set(tr.epoch)
        tr._real_body()

    def replayed():
        for _ in range(replays):
            with torch.profiler.record_function(program_spans.REAL_SPAN):
                tr.chained_real_step(tr.epoch)

    eager = profiled(eager_body)
    graph = profiled(replayed)
    card = harness.card_line("cuda")
    node_map = {"cell": name, "seed": seed, "card": card,
                **compare(eager, graph, list(tr.captures))}
    del eager, graph
    spent = {"cell": name, "card": card, **cost(tr, cfg)}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return node_map, spent


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
        node_map, spent = check(name, args.seed + i, args.replays)
        print("node_map:", json.dumps(node_map), flush=True)
        print("cost:", json.dumps(spent), flush=True)
        ok &= node_map["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
