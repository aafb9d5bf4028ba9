"""One run of one cell: set-up, the measured window of the port's epoch
loop, the traced epoch, and the comparison with the plain reference that
decides `correct`.

The window drives Trainer.train_one_epoch of morpheus_tpu_torch, the epoch
loop of `python -m morpheus_tpu_torch`: each real step a replay of the
step's CUDA graph (tpu.chain_steps), each SDS slot a replay of the SDS
step's graph (after the occupancy refresh, eager on a due step).
Set-up builds the trainer from the seed's inputs, puts it at the cell's
epoch and step, and runs one whole epoch untimed, whose first steps are
the ones compared with the reference (compare.CHECKED_STEPS); the window
then calls train_one_epoch back to back, the epoch held, until `seconds`
have passed.

Everything that belongs to a cell, a configuration, its SDS prior or a
per-layer metric is found by name: benchmark/workloads/<cell>.json,
benchmark/configs/<config>.json, benchmark/guidance/<kind>.py (the prior
that guidance.model[0] names: inputs.load_prior), benchmark/metrics/
<metric>.py (a read(run) function) and the manifest, BENCHMARK.json.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import compare, inputs, program_spans
from .trace import Trace, traced

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# module names, compared whole by their top-level part, that a run's process
# may not hold: the JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "morpheus_tpu")
# the benchmark's spans around the trainer's step methods, the SDS virtual
# step and the chained real step: the spans in which the graph readers
# find each graph's replays
VIRTUAL_SPAN, REAL_SPAN = (program_spans.GRAPHS[g][0] for g in ("sds",
                                                                "real"))
SPANS = (VIRTUAL_SPAN, REAL_SPAN)
WINDOW_SPAN = "bench.window"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(name: str, kind: str) -> list:
    """The manifest's `kind` metrics ("end_to_end" or "per_layer") that
    cell `name` reports."""
    return [m for m in manifest()[kind]
            if name in m.get("workloads", [name])]


def load_reader(metric: str):
    """benchmark/metrics/<metric>.py's read(run)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def epoch_kinds(cfg: dict, guided: bool) -> list:
    """The kinds of an epoch's steps in the epoch loop's order ("virtual",
    "real"): a virtual slot runs an SDS step with guidance (past the
    warm-up steps, as every cell is), a real step without."""
    tr = cfg["train"]
    one = (["virtual" if guided else "real"] * tr["virtual_freq"]
           + ["real"] * tr["real_freq"])
    return one * tr["n_iters"]


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Checked:
    """Wraps a trainer's two step methods for its first n steps: each
    step's loss, and after each step the optimizer's step count and first
    moments; the parameters after the n-th. Then the methods are the
    trainer's own again."""

    def __init__(self, trainer, n: int):
        self.trainer, self.n = trainer, n
        self.kinds, self.losses, self.counts, self.mu = [], [], [], []
        self.params = None
        trainer.chained_real_step = self._wrap(trainer.chained_real_step,
                                               "real")
        trainer.virtual_step = self._wrap(trainer.virtual_step, "virtual")

    def _wrap(self, fn, kind):
        def step(*args, **kwargs):
            out = fn(*args, **kwargs)
            if len(self.kinds) >= self.n:      # the epoch loop holds `step`
                return out
            loss = out[0] if isinstance(out, tuple) else out
            t = self.trainer
            self.kinds.append(kind)
            self.losses.append(loss.detach().double().clone())
            self.counts.append(t.optim.step.detach().clone())
            self.mu.append(dict(zip(t.optim.names,
                                    (m.detach().clone() for m in t.optim.mu))))
            if len(self.kinds) == self.n:
                self.params = {n: p.detach().clone()
                               for n, p in zip(t.optim.names, t.params)}
                del t.chained_real_step, t.virtual_step
            return out
        return step

    def record(self) -> dict:
        return {"kinds": self.kinds,
                "losses": [float(x) for x in self.losses],
                "counts": [float(x) for x in self.counts],
                "mu": self.mu, "params": self.params}


def _span(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def guided(cfg: dict) -> bool:
    """Whether the config's virtual slots run SDS steps with guidance."""
    return bool(cfg["guidance"]["model"]) and bool(
        cfg["train"]["virtual_freq"])


def prior(cfg: dict):
    """The configuration's SDS prior (inputs.load_prior), or None without
    guidance; a missing prior's file raises FileNotFoundError."""
    return inputs.load_prior(inputs.prior_kind(cfg)) if guided(cfg) else None


def guidance_inputs(cell, cfg, seed, device) -> tuple:
    """(the SDS prior's weights made from the seed, its spec's fields), or
    (None, None) without guidance."""
    if not guided(cfg):
        return None, None
    kind = inputs.prior_kind(cfg)
    spec = inputs.prior_spec(cell, kind)
    return (inputs.prior_state(kind, spec, seed, device),
            dataclasses.asdict(spec))


def build_program(cell, cfg, scene, fstate, gstate, seed, device,
                  spec_fields=None):
    """The port's trainer at the cell's point: its guidance from the
    prior's weights `gstate` (the prior's program()), its field's
    parameters loaded by name."""
    from morpheus_tpu_torch.data.dataset import DeformDataset
    from morpheus_tpu_torch.train.trainer import Trainer
    guidance = None
    if gstate is not None:
        guidance = prior(cfg).program(gstate, spec_fields, device)
    trainer = Trainer(cfg, DeformDataset(cfg, scene=scene), device=device,
                      seed=inputs.sub_seed(seed, 3), guidance=guidance)
    trainer.load_params(fstate)
    trainer.epoch = cell["epoch"]
    trainer.global_step = trainer.host_step = cell["step"]
    return trainer


def set_tf32(on: bool) -> None:
    """TF32 in float32 matrix products and convolutions. The harness runs
    the program with it off, in the float32 that its config states for the
    field and the VAE: PyTorch's own default, which the program's CLI
    keeps, lets cuDNN convolve float32 in TF32, and the program has no
    option of its own to state it. The control turns it on."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def run_program(cell: dict, cfg: dict, seed: int, seconds: float | None,
                trace: bool, device, t0: float,
                setup_iters: int | None = None) -> dict:
    """Set-up, the window and, with `trace`, the traced epoch, on the port;
    the run's record (the trainer freed). seconds None stops after set-up,
    whose epoch setup_iters cuts to that many iterations."""
    with_guidance = guided(cfg)
    kinds = epoch_kinds(cfg, with_guidance)
    parts, t = {"start": time.perf_counter() - t0}, time.perf_counter()
    if torch.device(device).type == "cuda":
        from morpheus_tpu_torch import kernels
        kernels.build_all()
    parts["kernel_build"], t = time.perf_counter() - t, time.perf_counter()
    scene = inputs.make_scene(cfg)
    bound = float(np.float32(1.01))
    fstate = inputs.field_state(cfg, scene["num_frames"], bound, seed, device)
    gstate, gfields = guidance_inputs(cell, cfg, seed, device)
    parts["inputs"], t = time.perf_counter() - t, time.perf_counter()
    trainer = build_program(cell, cfg, scene, fstate, gstate, seed, device,
                            gfields)
    del gstate, fstate
    parts["trainer"], t = time.perf_counter() - t, time.perf_counter()
    checked = Checked(trainer, compare.CHECKED_STEPS)
    trainer.train_one_epoch(setup_iters)      # set-up: capture, warm-up
    sync(device)
    parts["epoch"] = time.perf_counter() - t
    if len(checked.kinds) < compare.CHECKED_STEPS:
        raise AssertionError("set-up's epoch ran fewer steps than checked")
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if torch.device(device).type == "cuda" else 0)
    rec = {"check": checked.record(), "kinds": kinds, "setup_parts": parts}
    capture_lines(rec, trainer)
    if seconds is None:
        del trainer
        gc.collect()
        return rec

    # ---- the window ----
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec["setup_s"] = time.perf_counter() - t0
    w0 = time.perf_counter()
    epochs, bad, ends = 0, 0, []
    while True:
        loss = trainer.train_one_epoch()
        epochs += 1
        bad += not math.isfinite(loss)
        ends.append(time.perf_counter() - w0)
        if ends[-1] >= seconds:
            break
    sync(device)
    rec["window_s"] = time.perf_counter() - w0
    rec["epochs"] = epochs
    rec["epoch_s"] = [b - a for a, b in zip([0.0] + ends, ends)]
    rec["steps"] = epochs * len(kinds)
    rec["failed_steps"] = bad * len(kinds)
    rec["steps_by_kind"] = {k: epochs * kinds.count(k) for k in set(kinds)}
    if torch.device(device).type == "cuda":
        rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        rec["memory_peak_bytes"] = max(setup_peak, rec["window_peak_bytes"])
    else:
        rec["window_peak_bytes"] = rec["memory_peak_bytes"] = 0

    if trace:
        rec["trace"] = traced_epoch(trainer, device)
    capture_lines(rec, trainer)
    del trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return rec


def capture_lines(rec: dict, trainer) -> None:
    """The trainer's capture lines of its real step's graphs (captures)
    and of its SDS step's (sds_captures), each with the graph's node map,
    as they stand: set-up makes them, and the held epoch's graphs stay."""
    rec["captures"] = list(trainer.captures)
    rec["sds_captures"] = list(trainer.sds_captures)


def traced_epoch(trainer, device) -> Trace:
    """One more epoch under torch.profiler, with the benchmark's spans
    around the trainer's two step methods."""
    trainer.chained_real_step = _span(trainer.chained_real_step, REAL_SPAN)
    trainer.virtual_step = _span(trainer.virtual_step, VIRTUAL_SPAN)
    try:
        sync(device)
        with traced(torch.device(device).type == "cuda") as box:
            with torch.profiler.record_function(WINDOW_SPAN):
                trainer.train_one_epoch()
                sync(device)
    finally:
        del trainer.chained_real_step, trainer.virtual_step
    return Trace(box["prof"], WINDOW_SPAN, SPANS)


def run_reference(cell: dict, cfg: dict, seed: int, device,
                  kinds: list) -> dict:
    """The reference's first len(kinds) steps from the same inputs, each
    counted by FlopCounterMode; its record as Checked gives the program's,
    with the FLOPs of each step."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.step import ReferenceTrainer
    tf32 = torch.backends.cuda.matmul.allow_tf32
    set_tf32(False)
    try:
        scene = inputs.make_scene(cfg)
        bound = float(np.float32(1.01))
        fstate = inputs.field_state(cfg, scene["num_frames"], bound, seed,
                                    device)
        g = p = None
        if "virtual" in kinds:
            p, g = reference_guidance(cell, cfg, seed, device)
        ref = ReferenceTrainer(cfg, scene, fstate, inputs.sub_seed(seed, 3),
                               cell["epoch"], cell["step"], device,
                               guidance=g, prior=p)
        if g is not None:
            p.release(g)
        out = {"kinds": [], "losses": [], "counts": [], "mu": [],
               "flops": []}
        for kind in kinds:
            with FlopCounterMode(display=False) as fc:
                loss = ref.step(kind)
            out["kinds"].append(kind)
            out["losses"].append(float(loss.double()))
            out["counts"].append(float(ref.optim.step))
            out["mu"].append(dict(zip(ref.names,
                                      (m.detach().clone()
                                       for m in ref.optim.mu))))
            out["flops"].append(float(fc.get_total_flops()))
        out["params"] = {n: p.detach().clone()
                         for n, p in zip(ref.names, ref.params)}
        out["params0"] = fstate
        return out
    finally:
        set_tf32(tf32)


def reference_guidance(cell: dict, cfg: dict, seed: int, device) -> tuple:
    """(the SDS prior, the reference's guidance from the same weights as
    the program's, cast as the configuration states)."""
    p, kind = prior(cfg), inputs.prior_kind(cfg)
    spec = inputs.prior_spec(cell, kind)
    return p, p.reference(inputs.prior_state(kind, spec, seed, device), spec,
                          device)


class Run:
    """What a metric's reader reads: the run's record, its trace (None
    without --trace 1), the cell, its config and the card's peaks."""

    def __init__(self, rec: dict, cell: dict, cfg: dict, flops: dict,
                 peaks: dict | None):
        self.rec, self.cell, self.cfg = rec, cell, cfg
        self.trace = rec.get("trace")
        self.flops, self.peaks = flops, peaks


def card_peaks(device) -> dict | None:
    if torch.device(device).type != "cuda":
        return None
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(torch.cuda.get_device_name(device))


def flops_by_kind(ref: dict) -> dict:
    by = {}
    for k, f in zip(ref["kinds"], ref["flops"]):
        by.setdefault(k, []).append(f)
    return {k: sum(v) / len(v) for k, v in by.items()}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", cfg: dict | None = None, t0: float | None = None,
             metrics: dict | None = None) -> dict:
    """One run: the result line's dict. cfg (default: the cell's config)
    and metrics ({"end_to_end": [...], "per_layer": [...]}, default: the
    manifest's for the cell) let a test run a cell of its own."""
    t0 = time.perf_counter() if t0 is None else t0
    cfg = inputs.run_config(cell) if cfg is None else cfg
    if metrics is None:
        metrics = {k: cell_metrics(cell["name"], k)
                   for k in ("end_to_end", "per_layer")}
    cuda = torch.device(device).type == "cuda"
    prior(cfg)                  # before set-up: the prior's file is there
    set_tf32(False)
    rec = run_program(cell, cfg, seed, seconds, trace, device, t0)
    log("captures:", json.dumps(rec["captures"]))
    log("sds captures:", json.dumps(rec["sds_captures"]))
    log("setup parts, s:", json.dumps(rec["setup_parts"]))
    log("window epochs, s:", json.dumps(rec["epoch_s"]))
    n = len(rec["check"]["kinds"])
    ref = run_reference(cell, cfg, seed, device, rec["check"]["kinds"])
    numbers = compare.numbers(rec["check"], ref, n)
    limits = cell["limits"]
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in numbers.items()}
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in numbers.items()) and rec["failed_steps"] == 0
    flops = flops_by_kind(ref)
    del ref
    gc.collect()

    run = Run(rec, cell, cfg, flops, card_peaks(device))
    out_metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in metrics[kind]:
        v = (e2e_value(m["name"], rec) if kind == "end_to_end"
             else load_reader(m["name"])(run))
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(rec["steps"]),
              "failed": int(rec["failed_steps"]), "metrics": out_metrics,
              "device": dev}
    if trace:
        tr = rec["trace"]
        log("graph replays kept, of calls:", json.dumps(replays_kept(rec)))
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps(SPANS)}
    result["compared"] = compared
    return result


def replays_kept(rec: dict) -> dict:
    """{graph: [replays kept, calls of its span]} in the traced epoch, of
    each step graph that the graph_ms readers split (0 kept where none can
    be read: under half matched, or no node map)."""
    tr, out = rec["trace"], {}
    for graph, (span, key) in program_spans.GRAPHS.items():
        got = program_spans.graph_replays(tr, span, rec.get(key))
        out[graph] = [0 if got is None else len(got[1]),
                      tr.span_calls(span)]
    return out


def e2e_value(name: str, rec: dict) -> float:
    if name == "step_ms":
        return rec["window_s"] * 1e3 / rec["steps"]
    if name == "setup_s":
        return rec["setup_s"]
    raise KeyError(f"no end-to-end metric {name!r}")
