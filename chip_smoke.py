#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (morpheus_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --kernels-only     # phases 1-4, then stop

    python3 chip_smoke.py --cli-only         # phases 1-2 and 9

    python3 chip_smoke.py --sds-only         # phases 1-2, 8b and 10

    python3 chip_smoke.py --modes-only       # phases 1-2 and 11

    python3 chip_smoke.py --pipeline-only    # phases 1-2 and 12

    python3 chip_smoke.py --dp-only          # phases 1-2 and 13

    python3 chip_smoke.py --dp-cards         # phases 1-2, then data
                                             # parallelism over every card
                                             # (NCCL, the chained step
                                             # graphed on each)

    python3 chip_smoke.py --bench-only       # phases 1-2 and 14

    python3 chip_smoke.py --chain-only       # phases 1-2 and 15

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every hand-written kernel from the sources in this checkout, one
     nvcc per source, all started together;
  3. hold each kernel against its plain PyTorch version on the card, on
     synthetic streams at the shapes the real-view training step gives it
     under its vjp_mode (`hist`, `segsum`, `gather` lines; the sort that
     precedes the segment sum has its own `sort` line, with the route's
     sort and segment sum together as route_ms; each segment sum is also
     checked bit for bit against a second call); the row gather of the
     encode's forward under hist_rows at the benchmark cells' shapes
     (`rows` lines, ROWS_CASES, bit for bit). Each line times the
     kernel, the plain version and one PyTorch library call computing the
     same function: `ms`, `plain_ms` and `library_ms` are device time per
     call (device_ms: k calls back to back, the host kept out), `call_ms`
     is one kernel call with the wrapper's host work included;
  4. double-backward check of the GatherRows / AccumulateRows autograd pair
     under each kernel route (hist_rows, mxu_rows, sort_pallas_rows) on the
     card against the same computation on the CPU;
  5. the main path: Trainer(configs/synthetic_bench.yaml) on the card at full
     width, one epoch from step 0 (the full 128^3 warmup occupancy update)
     and 20 timed real steps from global step 256 (sampled occupancy
     updates at 256 and 272), with every kernel's launch count read; then
     one steady step and one sampled-refresh step with the kernels' calls
     recorded (capture_streams), whose own index streams become kernel
     lines `step_<mode>_<i>` as in phase 3;
  6. where a steady step's time goes: 5 steps that refresh no occupancy,
     traced with torch.profiler (device kernels per step, device busy time,
     the card's idle share, each kernel's and the sorts' device time, per
     step and per launch);
  7. phases 5 and 6 again under tpu.vjp_mode mxu_rows, then
     sort_pallas_rows: one epoch and 10 timed steps from step 256 each (the
     occupancy refreshes run through the mode too), then a 5-step trace;
  8. the main path at a tiny size on the card against the same run on the
     CPU (same parameters, same random draws), under each of the three
     modes;
  8b. the SDS virtual step (sds_phase) at the full width of
     configs/synthetic_full.yaml: the full-size "<random>" Zero123 under
     guidance.compute_dtype bfloat16, 32 frames at 360^2, bg_radius 1.4,
     16 levels, hist_rows; one epoch from step 0, then 5 timed SDS steps at
     each operating point (epoch 300: scale 0.2, 5,184 rays, the deform
     freeze on, so Adam steps; epoch 900: scale 0.5, 32,400 rays, the
     freeze off, so the gradients are carried and a real step folds them
     in) with launches per step, peak memory and a 2-step trace split into
     render, VAE encoder, UNet and Adam (`sds point:` and `sds trace:`
     lines); then one SDS step at scale 0.5 captured under hist_rows,
     mxu_rows and sort_pallas_rows, whose calls become kernel lines
     step_sds_<mode>_<i>; and a tiny SDS run on the card against the CPU;
  9. the trainer CLI (python -m morpheus_tpu_torch) at the widths of
     configs/synthetic_bench.yaml with its frames, epochs and diagnostic
     cadence cut (CLI_CUTS): first one canonical mesh export under
     tpu.vjp_mode mxu_rows, whose first level_gather call becomes the
     kernel line mesh_mxu_rows_0; then 2 epochs of the CLI with the default
     vjp_mode, and the same command with `train --n_epochs 3`, which
     resumes. The artifacts of morpheus.py's epoch loop are checked (meshes,
     test videos, mesh videos, checkpoints, the eval worker's metric_3d.txt
     rows) and the seconds of each part printed (`cli:` line); each CLI run
     reports its kernel launches, counted from 0 in its own process;
  10. the trainer CLI with SDS on configs/synthetic_full.yaml, widths kept,
     depth cut (SDS_CLI_CUTS): one epoch, then a second process resumes;
     finite losses, a guidance panel and checkpoints holding pending_grads
     and host_step are checked (`sds cli:` line). Phases 9 and 10 run side
     by side (one thread each, the card and the host shared): their
     seconds include each other's load;
  11. the training step's other modes (modes_phase): configs/ab_exact.yaml
     at full width (the exact surface-band ladder; `exact:` line with
     exact_step_ms, a trace, kernel lines step_exact_<mode>_<i> under each
     route); configs/synthetic_bench.yaml under the bfloat16 policy
     (`bf16:` line with bf16_step_ms, a trace, kernel lines
     step_bf16_<mode>_<i> under each route, the bf16 table through
     level_gather's bf16 entry); a few steps of each further option
     (mlp_dtype, Adan, the topology field with every dormant smoothness
     term, fd normals, encode_topo, smoothstep; `option` lines) and an SDS
     step under Adan; tiny card-vs-CPU runs of the bf16 policy, the exact
     ladder, Adan and the topology terms; the CLI on configs/ab_exact.yaml
     (`exact cli:` line). Each kernel's entry in the kernels line carries
     its largest exact and bf16 step calls (exact_case, bf16_case) and its
     launches in phase 11 (modes_launches);
  12. the pipeline around training (pipeline_phase): a raw RGB-D capture
     (4 frames at 480x640, the synthetic sphere before a static wall) is
     preprocessed by the port's run_pose_init and preprocess_sequence
     (360x360 virtual cameras), trained by the port's supervisor
     (morpheus_tpu_torch/scripts/run_full_budget.sh, its real card probe)
     at configs/synthetic_bench.yaml width, cut to 1 epoch of 1 iteration,
     with the CLIP eval on a random ViT-B/32 (one finite `==> CLIP=`
     line; row_gather and level_histogram launches and no others), then
     rendered by
     `python -m morpheus_tpu_torch.visualizer --traj 360` under
     tpu.vjp_mode mxu_rows (the background TSDF-fused on the card, 4
     colored 256^3 meshes, 4 PNGs and the mp4); the first level_gather
     call of frame 0's query becomes the kernel line viewer_mxu_rows_0
     (`pipeline:` and `viewer:` lines; the kernels line's viewer_case and
     pipeline_launches);
  13. data parallelism (dp_phase, parallel/sharding.py) on the one card:
     a one-rank NCCL group's trainer against the plain trainer, bit for
     bit, over 3 real steps of configs/synthetic_bench.yaml (then 10 timed
     steps); the one-rank group's chained step (dp_chain): graphed, a
     CUDA graph of the step with its all-reduces replayed, against eager
     over phase 15's two blocks of 10 steps (epochs 100 and 101 from step
     1000, a sampled refresh in the first), bit for bit under
     sort_pallas_rows with deterministic algorithms and within phase 15's
     tolerances under hist_rows and mxu_rows, every kernel of the mode on
     every graphed step, each graph holding its all-reduces; the eager
     and the graphed one-rank step beside the plain graphed step, the
     captures' seconds, pool MB and recorded all-reduces, a traced
     replayed block (`dp chain:` line; the kernels line's
     dp_chain_launches); two ranks sharing the card over gloo at the
     bench's full width (2048 global rays, 1024 a rank): one epoch, 10
     timed steps
     under hist_rows, a step under each vjp_mode with rank 0's kernel
     calls as lines step_dp_<mode>_<i>, two chained blocks (gloo: the
     graph's body, eager), rank 0's one-rank reference of
     the timed steps (losses at rtol 1e-4, parameters within 2*n*lr), the
     replicas equal; then 2 data-parallel SDS steps of
     configs/synthetic_full.yaml at epoch 300 (a 5,184-ray view a rank, the
     full-size "<random>" Zero123 on each), its gradients against the
     mean of the views' own; and the CLI's refusal of `tpu
     --data_parallel 2` on one card (`dp:`, `dp sds:` lines; the kernels
     line's dp_launches and dp_case);
  14. the JAX package's measurement tools, ported (bench_phase): `python -m
     morpheus_tpu_torch.bench` (MORPHEUS_BENCH_NO_PAUSE=1) at bench.py's
     operating point, its last JSON line checked (every real-step field
     finite and > 0, the three default SDS fields present, nothing
     skipped, `device` naming the card) and printed as a `bench:` line;
     then morpheus_tpu_torch.scripts' bench_gather (all five modes, each
     within its stated error, each kernel route's kernels launched),
     profile_step base occ_off late, profile_step --roofline 300,
     trace_step base, profile_sds s02, bench_dense_scale --smoke and the
     entry point's forward render (python -m morpheus_tpu_torch.entry),
     each in its own process with its lines echoed; a failure of any exits
     non-zero; then each kernel on bench_gather's stream (the bench
     point's 10 levels) against its plain version, as in phase 3 (kernel
     lines bench_gather_<mode>; the kernels line's bench_gather_launches
     and bench_gather_case);
  15. (run after phase 11, on its scene; each part's seconds are `lap:`
     lines) tpu.chain_steps (chain_phase): under each vjp_mode and the bf16
     policy, an eager and a graphed trainer of configs/synthetic_bench.yaml
     from the same seed take two blocks of 10 real steps (epochs 100 and
     101 from step 1000: a sampled refresh in the first, 10 then 12 active
     levels, so two captures); their parameters, optimizer slots,
     occupancy grids and generator states are compared, bit for bit under
     sort_pallas_rows with deterministic algorithms (losses too), within
     stated tolerances elsewhere, beside a second eager run; each kernel of the mode ran on every graphed
     step, each replay counting its captured calls; a traced replayed
     block names each kernel as often as its counter says; then the eager
     and the graphed step's real_step_ms, the epoch loop's rays/s of each,
     the captures' seconds and pool memory (`chain:`, `chain timing:`
     lines; the kernels line's chain_launches).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


class Laps:
    """Seconds of each part of a run: laps(name) logs and keeps the
    seconds since the last lap (or since this was made)."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 1)
        self.t = now
        log(f"lap: {name} {self.seconds[name]} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one fn() call, host work included: the card
    is idle when the first event fires, so the wrapper's own host cost (its
    checks, allocations and the launch) is inside the figure."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


SPIN_HZ = 1.98e9                # H100 SXM boost clock: cycles of a spin


def device_ms(fn, k: int = 50, reps: int = 5) -> tuple[float, bool]:
    """Device time of one fn() call: k calls enqueued back to back between
    two events, divided by k; the median of `reps` such runs, after a
    warm-up. A device-side spin (torch.cuda._sleep) queued before the first
    event, twice as long as the host took to queue k calls in the warm-up,
    holds the card until the host has queued them all, so the host's cost
    per call stays out of the figure. Returns (ms, gaps): gaps is True if
    the card reached the first event before the host was done in any run -
    fn then waits for the card itself (the plain twins copy their level
    starts from host memory), and the time includes host gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int((2 * k * host_s + 1e-3) * SPIN_HZ)
    times, gaps = [], False
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(k):
            fn()
        b.record()
        gaps = gaps or a.query()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    return statistics.median(times), gaps


def timings(kernel, plain, library, k: int = 50) -> dict:
    """ms (device time per call), call_ms (one call, host included),
    plain_ms and library_ms (device time) of a kernel line, each device
    time over k calls; host_gaps names the device times that include host
    gaps (see device_ms)."""
    out, gaps = {}, []
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key], gap = (None, False) if fn is None else device_ms(fn, k=k)
        if gap:
            gaps.append(key)
    out["call_ms"] = call_ms(kernel)
    if gaps:
        out["host_gaps"] = gaps
    return out


# the kernels of each vjp_mode's step, and the wrappers that count launches
PATH_KERNELS = {"hist_rows": ("row_gather", "level_histogram"),
                "mxu_rows": ("level_gather", "level_histogram"),
                "sort_pallas_rows": ("row_gather", "segment_sum_sorted")}


def wrappers() -> dict:
    from morpheus_tpu_torch.ops import gather, hist, rows, segsum
    return {"level_histogram": hist.level_histogram,
            "level_gather": gather.level_gather,
            "segment_sum_sorted": segsum.segment_sum_sorted,
            "row_gather": rows.row_gather}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def bench_grid():
    """configs/synthetic_bench.yaml's hash grid: (offsets, level sizes,
    packed prefix levels)."""
    from morpheus_tpu_torch.ops.hashgrid import HashGridSpec
    grid = HashGridSpec(num_levels=16, level_dim=2, base_resolution=16,
                        log2_hashmap_size=15, desired_resolution=128)
    offs = grid.offsets
    sizes = [offs[l + 1] - offs[l] for l in range(16)]
    # the dense prefix that hist_rows packs: levels whose lattice fits
    k_pack = sum(1 for r, n in zip(grid.resolutions, sizes) if r ** 3 <= n)
    return offs, sizes, k_pack


def level_stream(device, g, sizes, Np, clustered: bool = False):
    """Per-level local indices (L, Np) int32, level l in [0, size): uniform
    random, or clustered - runs of one row, of random length 1-64, each
    run's row uniform random (as a ray's neighbouring samples that fall in
    one cell of a coarse level)."""
    import torch
    out = []
    for s in sizes:
        rows = torch.randint(0, s, (Np,), generator=g, device=device,
                             dtype=torch.int32)
        if clustered:
            lens = torch.randint(1, 65, (Np,), generator=g, device=device)
            run = torch.searchsorted(lens.cumsum(0),
                                     torch.arange(Np, device=device),
                                     right=True)
            rows = rows[run]
        out.append(rows)
    return torch.stack(out)


def bound(nbytes: float, ops: float) -> dict:
    """The least time for nbytes over HBM and ops f32 operations."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations"}


def global_rows(local, starts):
    """Flat global rows (L*Np,) int64 of a level-major local index stream."""
    import torch
    st = torch.as_tensor(list(starts), device=local.device).reshape(-1, 1)
    return (local.long() + st).reshape(-1)


def hist_cases(device):
    """The level_histogram calls of one real step at configs/
    synthetic_bench.yaml, on synthetic streams: the hashed tail (11 levels
    of 32768 rows, Np = 8 corners x 40,960 sites: 32,768 samples + 8,192
    smoothness sites) with the fused sdf+color table (C=4) and the sdf-only
    table (C=2); all 16 levels (mxu_rows, C=4); the packed dense prefix (5
    levels, C = 8 corners x 4); the hashed tail at C=4 in runs of equal
    rows (clustered); and one stream whose every update lands on one slot
    of its level. (name, idx, f32 payload, level starts, table rows)."""
    import torch
    offs, sizes, k_pack = bench_grid()
    g = torch.Generator(device=device)
    g.manual_seed(0)
    P = 40960
    cases = []
    for name, lo, hi, C, Np, clustered in (
            ("hashed_c4", k_pack, 16, 4, 8 * P, False),
            ("hashed_c2", k_pack, 16, 2, 8 * P, False),
            # mxu_rows' backward: all 16 levels
            ("all16_c4", 0, 16, 4, 8 * P, False),
            ("packed_c32", 0, k_pack, 32, P, False),
            ("clustered_c4", k_pack, 16, 4, 8 * P, True)):
        idx = level_stream(device, g, sizes[lo:hi], Np, clustered)
        vals = torch.randn(((hi - lo) * Np, C), generator=g, device=device)
        cases.append((name, idx, vals, list(offs[lo:hi]), offs[hi]))
    L = 11
    cases.append(("one_slot", torch.zeros((L, 8 * P), dtype=torch.int32,
                                          device=device),
                  torch.ones((L * 8 * P, 4), device=device),
                  [l * 32768 for l in range(L)], L * 32768))
    return cases


def hist_line(case, idx, vals, starts, n_rows, kw, k: int = 50) -> dict:
    """Phase 3: one level_histogram call against level_histogram_reference
    on the same inputs, then timed. Tolerance: |kernel - plain| <= 1e-5 *
    (histogram of |payload|) + 1e-6 per slot - float32 sums taken in
    another order. The library call is one index_add_ of the payload, cast
    to f32 (rounded to bf16 first where the call asks it), into a fresh f32
    table: the zero-fill and the cast are timed with it."""
    import torch
    from morpheus_tpu_torch.ops import hist
    got = hist.level_histogram(idx, vals, starts, n_rows, **kw)
    ref = hist.level_histogram_reference(idx, vals, starts, n_rows, **kw)
    habs = hist.level_histogram_reference(idx, vals.abs(), starts, n_rows,
                                          **kw)
    err = (got - ref).abs()
    bad = err > 1e-5 * habs + 1e-6
    if bool(bad.any()):
        raise AssertionError(f"level_histogram {case} {vals.dtype} {kw}: "
                             f"{int(bad.sum())} slots off, max err "
                             f"{float(err.max())}")
    (L, Np), C = idx.shape, vals.shape[1]
    N = L * Np
    rows = global_rows(idx, starts)
    rnd = bool(kw.get("round_bf16", False))

    def library():
        v = vals.to(torch.bfloat16) if rnd else vals
        return torch.zeros((n_rows, C), device=vals.device).index_add_(
            0, rows, v.float())

    row = {"case": case, "dtype": str(vals.dtype).split(".")[-1],
           "round_bf16": rnd, "L": L, "Np": Np, "C": C, "rows": n_rows,
           "max_abs_err": float(err.max())}
    row.update(timings(
        lambda: hist.level_histogram(idx, vals, starts, n_rows, **kw),
        lambda: hist.level_histogram_reference(idx, vals, starts, n_rows,
                                               **kw),
        library, k))
    row.update(bound(N * 4 + N * C * vals.element_size() + n_rows * C * 4,
                     N * C))
    log("hist", json.dumps(row))
    return row


def check_hist(device):
    """Phase 3: the synthetic level_histogram cases: f32 and bf16 payloads,
    and f32 payloads rounded to bf16 by the kernel (round_bf16, the step's
    bf16 route)."""
    import torch
    from morpheus_tpu_torch.ops import hist
    rows_out = []
    for name, idx, vals32, starts, n_rows in hist_cases(device):
        for dt, kw in ((torch.float32, {}), (torch.bfloat16, {}),
                       (torch.float32, {"round_bf16": True})):
            rows_out.append(hist_line(name, idx, vals32.to(dt), starts,
                                      n_rows, kw))
    # an empty stream launches nothing and is not counted
    n0 = hist.level_histogram.launches
    empty = hist.level_histogram(torch.zeros((2, 0), dtype=torch.int32,
                                             device=device),
                                 torch.zeros((0, 4), device=device), [0, 8], 16)
    if hist.level_histogram.launches != n0 or bool(empty.any()):
        raise AssertionError("level_histogram counted an empty stream")
    return rows_out


def segsum_cases(device):
    """The segment_sum_sorted calls of one sort_pallas_rows step at configs/
    synthetic_bench.yaml: 16 levels x 8 corners x 40,960 sites = 5,242,880
    rows of the 419,640-row table. The JAX contract (keys sorted, payload in
    their order): fused sdf+color payloads (C=4) and sdf only (C=2), one run
    over the whole stream on the last slot, and a stream whose keys fall
    partly below 0 and past the table. The route form (keys and order from
    the stable sort of the unsorted rows, the f32 payload in the rows' own
    order, read through the order): C=4 and C=2. Also the unsorted rows, for
    the sort's own time. (name, keys, f32 payload, table rows, order)."""
    import torch
    offs, sizes, _ = bench_grid()
    g = torch.Generator(device=device)
    g.manual_seed(1)
    local = level_stream(device, g, sizes, 8 * 40960)
    rows = global_rows(local, offs[:16]).to(torch.int32)
    keys, order = torch.sort(rows, stable=True)
    N, T = rows.numel(), offs[16]
    cases = [(f"sorted_c{C}", keys,
              torch.randn((N, C), generator=g, device=device), T, None)
             for C in (4, 2)]
    cases.append(("one_run", torch.full((N,), T - 1, dtype=torch.int32,
                                        device=device),
                  torch.randn((N, 4), generator=g, device=device), T, None))
    # first half shifted down, second half up: still sorted, an eighth of
    # the table's width outside it at each end
    shift = torch.where(torch.arange(N, device=device) < N // 2, -(T // 8),
                        T // 8).to(torch.int32)
    cases.append(("out_of_range", keys + shift,
                  torch.randn((N, 4), generator=g, device=device), T, None))
    cases += [(f"route_c{C}", keys,
               torch.randn((N, C), generator=g, device=device), T, order)
              for C in (4, 2)]
    return cases, rows


def segsum_line(case, keys, vals, T, kw, k: int = 50) -> dict:
    """Phase 3: one segment_sum_sorted call (keyword arguments kw: order,
    round_bf16) against segment_sum_sorted_reference, and against a second
    call bit for bit (the kernel adds in an order fixed by the shapes), then
    timed. Tolerance: |kernel - plain| <= 1e-5 * (sum of |payload| into the
    slot) + 1e-6 - float32 sums in another order. The library call is one
    index_add_ of the payload, permuted by order and rounded where the call
    asks it, cast to f32, into a fresh f32 table (none where keys fall
    outside the table: index_add_ does not drop them). In the route form,
    permute_ms is the device time of the cast and permutation that the
    route ran before the kernel read through the order."""
    import torch
    from morpheus_tpu_torch.ops import segsum
    got = segsum.segment_sum_sorted(keys, vals, T, **kw)
    again = segsum.segment_sum_sorted(keys, vals, T, **kw)
    if not torch.equal(got, again):
        raise AssertionError(f"segment_sum_sorted {case}: two calls differ "
                             f"in {int((got != again).sum())} values")
    ref = segsum.segment_sum_sorted_reference(keys, vals, T, **kw)
    habs = segsum.segment_sum_sorted_reference(keys, vals.abs(), T, **kw)
    err = (got - ref).abs()
    bad = err > 1e-5 * habs + 1e-6
    if bool(bad.any()):
        raise AssertionError(f"segment_sum_sorted {case} {vals.dtype} {kw}: "
                             f"{int(bad.sum())} slots off, max err "
                             f"{float(err.max())}")
    N, C = vals.shape
    keys64 = keys.long()
    order = kw.get("order")
    rnd = bool(kw.get("round_bf16", False))

    def permuted():
        v = vals.to(torch.bfloat16) if rnd else vals
        return v if order is None else v.index_select(0, order)

    def library():
        return torch.zeros((T, C), device=vals.device).index_add_(
            0, keys64, permuted().float())

    in_table = bool(((keys >= 0) & (keys < T)).all())
    row = {"case": case, "dtype": str(vals.dtype).split(".")[-1],
           "order": order is not None, "round_bf16": rnd, "N": N, "C": C,
           "rows": T, "max_abs_err": float(err.max())}
    row.update(timings(
        lambda: segsum.segment_sum_sorted(keys, vals, T, **kw),
        lambda: segsum.segment_sum_sorted_reference(keys, vals, T, **kw),
        library if in_table else None, k))
    if order is not None:
        row["permute_ms"] = device_ms(permuted, k=k)[0]
    row.update(bound(N * 4 + (0 if order is None else N * 8)
                     + N * C * vals.element_size() + T * C * 4, N * C))
    log("segsum", json.dumps(row))
    return row


def check_segsum(device):
    """Phase 3: the synthetic segment_sum_sorted cases - the JAX contract
    with f32 and bf16 payloads, the route form with an f32 payload rounded
    to bf16 in the load and not - and the sort in front of the kernel."""
    import torch
    from morpheus_tpu_torch.ops import segsum
    rows_out = []
    cases, rows = segsum_cases(device)
    for name, keys, vals32, T, order in cases:
        if order is None:
            forms = ((vals32, {}), (vals32.to(torch.bfloat16), {}))
        else:
            forms = ((vals32, {"order": order, "round_bf16": r})
                     for r in (True, False))
        for vals, kw in forms:
            rows_out.append(segsum_line(name, keys, vals, T, kw))
    # the sort in front of the kernel (ops/hashgrid.py _sorted_segment_sum):
    # stable sort of the rows alone; with the bf16 C=4 payload permuted by
    # its order (the permutation the route made before the kernel read
    # through order); and the route: the sort, then the kernel reading the
    # f32 cotangent through order
    T = cases[0][3]
    ct = torch.randn((rows.numel(), 4), device=device)
    payload = ct.to(torch.bfloat16)

    def sort_and_permute():
        order = torch.sort(rows, stable=True).indices
        return payload.index_select(0, order)

    def route():
        keys, order = torch.sort(rows, stable=True)
        return segsum.segment_sum_sorted(keys, ct, T, order=order,
                                         round_bf16=True)

    sort_row = {"N": rows.numel(), "C": 4, "dtype": "bfloat16",
                "sort_ms": device_ms(lambda: torch.sort(rows, stable=True))[0],
                "sort_and_permute_ms": device_ms(sort_and_permute)[0],
                "route_ms": device_ms(route)[0]}
    log("sort", json.dumps(sort_row))
    n0 = segsum.segment_sum_sorted.launches
    empty = segsum.segment_sum_sorted(
        torch.zeros((0,), dtype=torch.int32, device=device),
        torch.zeros((0, 4), device=device), 16)
    if segsum.segment_sum_sorted.launches != n0 or bool(empty.any()):
        raise AssertionError("segment_sum_sorted counted an empty stream")
    return rows_out, sort_row


def gather_cases(device):
    """The level_gather calls of one mxu_rows step at configs/
    synthetic_bench.yaml, on synthetic streams: 16 levels x Np = 8 corners x
    40,960 sites from the fused sdf+color table (C=4) and the sdf table
    (C=2), one plane (bf16 payload, the bench's) and three (f32); the
    occupancy refresh's 'nearest' queries (16 levels x 32,768 points per
    chunk, C=2, one plane); the C=4 stream in runs of equal rows
    (clustered); and every index on one row."""
    import torch
    offs, sizes, _ = bench_grid()
    g = torch.Generator(device=device)
    g.manual_seed(2)
    T, Np = offs[16], 8 * 40960
    local = level_stream(device, g, sizes, Np)
    emb = {C: torch.randn((T, C), generator=g, device=device) for C in (4, 2)}
    cases = [(f"levels_c{C}_s{S}", local, emb[C], S)
             for C in (4, 2) for S in (1, 3)]
    cases.append(("nearest_c2_s1", level_stream(device, g, sizes, 32768),
                  emb[2], 1))
    cases.append(("clustered_c4_s1", level_stream(device, g, sizes, Np, True),
                  emb[4], 1))
    cases.append(("one_row_c4_s3", torch.zeros_like(local), emb[4], 3))
    return cases, list(offs[:16])


def gather_line(case, local, emb, starts, S, k: int = 50) -> dict:
    """Phase 3: one level_gather call against level_gather_reference, bit
    for bit (both round the same f32 values to nearest even and sum the
    planes in the same order; a bf16 table's values are widened exactly),
    then timed. The library call is one index_select of the same rows (it
    does not round), widened to f32 from a bf16 table."""
    import torch
    from morpheus_tpu_torch.ops import gather
    got = gather.level_gather(local, emb, starts, S)
    ref = gather.level_gather_reference(local, emb, starts, S)
    if not torch.equal(got, ref):
        err = (got - ref).abs()
        raise AssertionError(f"level_gather {case}: {int((err > 0).sum())}"
                             f" values differ, max err {float(err.max())}")
    (L, Np), (T, C) = local.shape, emb.shape
    N = L * Np
    rows = global_rows(local, starts)
    bf16 = emb.dtype == torch.bfloat16
    row = {"case": case, "L": L, "Np": Np, "C": C, "S": S, "rows": T,
           "table": str(emb.dtype).split(".")[-1], "max_abs_err": 0.0}
    row.update(timings(
        lambda: gather.level_gather(local, emb, starts, S),
        lambda: gather.level_gather_reference(local, emb, starts, S),
        lambda: emb.index_select(0, rows).float(), k))
    # two subtractions and two additions per value under three planes of an
    # f32 table; a bf16 table's values are only widened
    row.update(bound(N * 4 + T * C * emb.element_size() + N * C * 4,
                     N * C * (4 if S == 3 and not bf16 else 0)))
    log("gather", json.dumps(row))
    return row


def check_gather(device):
    """Phase 3: the synthetic level_gather cases."""
    cases, starts = gather_cases(device)
    return [gather_line(name, local, emb, starts, S)
            for name, local, emb, S in cases]


# the row_gather calls of the cells' steps at 16 levels (benchmark/, the
# snoopy_sds cells), on synthetic streams of the bench grid: (case, first
# level, levels, Np, C, dtype, k). real_tail: the real step's largest call
# (the hashed tail, 11 x 8 corners x 40,960 samples, 16-byte f32 rows);
# real_packed: its packed dense prefix (5 levels of 128-byte rows, C = 32);
# sds_tail: the 180^2 SDS step's tail (11 x 8 x 648,000); then the bf16
# policy's 8- and 64-byte rows and the sdf-only tail's 8-byte f32 rows
ROWS_CASES = (("real_tail", 5, 11, 8 * 40960, 4, "float32", 50),
              ("real_packed", 0, 5, 40960, 32, "float32", 50),
              ("sds_tail", 5, 11, 8 * 648000, 4, "float32", 10),
              ("real_tail_bf16", 5, 11, 8 * 40960, 4, "bfloat16", 50),
              ("real_packed_bf16", 0, 5, 40960, 32, "bfloat16", 50),
              ("real_sdf_tail", 5, 11, 8 * 8192, 2, "float32", 50))


def rows_cases(device):
    """ROWS_CASES as (case, local, emb, starts, k): uniform random rows of
    each level; a packed case reads a table of the packed levels' rows."""
    import torch
    offs, sizes, _ = bench_grid()
    g = torch.Generator(device=device)
    g.manual_seed(3)
    out = []
    for case, lo, n, Np, C, dtype, k in ROWS_CASES:
        T = offs[16] if lo else offs[n]
        emb = torch.randn((T, C), generator=g, device=device).to(
            getattr(torch, dtype))
        local = level_stream(device, g, sizes[lo:lo + n], Np)
        out.append((case, local, emb, list(offs[lo:lo + n]), k))
    return out


def rows_line(case, local, emb, starts, k: int = 50) -> dict:
    """One row_gather call against row_gather_reference, bit for bit (a
    copy), then timed beside the plain version and index_select of the
    precomputed flat rows (what the route ran before); launches: the
    kernel's calls over the line. The bound reads the indices, the table
    rows the call reads (each once) and writes the output."""
    import torch
    from morpheus_tpu_torch.ops import rows
    n0 = rows.row_gather.launches
    got = rows.row_gather(local, emb, starts)
    if not torch.equal(got, rows.row_gather_reference(local, emb, starts)):
        raise AssertionError(f"row_gather {case}: differs from index_select")
    del got
    (L, Np), (T, C) = local.shape, emb.shape
    N, R = L * Np, C * emb.element_size()
    flat = global_rows(local, starts)
    read = int(torch.unique(flat).numel())     # table rows read, once each
    row = {"case": case, "L": L, "Np": Np, "C": C, "rows": T,
           "row_bytes": R, "table": str(emb.dtype).split(".")[-1],
           "max_abs_err": 0.0}
    row.update(timings(
        lambda: rows.row_gather(local, emb, starts),
        lambda: rows.row_gather_reference(local, emb, starts),
        lambda: emb.index_select(0, flat), k))
    row.update(bound(N * 4 + read * R + N * R, 0))
    row["bound_bytes"] = N * 4 + read * R + N * R
    row["of_bound"] = row["bound_ms"] / row["ms"]
    row["launches"] = rows.row_gather.launches - n0
    log("rows", json.dumps(row))
    return row


def check_rows(device):
    """Phase 3: the row_gather cases."""
    import torch
    out = []
    for case, local, emb, starts, k in rows_cases(device):
        out.append(rows_line(case, local, emb, starts, k))
        del local, emb
        torch.cuda.empty_cache()
    return out


# the names ops/hashgrid.py calls its kernels by
CAPTURED = ("level_histogram", "level_gather", "segment_sum_sorted",
            "row_gather")


def capture_streams(trainer) -> list:
    """The kernel calls of one steady real step and of one sampled-refresh
    step's occupancy refresh, as the step makes them: recorders wrap the
    names in ops/hashgrid.py (which binds the kernels at import) and the
    trainer's refresh, clone every argument and call the real function; the
    originals are restored afterwards (recording). Returns [{"kernel",
    "phase" ("step" or "refresh"), "args", "kw"}], the steady step's calls
    first."""
    calls, phase = [], ["step"]
    refresh = trainer._maybe_update_occ

    def traced_refresh(*args, **kw):
        phase[0] = "refresh"
        try:
            return refresh(*args, **kw)
        finally:
            phase[0] = "step"

    tpu = trainer.config["tpu"]
    every = tpu["occ_update_every"]
    base = max(trainer.global_step, tpu["occ_warmup_steps"])
    base = -(-base // every) * every                  # a sampled refresh
    originals = recording(calls, phase)
    try:
        trainer._maybe_update_occ = traced_refresh
        trainer.global_step = base + 1                 # steady: no refresh
        trainer.real_step(trainer.epoch)
        n_steady = len(calls)
        trainer.global_step = base + every             # refreshes first
        trainer.real_step(trainer.epoch)
    finally:
        restore(originals)
        del trainer._maybe_update_occ
    return calls[:n_steady] + [c for c in calls[n_steady:]
                               if c["phase"] == "refresh"]


def step_lines(mode, calls, prefix: str = "step", k: int = 50) -> dict:
    """Captured calls as kernel lines, case <prefix>_<mode>_<i> (phase 5:
    step_*, the SDS phase: step_sds_*), each device time over k calls."""
    out = {n: [] for n in CAPTURED}
    line = {"level_histogram": lambda name, a, kw: hist_line(name, *a, kw,
                                                             k=k),
            "level_gather": lambda name, a, kw: gather_line(name, *a, k=k),
            "segment_sum_sorted": lambda name, a, kw: segsum_line(name, *a,
                                                                  kw, k=k),
            "row_gather": lambda name, a, kw: rows_line(name, *a, k=k)}
    for i, c in enumerate(calls):
        row = line[c["kernel"]](f"{prefix}_{mode}_{i}", c["args"], c["kw"])
        row["phase"] = c["phase"]
        out[c["kernel"]].append(row)
    return out


def recording(calls: list, phase: list):
    """Recorders on ops/hashgrid.py's kernel names (which bind the kernels
    at import): each call's arguments are cloned into `calls` under the
    current phase[0], then the real function runs. Returns the originals,
    to restore."""
    import torch
    from morpheus_tpu_torch.ops import hashgrid

    def clone(a):
        return a.detach().clone() if isinstance(a, torch.Tensor) else a

    def recorder(name, fn):
        def record(*args, **kw):
            calls.append({"kernel": name, "phase": phase[0],
                          "args": tuple(clone(a) for a in args),
                          "kw": {k: clone(v) for k, v in kw.items()}})
            return fn(*args, **kw)
        return record

    originals = {n: getattr(hashgrid, n) for n in CAPTURED}
    for n, fn in originals.items():
        setattr(hashgrid, n, recorder(n, fn))
    return originals


def restore(originals: dict):
    from morpheus_tpu_torch.ops import hashgrid
    for n, fn in originals.items():
        setattr(hashgrid, n, fn)


def check_double_backward(device):
    """Phase 4: gradient and grad-of-grad through GatherRows / AccumulateRows
    on `device` against the CPU, under each kernel route and both payload
    types (rtol 1e-5, atol 1e-5)."""
    import torch
    from morpheus_tpu_torch.ops.hashgrid import take_rows

    def run(dev, mode, payload):
        g = torch.Generator().manual_seed(1)
        L, Np, C, size = 3, 1000, 4, 300
        emb = torch.randn((L * size, C), generator=g).to(dev).requires_grad_()
        idx = torch.randint(0, size, (L, Np), generator=g).to(dev)
        u = torch.randn((L * size, C), generator=g).to(dev)
        feats = take_rows(emb, idx, [l * size for l in range(L)], mode,
                          payload)
        loss = torch.sin(feats).sum()
        (ge,) = torch.autograd.grad(loss, emb, create_graph=True)
        (h,) = torch.autograd.grad((ge * u).sum(), emb)
        return ge.detach().cpu(), h.cpu()

    for mode in PATH_KERNELS:
        for payload in (None, torch.bfloat16):
            a = run(device, mode, payload)
            b = run(torch.device("cpu"), mode, payload)
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    log("double backward: GatherRows/AccumulateRows under",
        list(PATH_KERNELS), "on", device, "match the CPU")


def main_path(device, ds, mode: str, n_timed: int):
    """Phases 5 and 7: the real-view step at configs/synthetic_bench.yaml
    width under tpu.vjp_mode `mode` (mode_run without its trace): one epoch
    from step 0, then n_timed steps from global step 256, every kernel's
    launches counted per step."""
    from morpheus_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "synthetic_bench.yaml"))
    cfg["tpu"]["vjp_mode"] = mode
    trainer, res = mode_run(device, ds, cfg, f"main path {mode}", n_timed,
                            trace=False)
    med = res["step_ms"]
    result = {"vjp_mode": mode, "real_step_ms": med,
              "rays_per_s": 2048 / (med / 1e3), "steps_timed": n_timed,
              "peak_mem_gb": res["peak_mem_gb"],
              "params_changed": res["params_changed"],
              # over the epoch and the timed steps
              "launches": {k: res["epoch_launches"][k] + v
                           for k, v in res["launches"].items()},
              "card": res["card"]}
    log("main path:", json.dumps(result))
    return trainer, result


def step_trace(trainer, n: int = 5):
    """Phases 6 and 7: trace n steady steps (none refreshes the occupancy
    grid) from global step 257, after one untraced step
    (morpheus_tpu_torch/scripts/trace_step.py's trace_steps, which
    `python -m morpheus_tpu_torch.scripts.trace_step` runs too). Device
    time by name: each kernel of the port, and the sorts (the route's
    stable row sort under sort_pallas_rows; the samples' sorts of the
    marcher on every path)."""
    from morpheus_tpu_torch.scripts.trace_step import trace_steps
    trainer.global_step = 257
    return trace_steps(trainer, n, log=log)


class _HostDraws:
    """Random draws from a CPU generator, moved to `device`: a CPU run and a
    card run then see the same numbers."""

    def __init__(self, device, seed):
        import torch
        self.device = device
        self.g = torch.Generator().manual_seed(seed)

    def uniform(self, name, shape):
        import torch
        return torch.rand(tuple(shape), generator=self.g).to(self.device)

    def normal(self, name, shape):
        import torch
        return torch.randn(tuple(shape), generator=self.g).to(self.device)

    def randint(self, name, shape, low, high):
        import torch
        return torch.randint(low, high, tuple(shape),
                             generator=self.g).to(self.device)


def tiny_config(mode: str, overrides=None) -> dict:
    """A tiny real-step config under tpu.vjp_mode `mode`: a 4-level hash
    grid (one packed dense level, three hashed) on a 4-frame 32x32 scene;
    overrides {section: {key: value}} on top."""
    from morpheus_tpu_torch.config import merge_defaults
    cfg = merge_defaults({
        "data": {"data_dir": "<synthetic>", "synthetic_frames": 4,
                 "synthetic_res": 32},
        "train": {"n_epochs": 8, "real_ray_num": 64, "warm_up_end": 4},
        "model": {"bg_radius": 0.0, "grid_num_levels": 4,
                  "grid_log2_hashmap_size": 10, "grid_base_resolution": 8,
                  "grid_desired_resolution": 32},
        "tpu": {"max_samples_per_ray": 16, "march_steps": 64,
                "occ_resolution": 16, "sample_budget": 8, "band_budget": 2,
                "smooth_budget": 2, "occ_warmup_steps": 2,
                "occ_update_every": 2, "grad_payload": "bfloat16",
                "vjp_mode": mode}})
    for section, kv in (overrides or {}).items():
        cfg[section].update(kv)
    return cfg


def small_reference(device, mode: str, overrides=None, name=None,
                    loss_rtol: float = 1e-3):
    """Phase 8 (and 11d): four real steps of tiny_config(mode, overrides)
    on the card and on the CPU from the same parameters and draws: losses
    at loss_rtol (1e-3: float32 sums in another order), parameters within
    2*n*lr (an optimizer normalised by the gradient's own scale - Adam with
    eps 1e-15, Adan's first step - turns round-off gradients into full-lr
    moves)."""
    import torch
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.train.trainer import Trainer
    cfg = tiny_config(mode, overrides)
    mode = name or mode
    runs = {}
    for dev in (device, torch.device("cpu")):
        tr = Trainer(cfg, load_synthetic(cfg), device=dev,
                     draws=_HostDraws(dev, 5))
        if "state" not in runs:
            runs["state"] = {k: v.detach().cpu() for k, v in
                             tr.field.state_dict().items()}
        tr.load_params(runs["state"])
        tr.epoch = 5
        losses = [float(tr.real_step(tr.epoch)) for _ in range(4)]
        runs[dev.type] = (losses, [p.detach().cpu() for p in tr.params])
    lr = float(tr.curr.learning_rate(5))
    (lg, pg), (lc, pc) = runs[device.type], runs["cpu"]
    for a, b in zip(lg, lc):
        if not abs(a - b) <= loss_rtol * abs(b):
            raise AssertionError(f"{mode}: tiny run losses differ: {lg} vs "
                                 f"{lc}")
    worst = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
    if worst > 2 * 4 * lr:
        raise AssertionError(f"{mode}: tiny run params differ by {worst}")
    log(f"small reference {mode}: card losses {lg}, CPU losses {lc}, max "
        f"param diff {worst} (limit {2 * 4 * lr}, loss rtol {loss_rtol})")
    return {"losses_card": lg, "losses_cpu": lc, "max_param_diff": worst,
            "param_limit": 2 * 4 * lr, "loss_rtol": loss_rtol}


# ---- the SDS virtual step (configs/synthetic_full.yaml) ----------------------

# the two operating points of a full run: (epoch, novel-view scale's config
# key, deform freeze on); trainer.py's _novel_view_scale switches to the
# final scale past epoch 800
SDS_POINTS = ((300, "novel_view_scale", True),
              (900, "novel_view_scale_final", False))
SDS_TIMED = 5


# what each marked window of an SDS step belongs to (the window from a mark
# to the next); unnamed windows are "other" (sampling, resize, losses, the
# gradient checks, the carry)
SDS_PARTS = {"render": "render", "vae_fwd": "vae_encoder", "unet": "unet",
             "vae_bwd": "vae_encoder", "render_bwd": "render",
             "adam": "adam"}


class _Marks:
    """Named points of an SDS step, each marked twice: by a CUDA event (the
    spans between events, on the device's clock, idle included) and by a
    1-cycle spin kernel (torch.cuda._sleep) on the card's timeline, so that
    the profiler's own device intervals can be split (split_busy)."""

    def __init__(self):
        self.names, self.events = [], []

    def __call__(self, name):
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        torch.cuda._sleep(1)
        self.names.append(name)
        self.events.append(e)

    def spans(self) -> dict:
        """Milliseconds between consecutive marks, summed by part."""
        ms = {p: 0.0 for p in ("render", "vae_encoder", "unet", "adam",
                               "other")}
        for name, a, b in zip(self.names, self.events, self.events[1:]):
            ms[SDS_PARTS.get(name, "other")] += a.elapsed_time(b)
        return ms


# the spins that bracket a traced window (sds_trace), ~25 us or more each,
# told apart from the 1-cycle markers (a few us) by their length
BRACKET_CYCLES = 50_000
MARKER_MAX_US = 12.0


def split_busy(kernels, marks: list):
    """Device busy ms per part (SDS_PARTS, and 'other') of each step: the
    profiler's device intervals between consecutive marker kernels, their
    union taken per window. kernels: [(name, start_us, end_us)] of the
    traced window; marks: one _Marks per step, in order. The markers are
    the short spin kernels (the bracket's are long). None when the trace
    does not hold one marker per mark (then the reason is logged)."""
    spins = [k for k in kernels if "spin_kernel" in k[0]]
    markers = [k for k in spins if k[2] - k[1] < MARKER_MAX_US]
    rest = [k for k in kernels if "spin_kernel" not in k[0]]
    names = [n for m in marks for n in m.names]
    if len(markers) != len(names):
        log(f"sds trace: {len(markers)} marker kernels in the trace for "
            f"{len(names)} marks (spin lengths, us: "
            f"{[round(k[2] - k[1], 1) for k in spins]}); busy split not "
            "measured")
        return None
    from morpheus_tpu_torch.scripts.trace_step import busy_us
    out, i = [], 0
    for m in marks:
        part = {p: 0.0 for p in ("render", "vae_encoder", "unet", "adam",
                                 "other")}
        for j in range(len(m.names) - 1):
            lo, hi = markers[i + j][2], markers[i + j + 1][1]
            busy = busy_us([(max(s, lo), min(e, hi)) for _, s, e in rest
                            if e > lo and s < hi])
            part[SDS_PARTS.get(m.names[j], "other")] += busy / 1e3
        out.append(part)
        i += len(m.names)
    return out


def instrument_sds(trainer, marks):
    """Wrap the pieces of the SDS step so that `marks` is called where each
    begins and ends; returns an undo function."""
    from morpheus_tpu_torch import renderer
    from morpheus_tpu_torch.guidance import zero123 as z123
    saved = [(renderer, "render_rays", renderer.render_rays),
             (z123, "vae_encode_sample", z123.vae_encode_sample),
             (z123, "apply_unet", z123.apply_unet),
             (z123, "sds_loss", z123.sds_loss)]

    def around(name, fn):
        def run(*a, **kw):
            marks(name)
            out = fn(*a, **kw)
            marks(name + "_end")
            return out
        return run

    renderer.render_rays = around("render", saved[0][2])
    z123.vae_encode_sample = around("vae_fwd", saved[1][2])
    z123.apply_unet = around("unet", saved[2][2])
    real_sds = saved[3][2]

    def sds(g, draws, pred, *a, **kw):
        # the gradient reaches the rendered image once the VAE encoder's
        # backward is done; the render's backward follows
        pred.register_hook(lambda grad: marks("render_bwd") or grad)
        return real_sds(g, draws, pred, *a, **kw)
    z123.sds_loss = sds
    grads, update = trainer._grads, trainer.optim.update

    def traced_grads(loss):
        marks("vae_bwd")
        out = grads(loss)
        marks("grads_end")
        return out

    def traced_update(*a, **kw):
        marks("adam")
        out = update(*a, **kw)
        marks("adam_end")
        return out
    trainer._grads, trainer.optim.update = traced_grads, traced_update

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del trainer._grads
        del trainer.optim.update
    return undo


def sds_trace(trainer, sampler, epoch: int, n: int = 2) -> dict:
    """n SDS steps under torch.profiler, at global steps that refresh no
    occupancy: the device's busy ms and idle share, the busy ms split into
    render (forward and backward), VAE encoder (forward and backward), UNet,
    Adam and the rest (split_busy over _Marks), the same parts' spans on the
    device's clock (CUDA events, idle included), and the top kernels."""
    import torch
    from morpheus_tpu_torch.scripts.trace_step import busy_us
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    every = trainer.config["tpu"]["occ_update_every"]
    marks = []

    def bracket():
        for _ in range(8):
            torch.cuda._sleep(BRACKET_CYCLES)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # long spins bracket the window: a later profiling session may
        # miss the first kernels of its window
        bracket()
        t0 = time.perf_counter()
        for _ in range(n):
            if trainer.global_step % every == 0:
                trainer.global_step += 1
            marks.append(_Marks())
            undo = instrument_sds(trainer, marks[-1])
            try:
                marks[-1]("step")
                trainer.virtual_step(epoch, sampler)
                marks[-1]("step_end")
            finally:
                undo()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        bracket()
    dev = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda k: k[1])
    if not dev:
        raise AssertionError("the profiler saw no device kernels")
    work = [k for k in dev if "spin_kernel" not in k[0]]
    busy_ms = busy_us([(s_, e_) for _, s_, e_ in work]) / 1e3
    split = split_busy(dev, marks)
    by_name: dict = {}
    for name, s_, e_ in work:
        if "memcpy" in name.lower() or "memset" in name.lower():
            continue
        k = by_name.setdefault(name[:80], [0, 0.0])
        k[0] += 1
        k[1] += (e_ - s_) / 1e3
    for k, (c, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"sds trace: {ms / n:8.3f} ms/step {c / n:7.1f} launches/step  "
            f"{k}")
    spans = [m.spans() for m in marks]
    out = {"steps": n, "step_ms_traced": window_ms / n,
           "kernels_per_step": sum(c for c, _ in by_name.values()) / n,
           "device_busy_ms_per_step": busy_ms / n,
           "device_idle_share": 1.0 - busy_ms / window_ms,
           "busy_ms_per_step_by_part": None if split is None else {
               k: statistics.median(p[k] for p in split) for k in split[0]},
           "span_ms_per_step_by_part": {
               k: statistics.median(p[k] for p in spans) for k in spans[0]}}
    log("sds trace:", json.dumps(out))
    return out


def sds_point(trainer, epoch: int, scale_key: str, freeze: bool,
              n_timed: int) -> dict:
    """n_timed SDS steps at `epoch` and its novel-view scale, each ending in
    torch.cuda.synchronize, with each kernel's launches counted from 0 just
    before the run and read after it; the deform freeze's effect checked
    (on: Adam steps, the frozen groups stay; off: the parameters stay, the
    gradients are carried, and a real step folds them in). Then a short
    traced run."""
    import torch
    from morpheus_tpu_torch.train import optim
    cfg = trainer.config
    trainer.epoch = epoch
    trainer._set_levels(trainer._active_levels())
    scale = trainer._novel_view_scale()
    if scale != cfg["data"][scale_key]:
        raise AssertionError(f"epoch {epoch}: novel-view scale {scale}")
    sampler = trainer.virtual_sampler(scale)
    rays = sampler.H * sampler.W
    if trainer.curr.freeze_deform(epoch) != freeze:
        raise AssertionError(f"epoch {epoch}: freeze is not {freeze}")
    trainer.virtual_step(epoch, sampler)              # untimed first step
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in trainer.params]
    adam_steps = float(trainer.optim.step)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = [], [], {k: [] for k in wrappers()}
    reset_counts()
    for _ in range(n_timed):
        n0 = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.virtual_step(epoch, sampler)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in read_counts().items():
            per_step[k].append(v - n0[k])
        losses.append(float(loss))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"SDS epoch {epoch}: non-finite loss {losses}")
    if min(per_step["level_histogram"]) < 1 \
            or min(per_step["row_gather"]) < 1 or launches["level_gather"] \
            or launches["segment_sum_sorted"]:
        raise AssertionError(f"SDS epoch {epoch}: launches {per_step}")
    names = trainer.optim.names
    moved = {n for n, a, b in zip(names, before, trainer.params)
             if not torch.equal(a, b)}
    frozen = {n for n in names if optim.group_of(n) in optim.FREEZE_GROUPS}
    # the groups every SDS view reaches (the background net only when a
    # view picks it, the pose never)
    reached = {n for n in names if optim.group_of(n) in (
        "sdf_grid", "color_grid", "sdf_net", "color_net", "beta")}
    if freeze:
        if moved & frozen or not reached <= moved \
                or float(trainer.optim.step) != adam_steps + n_timed:
            raise AssertionError(f"SDS epoch {epoch} (freeze on): moved "
                                 f"{sorted(moved)}")
    else:
        carried = {n for n, g in zip(names, trainer.pending)
                   if bool(g.any())}
        if moved or not trainer._pending_live or not reached <= carried:
            raise AssertionError(f"SDS epoch {epoch} (freeze off): moved "
                                 f"{sorted(moved)}, carried "
                                 f"{sorted(carried)}")
        trainer.real_step(epoch)                      # folds them in
        torch.cuda.synchronize()
        if trainer._pending_live or any(bool(g.any())
                                        for g in trainer.pending):
            raise AssertionError("the real step did not fold the carried "
                                 "gradients in")
    med = statistics.median(step_ms)
    out = {"epoch": epoch, "scale": scale, "view": [sampler.H, sampler.W],
           "rays": rays, "freeze": freeze,
           "active_levels": trainer._active_levels(), "sds_step_ms": med,
           "step_ms": step_ms, "losses": losses,
           "peak_mem_gb": peak / 1e9,
           "launches_per_step": {k: v for k, v in per_step.items()
                                 if any(v)},
           "launches": launches, "card": card_line()}
    log("sds point:", json.dumps(out))
    out["trace"] = sds_trace(trainer, sampler, epoch)
    return out


def capture_sds_streams(trainer, epoch: int) -> list:
    """The kernel calls of one SDS step at `epoch` (scale 0.5 past epoch
    800), as the step makes them (recording)."""
    calls = []
    originals = recording(calls, ["sds"])
    try:
        trainer.virtual_step(epoch, trainer.virtual_sampler(
            trainer._novel_view_scale()))
    finally:
        restore(originals)
    return calls


def set_vjp_mode(trainer, mode: str):
    """Switch a trainer's hash-grid route in place (the parameters are the
    same under every route)."""
    trainer.set_spec(grid={"vjp_mode": mode})


def sds_phase(device, ds) -> tuple:
    """The SDS virtual step at configs/synthetic_full.yaml's full width: the
    CLI's "<random>" full-size Zero123 under guidance.compute_dtype
    bfloat16, bg_radius 1.4, all 16 levels, hist_rows. One epoch from step
    0 (its virtual slots run real steps below warm_up_steps, the 128^3
    warmup occupancy with them), then each operating point of SDS_POINTS
    (sds_point), then one SDS step at scale 0.5 with its kernel calls
    captured under hist_rows, mxu_rows and sort_pallas_rows (lines
    step_sds_<mode>_<i>, each device time over 5 calls). Returns (results,
    kernel lines by kernel)."""
    import torch
    from morpheus_tpu_torch.__main__ import build_guidance
    from morpheus_tpu_torch.config import load_config
    from morpheus_tpu_torch.train.trainer import Trainer
    cfg = load_config(os.path.join(HERE, "configs", "synthetic_full.yaml"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = build_guidance(cfg, device, log)
    build_s = time.perf_counter() - t0
    unet_gb = sum(p.numel() * p.element_size()
                  for p in g.unet.parameters()) / 1e9
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, device=device, guidance=g)
    del g
    torch.cuda.synchronize()
    setup = {"guidance_build_s": build_s,
             "trainer_and_embeddings_s": time.perf_counter() - t0,
             "unet_weights_gb": unet_gb,
             "keyframes": int(trainer.embeddings["kf"].numel()),
             "mem_after_setup_gb": torch.cuda.memory_allocated() / 1e9,
             "peak_setup_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("sds setup:", json.dumps(setup))
    trainer.epoch = 1
    t0 = time.perf_counter()
    trainer.train_one_epoch(n_iters=1)                 # 11 real steps
    torch.cuda.synchronize()
    setup["first_epoch_s"] = time.perf_counter() - t0
    trainer.global_step = trainer.host_step = 257
    points = [sds_point(trainer, *p, n_timed=SDS_TIMED) for p in SDS_POINTS]

    rows = {k: [] for k in CAPTURED}
    epoch = SDS_POINTS[-1][0]
    for mode in ("hist_rows", "mxu_rows", "sort_pallas_rows"):
        set_vjp_mode(trainer, mode)
        if trainer.global_step % trainer.config["tpu"]["occ_update_every"] \
                == 0:
            trainer.global_step += 1
        calls = capture_sds_streams(trainer, epoch)
        log(f"captured sds {mode}:", json.dumps(
            [f"{c['kernel']}" for c in calls]))
        want = set(PATH_KERNELS[mode])
        if {c["kernel"] for c in calls} != want:
            raise AssertionError(f"SDS step under {mode} called "
                                 f"{[c['kernel'] for c in calls]}")
        for k, r in step_lines(mode, calls, prefix="step_sds", k=5).items():
            rows[k] += r
        del calls
        torch.cuda.empty_cache()
    trainer.real_step(epoch)                           # folds the carry
    del trainer
    torch.cuda.empty_cache()
    return {"setup": setup, "points": points}, rows


def sds_small_reference(device):
    """A tiny SDS run on the card against the same run on the CPU: the same
    field and guidance weights (the smallest guidance spec with every layer
    type), the same draws, float32: two virtual steps (freeze on, then off)
    and a real step that folds the carry. Losses at rtol 1e-3, parameters
    within 2*n*lr (Adam with eps 1e-15 turns round-off gradients into
    full-lr moves), the carried gradients at rtol 1e-3, atol 1e-3 x their
    largest."""
    import torch
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.guidance.zero123 import (Zero123Guidance,
                                                     Zero123Spec)
    from morpheus_tpu_torch.train.trainer import Trainer
    cfg = tiny_config("hist_rows")
    cfg["train"].update(virtual_freq=1, real_freq=1, warm_up_steps=0,
                        freeze_epoch=4)
    cfg["model"]["bg_radius"] = 1.4
    cfg["data"]["novel_view_scale"] = 0.375
    spec = Zero123Spec(image_size=16, unet_channels=32, unet_mult=(1, 2),
                       unet_heads=2, context_dim=16, clip_width=32,
                       clip_layers=1, clip_heads=2, clip_patch=14, vae_ch=32,
                       vae_mult=(1, 2), vae_res_blocks=1)
    g_cpu = Zero123Guidance.init_random(spec, "cpu", seed=3)
    with torch.no_grad():       # no zero-initialised layer: a real epsilon
        for p in g_cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    state = {k: v.clone() for k, v in g_cpu.state_dict().items()}
    runs, field = {}, None
    for dev in (device, torch.device("cpu")):
        g = Zero123Guidance(spec).to(dev)
        g.load_state_dict(state)
        tr = Trainer(cfg, load_synthetic(cfg), device=dev,
                     draws=_HostDraws(dev, 7), guidance=g)
        if field is None:
            field = {k: v.detach().cpu() for k, v in
                     tr.field.state_dict().items()}
        tr.load_params(field)
        sampler = tr.virtual_sampler(0.375)
        losses = []
        for epoch in (3, 6):
            tr.epoch = epoch
            tr._set_levels(tr._active_levels())
            losses.append(float(tr.virtual_step(epoch, sampler)[0]))
        pending = [p.detach().cpu().clone() for p in tr.pending]
        losses.append(float(tr.real_step(6)))
        runs[dev.type] = (losses, [p.detach().cpu() for p in tr.params],
                          pending)
    lr = float(tr.curr.learning_rate(6))
    (lg, pg, cg), (lc, pc, cc) = runs[device.type], runs["cpu"]
    for a, b in zip(lg, lc):
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"tiny SDS run losses differ: {lg} vs {lc}")
    worst = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
    if worst > 2 * 2 * lr:
        raise AssertionError(f"tiny SDS run params differ by {worst}")
    for a, b in zip(cg, cc):
        if not torch.allclose(a, b, rtol=1e-3,
                              atol=1e-3 * float(b.abs().max()) + 1e-12):
            raise AssertionError("tiny SDS run carried gradients differ by "
                                 f"{float((a - b).abs().max())}")
    log(f"small reference sds: card losses {lg}, CPU losses {lc}, max param "
        f"diff {worst} (limit {4 * lr})")


# the SDS CLI's cuts of configs/synthetic_full.yaml: frames, epochs,
# iterations and the diagnostics' cadence; warm-up off so the first virtual
# slot runs SDS, and one guidance panel (host step 0); every width stays
SDS_CLI_CUTS = {"data": {"synthetic_frames": 2},
                "train": {"n_epochs": 1, "n_iters": 1, "warm_up_steps": 0},
                "exp": {"test_interval": 1, "mesh_interval": 1,
                        "mesh_all_interval": 1, "mesh_all_eval_interval": 1,
                        "ckpt_interval": 0, "save_guidance": True,
                        "save_guide_intervel": 50}}


def sds_cli_phase(workdir: str) -> dict:
    """python -m morpheus_tpu_torch --config configs/synthetic_full.yaml on
    the card with SDS_CLI_CUTS (full-size "<random>" Zero123, bfloat16
    UNet): one epoch, then `train --n_epochs 2`, which resumes. Checks
    finite losses, the guidance panel, and that each checkpoint holds
    pending_grads and host_step; returns the seconds of each part."""
    import glob
    import pickle

    import cv2
    import numpy as np
    import yaml
    with open(os.path.join(HERE, "configs", "synthetic_full.yaml")) as f:
        cfg = yaml.safe_load(f)
    for section, kv in SDS_CLI_CUTS.items():
        cfg[section].update(kv)
    cfg["exp"].update(output=os.path.join(workdir, "exp"), exp_name="sds")
    cfg_path = os.path.join(workdir, "synthetic_full_cli.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    log("sds cli phase: configs/synthetic_full.yaml cut to",
        json.dumps(SDS_CLI_CUTS), "(then train --n_epochs 2)")
    ws = os.path.join(cfg["exp"]["output"], cfg["exp"]["exp_name"])
    runs = [_run_cli(cfg_path, extra, os.path.join(workdir,
                                                   f"sds_cli_{i}.log"))
            for i, extra in enumerate(([], ["train", "--n_epochs", "2"]))]
    for r in runs:
        if "Initialized RANDOM-weight Zero123 guidance (<random>)" not in r:
            raise AssertionError("the CLI built no full-size guidance")
    if f"Resumed from {ws}/models/model_ep_0001.pkl (epoch 1)" not in runs[1]:
        raise AssertionError("the second SDS CLI run did not resume")
    stats = [s for r in runs for s in _json_lines(r, "epoch-stats")]
    losses = [s["loss"] for s in stats]
    if [s["epoch"] for s in stats] != [1, 2] or not all(np.isfinite(losses)):
        raise AssertionError(f"SDS CLI epochs {stats}")
    launches = [_json_lines(r, "kernel-launches")[0] for r in runs]
    if any(n["level_histogram"] < 11 or n["row_gather"] < 11
           for n in launches):
        raise AssertionError(f"SDS CLI kernel launches {launches}")
    panels = glob.glob(os.path.join(ws, "guidance", "000000_zero123_*.png"))
    img = cv2.imread(panels[0]) if panels else None
    if img is None or img.shape != (256, 4 * 256, 3):
        raise AssertionError(f"guidance panel {panels}")
    steps = []
    for e in (1, 2):
        with open(os.path.join(ws, "models", f"model_ep_000{e}.pkl"),
                  "rb") as f:
            st = pickle.load(f)
        if set(st["pending_grads"]) != set(st["params"]):
            raise AssertionError("a checkpoint without pending_grads")
        steps.append((st["host_step"], st["global_step"]))
    if steps != [(11, 11), (22, 22)]:
        raise AssertionError(f"checkpoint (host_step, global_step) {steps}")
    out = {"frames": cfg["data"]["synthetic_frames"],
           "epoch_train_s": [s["train_s"] for s in stats], "losses": losses,
           "kernel_launches": launches, "ckpt_steps": steps,
           "panel": os.path.basename(panels[0]), "card": card_line()}
    log("sds cli:", json.dumps(out))
    return out


# the CLI phase's cuts of configs/synthetic_bench.yaml: frames (2: the eval
# worker's metric and the mesh videos take time per frame), epochs and the
# diagnostics' cadence; every width stays the config's
CLI_CUTS = {"data": {"synthetic_frames": 2},
            "train": {"n_epochs": 2, "n_iters": 1},
            "exp": {"test_interval": 2, "mesh_interval": 1,
                    "mesh_all_interval": 2, "mesh_all_eval_interval": 2}}


def cli_config(workdir: str) -> dict:
    """configs/synthetic_bench.yaml with CLI_CUTS, its workspace under
    workdir: the raw YAML dict the CLI phase writes out."""
    import yaml
    with open(os.path.join(HERE, "configs", "synthetic_bench.yaml")) as f:
        cfg = yaml.safe_load(f)
    for section, kv in CLI_CUTS.items():
        cfg[section].update(kv)
    cfg["exp"].update(output=os.path.join(workdir, "exp"), exp_name="cli")
    return cfg


def capture_mesh_gather(field, path: str, resolution: int = 128,
                        **export_kw) -> tuple:
    """One export_mesh of `field` (its canonical mesh unless export_kw says
    otherwise: t, cano, color_mesh) with every kernel's launches counted
    from 0, and its first level_gather call recorded (the first chunk of the
    dense SDF query; a recorder wraps the name in ops/hashgrid.py, as
    capture_streams does, and is removed afterwards). Returns (recorded
    call's args, launches, export info)."""
    import torch
    from morpheus_tpu_torch import mesh_export
    from morpheus_tpu_torch.ops import hashgrid
    first, real = [], hashgrid.level_gather

    def record(*args):
        if not first:
            first.append(tuple(a.detach().clone()
                               if isinstance(a, torch.Tensor) else a
                               for a in args))
        return real(*args)

    hashgrid.level_gather = record
    try:
        reset_counts()
        info = mesh_export.export_mesh(field, path, resolution=resolution,
                                       **(export_kw or {"cano": True}))[2]
        launches = read_counts()
    finally:
        hashgrid.level_gather = real
    return (first[0] if first else None), launches, info


def check_mesh_gather(device, workdir: str) -> dict:
    """The CLI phase's mesh export under tpu.vjp_mode mxu_rows, where the
    dense SDF query's hash-grid forward is level_gather: a 128^3 canonical
    mesh of a fresh Trainer at configs/synthetic_bench.yaml width (the
    frames cut as in CLI_CUTS), its first chunk's call held against the
    plain twin and timed (line mesh_mxu_rows_0)."""
    from morpheus_tpu_torch.config import merge_defaults
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.train.trainer import Trainer
    cfg = merge_defaults(cli_config(workdir))
    cfg["tpu"]["vjp_mode"] = "mxu_rows"
    trainer = Trainer(cfg, load_synthetic(cfg), device=device)
    args, launches, info = capture_mesh_gather(
        trainer.field, os.path.join(workdir, "mesh_mxu_rows.ply"))
    log("mesh export mxu_rows:", json.dumps({**info, "launches": launches}))
    if args is None or launches["level_gather"] < 8 \
            or launches["level_histogram"] or launches["segment_sum_sorted"]:
        raise AssertionError(f"mesh export under mxu_rows: launches "
                             f"{launches}")
    if info["backend"] != "native" or not info["faces"]:
        raise AssertionError(f"mesh export under mxu_rows: {info}")
    row = gather_line("mesh_mxu_rows_0", *args)
    row["launches"] = launches["level_gather"]
    return row


def _json_lines(text: str, tag: str) -> list:
    return [json.loads(line.split(tag + " ", 1)[1])
            for line in text.splitlines() if tag + " {" in line]


def _run_cli(cfg_path: str, extra: list, out_path: str) -> str:
    """python -m morpheus_tpu_torch on the card with the eval drain of the
    CLI phase; its output (also kept in out_path)."""
    env = dict(os.environ, MORPHEUS_EVAL_DRAIN_S="600")
    cmd = [sys.executable, "-m", "morpheus_tpu_torch", "--config",
           cfg_path] + extra
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        rc = subprocess.run(cmd, cwd=HERE, env=env, stdout=out,
                            stderr=subprocess.STDOUT, timeout=900).returncode
    with open(out_path) as f:
        text = f.read()
    log(f"cli: {' '.join(cmd[1:])} exited {rc} after "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}:\n{text[-4000:]}")
    return text


def check_cli_artifacts(ws: str, frames: int, mesh_epochs, final_epochs,
                        video_epoch: int) -> tuple:
    """The artifacts of morpheus.py's epoch loop in a CLI workspace: the
    canonical meshes of mesh_epochs, every frame's mesh, the mesh videos,
    the checkpoint and a metric_3d.txt row of each final epoch, the test
    videos of video_epoch; no eval worker still running; every mesh with
    faces and a median vertex radius under 1; the real-view test video's
    first frame darker at its centre (the object) than at its corner.
    Returns ({mesh: median vertex radius}, (centre, corner))."""
    import glob

    import cv2
    import numpy as np
    from morpheus_tpu_torch.ops import meshing
    want = (["mesh/init.ply"] + [f"mesh/mesh_{e:04d}.ply" for e in mesh_epochs]
            + [f"mesh_all/mesh_{e:04d}_{i:04d}.ply" for e in final_epochs
               for i in range(frames)]
            + [f"results/test{n}_ep{video_epoch:04d}_{k}.mp4"
               for n in ("", "_180", "_cano", "_360", "_real")
               for k in ("rgb", "depth")]
            + [f"videos/video_{v}_{e:04d}.mp4" for v in ("real", "360")
               for e in final_epochs]
            + [f"models/model_ep_{e:04d}.pkl" for e in final_epochs]
            + ["metric_3d.txt"])
    missing = [p for p in want if not os.path.exists(os.path.join(ws, p))]
    if missing:
        raise AssertionError(f"CLI artifacts missing: {missing}")
    with open(os.path.join(ws, "metric_3d.txt")) as f:
        rows = [line.split(":")[0] for line in f if line.startswith("Ep_")]
    if sorted(rows) != [f"Ep_{e}" for e in final_epochs]:
        raise AssertionError(f"metric_3d.txt rows {rows}")
    if glob.glob(os.path.join(ws, ".eval_inflight_*")):
        raise AssertionError("an eval worker is still running")
    radii = {}
    for p in want:
        if p.endswith(".ply"):
            v, faces, _ = meshing.load_ply(os.path.join(ws, p))
            radii[p] = float(np.median(np.linalg.norm(v, axis=-1)))
            if not len(faces) or not radii[p] < 1.0:
                raise AssertionError(f"{p}: {len(faces)} faces, median "
                                     f"vertex radius {radii[p]}")
    video = f"test_real_ep{video_epoch:04d}_rgb.mp4"
    cap = cv2.VideoCapture(os.path.join(ws, "results", video))
    ok, frame = cap.read()
    cap.release()
    if not ok:
        raise AssertionError(f"{video} did not decode")
    h, w = frame.shape[:2]
    centre = float(frame[h // 2, w // 2].mean())
    corner = float(frame[2, 2].mean())
    if not centre < corner:
        raise AssertionError(f"{video} frame 0: centre {centre} is not "
                             f"darker than its corner {corner}")
    return radii, (centre, corner)


def cli_phase(workdir: str, world: int = 1) -> dict:
    """Phase 9: the trainer CLI (python -m morpheus_tpu_torch) on the card
    at configs/synthetic_bench.yaml width with CLI_CUTS: 2 epochs, then the
    same command with `train --n_epochs 3`, which resumes from epoch 2's
    checkpoint. Checks the artifacts of morpheus.py's epoch loop, the
    meshes, the real-view video, finite losses, the native marcher, one
    log line of the end and the kernel launches each run reports; returns
    the seconds of each part. world > 1: tpu.data_parallel ranks, one
    card each (--dp-cards)."""
    import numpy as np
    import yaml
    cfg = cli_config(workdir)
    cfg["tpu"]["data_parallel"] = world
    cfg_path = os.path.join(workdir, "synthetic_bench_cli.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    log("cli phase: configs/synthetic_bench.yaml cut to", json.dumps(
        CLI_CUTS), "(then train --n_epochs 3)")
    ws = os.path.join(cfg["exp"]["output"], cfg["exp"]["exp_name"])
    runs = [_run_cli(cfg_path, extra, os.path.join(workdir, f"cli_{i}.log"))
            for i, extra in enumerate(([], ["train", "--n_epochs", "3"]))]

    resumed = f"Resumed from {ws}/models/model_ep_0002.pkl (epoch 2)"
    if any(r.count("Training done.") != 1 for r in runs):
        raise AssertionError("a CLI run did not log its end once")
    if "Resumed" in runs[0] or resumed not in runs[1]:
        raise AssertionError("the second CLI run did not resume from epoch 2")
    stats = [_json_lines(r, "epoch-stats") for r in runs]
    if [[s["epoch"] for s in st] for st in stats] != [[1, 2], [3]]:
        raise AssertionError(f"epochs trained: {stats}")
    losses = [s["loss"] for st in stats for s in st]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite CLI losses {losses}")
    exports = [e for r in runs for e in _json_lines(r, "mesh-export")]
    if any(e["backend"] != "native" for e in exports):
        raise AssertionError("the native marcher did not run")
    launches = [_json_lines(r, "kernel-launches")[0] for r in runs]
    for n in launches:     # the default vjp_mode: hist_rows
        if n["level_histogram"] < 10 or n["row_gather"] < 10 \
                or n["level_gather"] or n["segment_sum_sorted"]:
            raise AssertionError(f"CLI kernel launches {launches}")

    radii, (centre, corner) = check_cli_artifacts(
        ws, cfg["data"]["synthetic_frames"], mesh_epochs=(1, 2, 3),
        final_epochs=(2, 3), video_epoch=2)

    with open(os.path.join(ws, "eval_worker.log")) as f:
        evals = [float(s) for s in re.findall(
            r"epoch \d+: done in ([0-9.]+) s", f.read())]
    by_res = {}
    for e in exports:
        by_res.setdefault(e["resolution"], []).append(
            {k: e[k] for k in ("query_s", "march_s", "color_s", "ply_s")})
    out = {"frames": cfg["data"]["synthetic_frames"],
           "size": [cfg["data"]["synthetic_res"]] * 2,
           "rays": cfg["train"]["real_ray_num"],
           "epoch_train_s": [s["train_s"] for st in stats for s in st],
           "losses": losses,
           "mesh_export_s": {
               f"{r}^3": {k: statistics.median(x[k] for x in v)
                          for k in v[0]} | {"exports": len(v)}
               for r, v in sorted(by_res.items())},
           "test_video_s": [x for st in stats for s in st
                            for x in s.get("test_video_s", [])],
           "mesh_video_s": [x for st in stats for s in st
                            for x in s.get("mesh_video_s", [])],
           "eval_worker_epoch_s": evals,
           "kernel_launches": launches,
           "median_vertex_radius": [min(radii.values()),
                                    max(radii.values())],
           "test_real_centre_corner": [centre, corner],
           "world": world, "card": card_line()}
    log("cli:" if world == 1 else "dp cli:", json.dumps(out))
    return out


# ---- phase 11: the training step's other modes ------------------------------

# configs/ab_exact.yaml's and the bf16 policy's timed steps (phase 11a, b)
MODES_TIMED = 10
MLP_BF16_TIMED = 5
OPTION_STEPS = 3
# the step's kernel lines of phase 11: device time over this many calls
# (the exact step's streams are 4-8x the bench step's)
MODES_K = 10

# the tiny card-vs-CPU runs of phase 11d: (name, vjp_mode, overrides, loss
# rtol). The bf16 policy's loss at 2^-7: the card's bf16 GEMM sums the same
# exact products in f32 in another order than the CPU's f32 product, and
# each hidden activation is rounded to bf16, so a sum near a rounding
# boundary lands one bf16 ulp (2^-8) apart and carries through the layers;
# the float32 modes at phase 8's 1e-3
TINY_TOPO = {"train": {"topo_none": False, "normal_dir": True,
                       "normal_smooth_3d_t": 0.1, "deform_smooth": 0.1,
                       "deform_smooth_t": 0.1, "topo_smooth_t": 0.1},
             "model": {"encode_topo": True}}
MODE_REFERENCES = (
    ("bf16_policy", "hist_rows",
     {"tpu": {"compute_dtype": "bfloat16", "grad_payload": "float32"}},
     2.0 ** -7),
    ("exact_ladder", "hist_rows",
     {"tpu": {"sample_budget": 0, "band_budget": 0, "smooth_budget": 0,
              "band_reuse": False, "occ_query_interp": "linear",
              "grad_payload": "float32"}}, 1e-3),
    ("adan", "hist_rows", {"train": {"optim": "adan"}}, 1e-3),
    ("topology", "hist_rows", TINY_TOPO, 1e-3))

# phase 11e: the CLI on configs/ab_exact.yaml, depth cut only
EXACT_CLI_CUTS = {"data": {"synthetic_frames": 2},
                  "train": {"n_epochs": 2, "n_iters": 1},
                  "exp": {"test_interval": 2, "mesh_interval": 1,
                          "mesh_all_interval": 2,
                          "mesh_all_eval_interval": 2}}


def _finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def timed_steps(trainer, n: int, label: str) -> dict:
    """n real steps, each ending in torch.cuda.synchronize, with every
    kernel's launches counted from 0 just before and read after: the step
    times, losses and launches per step; fails on a non-finite loss."""
    import torch
    step_ms, losses, per_step = [], [], {k: [] for k in wrappers()}
    reset_counts()
    for _ in range(n):
        n0 = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.real_step(trainer.epoch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in read_counts().items():
            per_step[k].append(v - n0[k])
        losses.append(float(loss))
    if not _finite(losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    return {"step_ms": statistics.median(step_ms),
            "steps_ms": step_ms, "losses": losses,
            "launches_per_step": per_step, "launches": read_counts()}


def check_launches(label: str, mode: str, per_step: dict):
    """Every kernel of `mode`'s path launched on every step, no other."""
    for k, v in per_step.items():
        if k in PATH_KERNELS[mode]:
            if min(v) < 1:
                raise AssertionError(f"{label}: {k} did not run on every "
                                     f"step: {v}")
        elif any(v):
            raise AssertionError(f"{label}: {k} is not on this path but "
                                 f"launched {v}")


def capture_step(trainer) -> list:
    """The kernel calls of one steady real step (no occupancy refresh), as
    the step makes them (recording)."""
    every = trainer.config["tpu"]["occ_update_every"]
    if trainer.global_step % every == 0:
        trainer.global_step += 1
    calls = []
    originals = recording(calls, ["step"])
    try:
        trainer.real_step(trainer.epoch)
    finally:
        restore(originals)
    return calls


def mode_lines(trainer, prefix: str, modes, rows: dict) -> dict:
    """One steady step captured under each vjp_mode of `modes` (the
    parameters are the same under every route), its calls checked and
    timed as kernel lines <prefix>_<mode>_<i> appended to rows; returns
    {mode: kernels called}."""
    import torch
    called = {}
    for mode in modes:
        set_vjp_mode(trainer, mode)
        calls = capture_step(trainer)
        called[mode] = [c["kernel"] for c in calls]
        log(f"captured {prefix} {mode}:", json.dumps(called[mode]))
        if set(called[mode]) != set(PATH_KERNELS[mode]):
            raise AssertionError(f"{prefix} step under {mode} called "
                                 f"{called[mode]}")
        for k, r in step_lines(mode, calls, prefix=prefix, k=MODES_K).items():
            rows[k] += r
        del calls
        torch.cuda.empty_cache()
    return called


def mode_run(device, ds, cfg, label: str, n_timed: int,
             trace: bool = True) -> tuple:
    """A Trainer of cfg on the card, all levels active: one epoch from
    step 0 (its warmup occupancy update), then n_timed steps from global
    step 256 (timed_steps) and, with `trace`, a 5-step trace. Fails on a
    non-finite loss, on fewer than all but one parameter tensor moved in
    the epoch, and unless each kernel of the route ran on every step and
    no other ran. Returns (trainer, result)."""
    import torch
    from morpheus_tpu_torch.train.trainer import Trainer
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, device=device)
    log(f"{label}: {ds.num_frames} frames at {ds.H}x{ds.W}, "
        f"{sum(p.numel() for p in trainer.params)} parameters, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    trainer.epoch = cfg["train"]["n_epochs"]          # all levels active
    mode = trainer.spec.grid.vjp_mode
    before = [p.detach().clone() for p in trainer.params]
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    loss0 = trainer.train_one_epoch(n_iters=1)
    torch.cuda.synchronize(device)
    epoch_s = time.perf_counter() - t0
    first, n_first = read_counts(), trainer.global_step
    if not _finite([loss0]):
        raise AssertionError(f"{label}: non-finite epoch loss {loss0}")
    for k, v in first.items():
        if (v < n_first) if k in PATH_KERNELS[mode] else v:
            raise AssertionError(f"{label}: {k} launched {v} times in the "
                                 f"epoch's {n_first} steps")
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(before,
                                                          trainer.params))
    if moved < len(before) - 1:
        raise AssertionError(f"{label}: only {moved}/{len(before)} "
                             "parameter tensors changed")
    trainer.global_step = 256                          # past occ warmup
    res = timed_steps(trainer, n_timed, label)
    check_launches(label, mode, res["launches_per_step"])
    res.update(epoch_s=epoch_s, epoch_steps=n_first, epoch_loss=loss0,
               epoch_launches=first,
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               params_changed=f"{moved}/{len(before)}", card=card_line())
    log(f"{label}:", json.dumps(res))
    if trace:
        res["trace"] = step_trace(trainer)
    return trainer, res


def option_steps(device, ds, label: str, cfg, occ, spec=None,
                 n: int = OPTION_STEPS) -> dict:
    """n real steps of a fresh Trainer of cfg (spec: Trainer.set_spec's
    options) from the warmed occupancy grid `occ` at global step 257 (no
    refresh): finite losses, every parameter group the real step trains
    moved, its kernels launched on every step; the loss terms an option
    adds are checked on one more forward."""
    import torch
    from morpheus_tpu_torch.ops import occupancy
    from morpheus_tpu_torch.train import optim
    from morpheus_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, ds, device=device)
    if spec:
        trainer.set_spec(**spec)
    trainer.epoch = cfg["train"]["n_epochs"]
    trainer._set_levels(trainer._active_levels())
    trainer.occ = occupancy.OccupancyState(occs=occ.occs.clone(),
                                           binaries=occ.binaries.clone())
    trainer.global_step = 257
    before = [p.detach().clone() for p in trainer.params]
    res = timed_steps(trainer, n, label)
    check_launches(label, trainer.spec.grid.vjp_mode,
                   res["launches_per_step"])
    names = trainer.optim.names
    moved = {optim.group_of(n) for n, a, b in zip(names, before,
                                                  trainer.params)
             if not torch.equal(a, b)}
    groups = {optim.group_of(n) for n in names}
    if moved != groups:
        raise AssertionError(f"{label}: groups {sorted(groups - moved)} did "
                             "not move")
    if trainer.optim.name != cfg["train"]["optim"] \
            or float(trainer.optim.step) != n:
        raise AssertionError(f"{label}: optimizer {trainer.optim.name} at "
                             f"step {float(trainer.optim.step)}")
    tr = cfg["train"]
    want = [k for w, k in (("normal_smooth_3d_t", "loss_normal_perturb_t"),
                           ("deform_smooth", "loss_deform_perturb"),
                           ("deform_smooth_t", "loss_deform_perturb_t"),
                           ("topo_smooth_t", "loss_topo_perturb_t"))
            if tr[w] > 0]
    if want:
        _, out = trainer._real_loss(trainer.occ, trainer.draws,
                                    trainer.epoch,
                                    trainer.curr.max_level(trainer.epoch))
        terms = {k: float(out[k].detach()) for k in want if k in out}
        if set(terms) != set(want) or not _finite(terms.values()):
            raise AssertionError(f"{label}: loss terms {terms}, want {want}")
        res["terms"] = terms
    res["groups_moved"] = sorted(moved)
    if trainer.spec.mdt == torch.bfloat16:
        res["gemm"] = bf16_gemm_check(trainer)
    log(f"option {label}:", json.dumps(res))
    return res


# the bf16 MLP's GEMM, card against CPU on the same bf16 operands: each
# f32 output and the bias gradient within this share of the largest
# magnitude (both sum the same exact products of bf16 values in f32, in
# another order); the bf16 gradients of the input and the weight within one
# bf16 ulp (2^-7 of each entry's magnitude) of it, as each side rounds its
# f32 product to bf16
GEMM_TOL = 1e-5


def bf16_gemm_check(trainer) -> dict:
    """The mixed-precision MLP product (ops/mlp.py _BF16Linear: the card's
    bf16 GEMM with an f32 output, the f32 bias added in f32) against the
    CPU's f32 product of the same bf16 operands, at the step's own inputs:
    each layer of the sdf and color nets at the inputs one forward of the
    real loss gives it (each layer's input the card's output of the last).
    Forward and the three gradients under one seeded f32 cotangent, at
    GEMM_TOL. The control, the output of a bf16 linear (the product and the
    bias rounded to bf16), is read against the same CPU output and must
    lie outside GEMM_TOL. Returns the worst readings."""
    import torch
    from morpheus_tpu_torch.ops.mlp import _BF16Linear
    field = trainer.step_field
    nets = {"sdf_net": field.sdf_net, "color_net": field.color_net}
    inputs, hooks = {}, []

    def keep(name):
        def hook(mod, args):
            inputs.setdefault(name, args[0].detach().reshape(
                -1, args[0].shape[-1]))
        return hook

    for name, net in nets.items():
        hooks.append(net.register_forward_pre_hook(keep(name)))
    try:
        trainer._real_loss(trainer.occ, trainer.draws, trainer.epoch,
                           trainer.curr.max_level(trainer.epoch))
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator().manual_seed(0)

    def run(x, w, b, g):
        x, w, b = (t.detach().requires_grad_(True) for t in (x, w, b))
        y = _BF16Linear.apply(x, w, b)
        return (y.detach(),) + torch.autograd.grad(y, (x, w, b), g)

    worst = {"y": 0.0, "gx": 0.0, "gw": 0.0, "gb": 0.0, "y_rel": 0.0,
             "control": None}
    shapes = []
    for name, net in nets.items():
        h = inputs[name].to(torch.bfloat16)
        for l, lin in enumerate(net.layers):
            w = lin.weight.detach().to(torch.bfloat16)
            b = lin.bias.detach()
            g = torch.randn((h.shape[0], w.shape[0]), generator=gen)
            card = run(h, w, b, g.to(h.device))
            cpu = run(h.cpu(), w.cpu(), b.cpu(), g)
            for key, c, r in zip(("y", "gx", "gw", "gb"), card, cpu):
                c, r = c.float().cpu(), r.float()
                lim = GEMM_TOL * float(r.abs().max())
                if key in ("gx", "gw"):
                    lim = lim + 2.0 ** -7 * r.abs()
                err = (c - r).abs()
                if not bool((err <= lim).all()):
                    raise AssertionError(
                        f"bf16 GEMM {name}.{l} {key}: max err "
                        f"{float(err.max())} over its limit")
                worst[key] = max(worst[key], float((err / lim).max()))
                if key == "y":
                    worst["y_rel"] = max(worst["y_rel"], float(
                        err.max()) / float(r.abs().max()))
            ctl = torch.nn.functional.linear(h, w, b.to(torch.bfloat16))
            ctl = (ctl.float().cpu() - cpu[0]).abs().max() / float(
                cpu[0].abs().max())
            if float(ctl) <= GEMM_TOL:
                raise AssertionError(
                    f"bf16 GEMM {name}.{l}: the bf16-rounded control "
                    f"({float(ctl)}) is inside the limit")
            worst["control"] = float(ctl) if worst["control"] is None \
                else min(worst["control"], float(ctl))
            shapes.append([name, l] + list(h.shape) + [w.shape[0]])
            h = torch.relu(card[0]).to(torch.bfloat16) \
                if l != len(net.layers) - 1 else None
    res = {"tol": GEMM_TOL, "shapes": shapes,
           "err_over_limit": {k: worst[k] for k in ("y", "gx", "gw", "gb")},
           "y_rel_err": worst["y_rel"],
           "control_rel_err_min": worst["control"]}
    log("bf16 gemm:", json.dumps(res))
    return res


def sds_adan_step(device, ds) -> dict:
    """One SDS step of configs/synthetic_full.yaml (the full-size
    "<random>" Zero123) under train.optim adan at the epoch-300 point,
    where the deform freeze is on, after one real step: Adan steps in the
    virtual step, the frozen groups stay, the groups every view reaches
    move."""
    import torch
    from morpheus_tpu_torch.__main__ import build_guidance
    from morpheus_tpu_torch.config import load_config
    from morpheus_tpu_torch.train import optim
    from morpheus_tpu_torch.train.trainer import Trainer
    cfg = load_config(os.path.join(HERE, "configs", "synthetic_full.yaml"))
    cfg["train"]["optim"] = "adan"
    trainer = Trainer(cfg, ds, device=device,
                      guidance=build_guidance(cfg, device, log))
    epoch = SDS_POINTS[0][0]
    trainer.epoch = epoch
    trainer._set_levels(trainer._active_levels())
    if not trainer.curr.freeze_deform(epoch):
        raise AssertionError(f"epoch {epoch}: the freeze is off")
    sampler = trainer.virtual_sampler(trainer._novel_view_scale())
    # one real step first (the warmup occupancy update with it): at the
    # geometric init the sdf reads no grid feature, so a first step gives
    # the sdf grid no gradient
    trainer.real_step(epoch)
    names = trainer.optim.names
    before = [p.detach().clone() for p in trainer.params]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = trainer.virtual_step(epoch, sampler)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    moved = {optim.group_of(n) for n, a, b in zip(names, before,
                                                  trainer.params)
             if not torch.equal(a, b)}
    reached = {"sdf_grid", "color_grid", "sdf_net", "color_net", "beta"}
    if not _finite([float(loss)]) or moved & set(optim.FREEZE_GROUPS) \
            or not reached <= moved or trainer.optim.name != "adan" \
            or float(trainer.optim.step) != 2.0 \
            or launches["level_histogram"] < 1:
        raise AssertionError(f"SDS Adan step: loss {float(loss)}, moved "
                             f"{sorted(moved)}, launches {launches}")
    out = {"epoch": epoch, "rays": sampler.H * sampler.W,
           "loss": float(loss), "step_ms_first": ms,
           "groups_moved": sorted(moved), "launches": launches,
           "card": card_line()}
    log("sds adan:", json.dumps(out))
    del trainer
    torch.cuda.empty_cache()
    return out


def exact_cli_config(workdir: str) -> dict:
    """configs/ab_exact.yaml with EXACT_CLI_CUTS, its workspace under
    workdir: the raw YAML dict phase 11e writes out."""
    import yaml
    with open(os.path.join(HERE, "configs", "ab_exact.yaml")) as f:
        cfg = yaml.safe_load(f)
    for section, kv in EXACT_CLI_CUTS.items():
        cfg[section].update(kv)
    cfg["exp"].update(output=os.path.join(workdir, "exp"),
                      exp_name="ab_exact")
    return cfg


def exact_cli_phase(workdir: str) -> dict:
    """Phase 11e: python -m morpheus_tpu_torch --config configs/ab_exact.yaml
    on the card, widths kept, depth cut (EXACT_CLI_CUTS: 2 frames, 2 epochs
    of 1 iteration): the artifacts, finite losses, the native marcher and
    the kernel launches (hist_rows: the histogram only), as phase 9."""
    import numpy as np
    import yaml
    cfg = exact_cli_config(workdir)
    cfg_path = os.path.join(workdir, "ab_exact_cli.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    log("exact cli phase: configs/ab_exact.yaml cut to",
        json.dumps(EXACT_CLI_CUTS))
    ws = os.path.join(cfg["exp"]["output"], cfg["exp"]["exp_name"])
    run = _run_cli(cfg_path, [], os.path.join(workdir, "exact_cli.log"))
    stats = _json_lines(run, "epoch-stats")
    losses = [s["loss"] for s in stats]
    if [s["epoch"] for s in stats] != [1, 2] or not all(np.isfinite(losses)):
        raise AssertionError(f"exact CLI epochs {stats}")
    if any(e["backend"] != "native" for e in _json_lines(run, "mesh-export")):
        raise AssertionError("the native marcher did not run")
    launches = _json_lines(run, "kernel-launches")[0]
    if launches["level_histogram"] < 20 * 8 or launches["row_gather"] < 20 \
            or launches["level_gather"] or launches["segment_sum_sorted"]:
        raise AssertionError(f"exact CLI kernel launches {launches}")
    radii, centre_corner = check_cli_artifacts(
        ws, cfg["data"]["synthetic_frames"], mesh_epochs=(1, 2),
        final_epochs=(2,), video_epoch=2)
    out = {"frames": cfg["data"]["synthetic_frames"],
           "epoch_train_s": [s["train_s"] for s in stats], "losses": losses,
           "kernel_launches": launches,
           "median_vertex_radius": [min(radii.values()),
                                    max(radii.values())],
           "test_real_centre_corner": list(centre_corner),
           "card": card_line()}
    log("exact cli:", json.dumps(out))
    return out


def modes_phase(device, ds, workdir: str) -> tuple:
    """Phase 11: the training step's other modes on the card.
    (a) configs/ab_exact.yaml at full width (32 frames at 360^2, 2048 rays,
        64 samples a ray, no sample, smooth or band budget, the exact
        surface-band ladder, f32 payloads, linear occupancy queries): one
        epoch from step 0, MODES_TIMED timed steps (exact_step_ms), a
        5-step trace, then one steady step captured under each kernel
        route (lines step_exact_<mode>_<i>);
    (b) configs/synthetic_bench.yaml under tpu.compute_dtype bfloat16
        (bf16 tables and MLPs): the same under hist_rows (bf16_step_ms),
        then one captured step under each route (step_bf16_<mode>_<i>),
        and (from its warmed occupancy grid, as (c)) MLP_BF16_TIMED steps
        with tpu.mlp_dtype bfloat16 alone;
    (c) from the same warmed occupancy grid, OPTION_STEPS steps of each
        further option at synthetic_bench width: train.optim adan,
        the topology field with every dormant smoothness term, normal_mode
        fd, encode_topo, smoothstep; and one SDS step of
        configs/synthetic_full.yaml under Adan with the freeze on;
    (d) tiny card-vs-CPU runs (MODE_REFERENCES), and under (b)'s
        mlp_bf16 steps the bf16 MLP's GEMMs, card against CPU at the
        step's own inputs (bf16_gemm_check);
    (e) the CLI on configs/ab_exact.yaml (exact_cli_phase).
    Returns (results, kernel lines by kernel)."""
    import torch
    from morpheus_tpu_torch.config import load_config
    rows = {k: [] for k in CAPTURED}
    out = {}

    cfg = load_config(os.path.join(HERE, "configs", "ab_exact.yaml"))
    trainer, out["exact"] = mode_run(device, ds, cfg, "exact", MODES_TIMED)
    # the main closure, the ladder's n1 and n2 and the surface-point query,
    # each a histogram for the packed prefix and one for the hashed tail
    per = out["exact"]["launches_per_step"]["level_histogram"]
    if min(per) < 8:
        raise AssertionError(f"exact step: histogram launches {per}")
    out["exact"]["captured"] = mode_lines(trainer, "step_exact",
                                          PATH_KERNELS, rows)
    del trainer
    torch.cuda.empty_cache()

    cfg = load_config(os.path.join(HERE, "configs", "synthetic_bench.yaml"))
    cfg["tpu"]["compute_dtype"] = "bfloat16"
    trainer, out["bf16"] = mode_run(device, ds, cfg, "bf16", MODES_TIMED)
    out["bf16"]["captured"] = mode_lines(trainer, "step_bf16", PATH_KERNELS,
                                         rows)
    occ = trainer.occ
    del trainer
    torch.cuda.empty_cache()

    options = {"mlp_bf16": ({"tpu": {"mlp_dtype": "bfloat16"}}, None),
               "adan": ({"train": {"optim": "adan"}}, None),
               "topology": ({"train": dict(TINY_TOPO["train"])}, None),
               "fd": ({}, {"normal_mode": "fd"}),
               "encode_topo": ({"model": {"encode_topo": True}}, None),
               "smoothstep": ({}, {"grid": {"interpolation": "smoothstep"}})}
    out["options"] = {}
    for label, (over, spec) in options.items():
        cfg = load_config(os.path.join(HERE, "configs",
                                       "synthetic_bench.yaml"))
        for section, kv in over.items():
            cfg[section].update(kv)
        out["options"][label] = option_steps(
            device, ds, label, cfg, occ, spec,
            n=MLP_BF16_TIMED if label == "mlp_bf16" else OPTION_STEPS)
        torch.cuda.empty_cache()
    out["options"]["sds_adan"] = sds_adan_step(device, ds)

    out["references"] = {
        name: small_reference(device, mode, over, name=name, loss_rtol=rtol)
        for name, mode, over, rtol in MODE_REFERENCES}
    out["cli"] = exact_cli_phase(workdir)
    summary = {"exact_step_ms": out["exact"]["step_ms"],
               "bf16_step_ms": out["bf16"]["step_ms"],
               "mlp_bf16_step_ms": out["options"]["mlp_bf16"]["step_ms"],
               "exact_trace": out["exact"]["trace"],
               "bf16_trace": out["bf16"]["trace"], "card": card_line()}
    log("modes:", json.dumps(summary))
    return out, rows


# ---- phase 12: the pipeline around training ---------------------------------

# the raw capture of phase 12: frames of a depth camera's size
RAW_FRAMES, RAW_H, RAW_W = 4, 480, 640
# the virtual cameras' crop: configs/synthetic_bench.yaml's synthetic_res
VIRTUAL_SIZE = 360
# configs/synthetic_bench.yaml's widths on the preprocessed capture, depth
# cut to one epoch of one iteration, with that epoch's test videos
PIPELINE_CUTS = {"train": {"n_epochs": 1, "n_iters": 1},
                 "exp": {"test_interval": 1, "mesh_interval": 1,
                         "mesh_all_interval": 1,
                         "mesh_all_eval_interval": 1}}


def write_raw_capture(d: str, frames: int = RAW_FRAMES, H: int = RAW_H,
                      W: int = RAW_W) -> str:
    """A raw RGB-D capture under d, written as tests/test_preprocess.py
    writes one: rgb/ depth/ (mm) mask/ PNGs and intrinsics.txt. The scene
    is data/synthetic's deforming sphere in front of a static, slanted,
    checkered wall 3.3-3.7 m from the camera (a fixed camera's background,
    which the viewer fuses)."""
    import cv2
    import numpy as np
    from morpheus_tpu_torch.data.synthetic import make_synthetic_scene
    sc = make_synthetic_scene(num_frames=frames, H=H, W=W)
    v, u = np.mgrid[0:H, 0:W]
    check = ((v // 32 + u // 32) % 2).astype(np.float32)
    wall = 3.3 + 0.4 * v / H
    color = np.stack([0.3 + 0.4 * check, np.full_like(check, 0.5),
                      0.7 - 0.4 * check], -1)
    bg = sc["masks"] < 0.5
    depths = np.where(bg, wall, sc["depths"])
    images = np.where(bg[..., None], color, sc["images"])
    for sub in ("rgb", "depth", "mask"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i in range(frames):
        cv2.imwrite(os.path.join(d, "rgb", f"{i:04d}.png"),
                    cv2.cvtColor((images[i] * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(d, "depth", f"{i:04d}.png"),
                    (depths[i] * 1000).astype(np.uint16))
        cv2.imwrite(os.path.join(d, "mask", f"{i:04d}.png"),
                    (sc["masks"][i] * 255).astype(np.uint8))
    np.savetxt(os.path.join(d, "intrinsics.txt"), sc["K"])
    return d


def pipeline_config(workdir: str, data_dir: str, clip_ckpt: str) -> dict:
    """configs/synthetic_bench.yaml with PIPELINE_CUTS on the preprocessed
    capture in data_dir, exp.clip_ckpt set, its workspace under workdir:
    the raw YAML dict phase 12 writes out."""
    import yaml
    with open(os.path.join(HERE, "configs", "synthetic_bench.yaml")) as f:
        cfg = yaml.safe_load(f)
    for section, kv in PIPELINE_CUTS.items():
        cfg[section].update(kv)
    cfg["data"]["data_dir"] = data_dir
    cfg["exp"].update(output=os.path.join(workdir, "exp"),
                      exp_name="pipeline", clip_ckpt=clip_ckpt)
    return cfg


def clip_scores(text: str) -> list:
    """The CLI's `==> CLIP=<mean> (<video>)` scores, as (mean, video)."""
    return [(float(m), name) for m, name in
            re.findall(r"==> CLIP=(\S+) \((\S+)\)", text)]


def viewer_summary(text: str) -> dict:
    """The viewer's `viewer-stats` and `kernel-launches` lines: the seconds
    of the TSDF fusion (tsdf_s, and bg_mesh_s for its extraction and PLY),
    the foreground exports, rasterization (raster_s, png_s) and the video;
    the background's voxels and faces; the frames written."""
    stats = _json_lines(text, "viewer-stats")
    launches = _json_lines(text, "kernel-launches")
    if len(stats) != 1 or len(launches) != 1:
        raise AssertionError("the viewer's output lacks its viewer-stats or "
                             "kernel-launches line")
    return {**stats[0], "kernel_launches": launches[0]}


def run_supervised(cfg_path: str, ws: str) -> str:
    """The port's supervisor (morpheus_tpu_torch/scripts/run_full_budget.sh)
    on the config, with its real card probe; one failure or one stall kill
    opens its breaker, and the CLI waits for its eval worker. Returns the
    supervisor's log (the trainer's output)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("TRAINER_CMD", "PROBE_CMD")}
    env.update(MORPHEUS_EVAL_DRAIN_S="600", WATCH_S="5", SLEEP_RETRY="0",
               GIVE_UP_AFTER="1", STALL_GIVE_UP_AFTER="1")
    cmd = ["bash", os.path.join(HERE, "morpheus_tpu_torch", "scripts",
                                "run_full_budget.sh"), cfg_path, ws]
    rc = subprocess.run(cmd, cwd=HERE, env=env, timeout=900).returncode
    with open(os.path.join(ws, "supervisor.log")) as f:
        text = f.read()
    if rc != 0 or "run COMPLETE" not in text:
        raise AssertionError(f"the supervised run exited {rc}:\n"
                             f"{text[-4000:]}")
    return text


def run_viewer(cfg_path: str, out_path: str) -> str:
    """python -m morpheus_tpu_torch.visualizer --traj 360 on the card under
    tpu.vjp_mode mxu_rows; its output (also kept in out_path)."""
    cmd = [sys.executable, "-m", "morpheus_tpu_torch.visualizer", "--config",
           cfg_path, "--traj", "360", "tpu", "--vjp_mode", "mxu_rows"]
    with open(out_path, "w") as out:
        rc = subprocess.run(cmd, cwd=HERE, stdout=out,
                            stderr=subprocess.STDOUT, timeout=900).returncode
    with open(out_path) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"the viewer exited {rc}:\n{text[-4000:]}")
    return text


def check_viewer_gather(device, cfg: dict, ws: str) -> dict:
    """The viewer's per-frame query under mxu_rows, in this process: the
    trained checkpoint, frame 0's colored 256^3 export, its first
    level_gather call held against the plain twin and timed (line
    viewer_mxu_rows_0)."""
    from morpheus_tpu_torch.config import merge_defaults
    from morpheus_tpu_torch.data.dataset import DeformDataset
    from morpheus_tpu_torch.train.trainer import Trainer
    from morpheus_tpu_torch.visualizer import FG_RES
    c = merge_defaults(cfg)
    c["tpu"]["vjp_mode"] = "mxu_rows"
    trainer = Trainer(c, DeformDataset(c), device=device)
    trainer.load_ckpt(os.path.join(ws, "models", "model_ep_0001.pkl"))
    args, launches, info = capture_mesh_gather(
        trainer.field, os.path.join(ws, "viewer_mxu_rows.ply"),
        resolution=FG_RES, t=0.0, color_mesh=True)
    log("viewer export mxu_rows:", json.dumps({**info, "launches": launches}))
    if args is None or launches["level_gather"] < (FG_RES ** 3 >> 18) \
            or launches["level_histogram"] or launches["segment_sum_sorted"]:
        raise AssertionError(f"viewer export under mxu_rows: launches "
                             f"{launches}")
    row = gather_line("viewer_mxu_rows_0", *args)
    row["launches"] = launches["level_gather"]
    return row


def pipeline_phase(device, workdir: str) -> dict:
    """Phase 12: the pipeline around training through the port's entry
    points. A raw capture (RAW_FRAMES frames at RAW_H x RAW_W) is
    preprocessed (run_pose_init, then preprocess_sequence at VIRTUAL_SIZE),
    trained by the port's supervisor at configs/synthetic_bench.yaml width
    with the CLIP eval on (a random ViT-B/32 the port writes in the OpenAI
    layout), then rendered by the viewer; the viewer's first level_gather
    call is checked and timed in this process. Prints the `pipeline:` and
    `viewer:` lines; returns their numbers, the kernel launches of the
    supervised CLI and of the viewer, and the kernel line."""
    import glob

    import numpy as np
    import yaml
    from morpheus_tpu_torch.eval.clip_eval import ImageEncoder
    from morpheus_tpu_torch.preprocess import pose_init, virtual_cams
    data_dir = write_raw_capture(os.path.join(workdir, "capture"),
                                 RAW_FRAMES, RAW_H, RAW_W)
    t0 = time.perf_counter()
    pose_init.run_pose_init(data_dir)
    t1 = time.perf_counter()
    virtual_cams.preprocess_sequence(data_dir, size_h=VIRTUAL_SIZE,
                                     size_w=VIRTUAL_SIZE)
    t2 = time.perf_counter()
    clip_ckpt = ImageEncoder(device=device).save_checkpoint(
        os.path.join(workdir, "clip_b32_random.pt"))
    cfg = pipeline_config(workdir, data_dir, clip_ckpt)
    cfg_path = os.path.join(workdir, "pipeline.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ws = os.path.join(cfg["exp"]["output"], cfg["exp"]["exp_name"])
    log("pipeline phase: a raw capture of", RAW_FRAMES, "frames at",
        f"{RAW_H}x{RAW_W}; configs/synthetic_bench.yaml cut to",
        json.dumps(PIPELINE_CUTS))

    t3 = time.perf_counter()
    text = run_supervised(cfg_path, ws)
    cli_s = time.perf_counter() - t3
    scores = clip_scores(text)
    if len(scores) != 1 or not _finite([scores[0][0]]):
        raise AssertionError(f"CLIP scores of the supervised run: {scores}")
    launches = _json_lines(text, "kernel-launches")
    if len(launches) != 1 or not launches[0]["level_histogram"] \
            or not launches[0]["row_gather"] or launches[0]["level_gather"] \
            or launches[0]["segment_sum_sorted"]:
        raise AssertionError(f"supervised CLI kernel launches {launches}")
    losses = [s["loss"] for s in _json_lines(text, "epoch-stats")]
    if len(losses) != 1 or not _finite(losses):
        raise AssertionError(f"supervised CLI losses {losses}")
    pipeline = {"frames": RAW_FRAMES, "raw_size": [RAW_H, RAW_W],
                "virtual_size": VIRTUAL_SIZE, "pose_init_s": t1 - t0,
                "virtual_cams_s": t2 - t1, "supervised_cli_s": cli_s,
                "clip": scores[0][0], "clip_video": scores[0][1],
                "kernel_launches": launches[0], "card": card_line()}
    log("pipeline:", json.dumps(pipeline))

    t4 = time.perf_counter()
    viewer = viewer_summary(run_viewer(cfg_path, os.path.join(workdir,
                                                              "viewer.log")))
    viewer["viewer_s"] = time.perf_counter() - t4
    meshes = glob.glob(os.path.join(ws, "mesh_final_color_256", "*.ply"))
    pngs = glob.glob(os.path.join(ws, "scene_renderings", "rgb", "*.png"))
    want = {"background": os.path.join(data_dir, "scene_meshes",
                                       "bg_mesh.ply"),
            "video": os.path.join(ws, "scene_renderings", "render_360.mp4")}
    missing = [k for k, p in want.items() if not os.path.exists(p)]
    n = viewer["kernel_launches"]
    if missing or len(meshes) != RAW_FRAMES or len(pngs) != RAW_FRAMES \
            or viewer["frames"] != RAW_FRAMES or not viewer["bg_faces"] \
            or n["level_gather"] < RAW_FRAMES * 64 or n["level_histogram"] \
            or n["segment_sum_sorted"]:
        raise AssertionError(f"viewer: missing {missing}, {len(meshes)} "
                             f"meshes, {len(pngs)} frames, {viewer}")
    from morpheus_tpu_torch.ops import meshing
    for p in meshes:
        _, faces, colors = meshing.load_ply(p)
        if not len(faces) or colors is None or not np.isfinite(colors).all():
            raise AssertionError(f"{p}: {len(faces)} faces, colors {colors}")
    viewer["card"] = card_line()
    log("viewer:", json.dumps(viewer))
    row = check_viewer_gather(device, cfg, ws)
    return {"pipeline": pipeline, "viewer": viewer, "row": row,
            "launches": {"cli": launches[0], "viewer": n}}


# ---- phase 13: data parallelism (parallel/sharding.py) -----------------------

DP_WORLD = 2
DP_TIMED = 10          # timed data-parallel real steps under hist_rows
DP_EQUAL_STEPS = 3     # one-rank NCCL steps held bit for bit
DP_SDS_EPOCH = 300     # 5,184 rays a view, the deform freeze on
DP_SDS_STEPS = 2
DP_LOSS_RTOL = 1e-4
# the data-parallel SDS gradients against the mean of the views' own: a
# leaf's largest difference over its largest |gradient| (float32 sums in
# another order, the card's atomic accumulations)
DP_SDS_GRAD_TOL = 1e-3


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gb(device):
    import torch
    return (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)


def _batch_tensors(batch: dict, device) -> dict:
    """A host batch as the trainer's own (_real_batch) makes it."""
    import torch
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out["rays_id"] = out["rays_id"].long()
    return out


def dp_one_rank(device, cfg, ds, n_timed: int = DP_TIMED) -> dict:
    """Phase 13a: a one-rank NCCL group in this process. Its trainer, the
    plain one (no group) and a second plain one (the control), from the
    same seed, take DP_EQUAL_STEPS real steps at epoch n_epochs (the first
    with the warm-up occupancy update) on the same host-drawn batches,
    under the route whose kernel sums in a fixed order (sort_pallas_rows)
    and torch's deterministic algorithms (level_histogram's and
    index_add_'s float atomics sum in the order the card runs them): the
    losses, the parameters, the optimizer's slots and the occupancy grid
    must equal the plain trainer's bit for bit. Then n_timed steps of the
    one-rank trainer under hist_rows from global step 256."""
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist
    from morpheus_tpu_torch.parallel import sharding
    from morpheus_tpu_torch.train.trainer import Trainer
    red, dev = sharding.init(0, 1, sharding.free_port(), device)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        backend = dist.get_backend()
        det = dict(cfg, tpu=dict(cfg["tpu"], vjp_mode="sort_pallas_rows"))
        plain, control = (Trainer(det, ds, device=dev) for _ in range(2))
        one = Trainer(det, ds, device=dev, reducer=red)
        for tr in (plain, control, one):
            tr.epoch = cfg["train"]["n_epochs"]
            tr._set_levels(tr._active_levels())
        rng = np.random.default_rng(cfg["exp"]["seed"])   # one's twin
        losses = []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                # cumsum warns; its per-ray scans are short rows
                warnings.simplefilter("ignore", UserWarning)
                for _ in range(DP_EQUAL_STEPS):
                    b, bg = sharding.host_sample_real_batch(
                        rng, one.host_data, ds.num_frames,
                        cfg["train"]["real_ray_num"])
                    b["bg"] = bg
                    b = _batch_tensors(b, dev)
                    bg = b.pop("bg")
                    lp = plain.real_step(plain.epoch, b, bg)
                    lc = control.real_step(control.epoch, b, bg)
                    lo = one.real_step(one.epoch)
                    losses.append((float(lp), float(lc), float(lo)))
        finally:
            torch.use_deterministic_algorithms(False)

        def differ(a, b):
            pairs = [("params", a.params, b.params),
                     ("occs", [a.occ.occs], [b.occ.occs])]
            pairs += [(k, getattr(a.optim, k), getattr(b.optim, k))
                      for k in a.optim.SLOTS]
            return [name for name, x, y in pairs
                    if not all(torch.equal(u, v) for u, v in zip(x, y))]

        one_differs, control_differs = differ(plain, one), differ(plain,
                                                                  control)
        equal = not one_differs and all(a == c for a, _, c in losses)
        if not equal:
            raise AssertionError(
                f"one-rank {backend} run differs from the plain trainer: "
                f"{one_differs}, losses {losses}; the control differs in "
                f"{control_differs}")
        del plain, control
        set_vjp_mode(one, "hist_rows")
        one.global_step = 256
        step_ms = []
        for _ in range(n_timed):
            _sync(dev)
            t0 = time.perf_counter()
            loss = one.real_step(one.epoch)
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if not _finite([float(loss)]):
            raise AssertionError(f"one-rank run: non-finite loss {loss}")
        del one
        chain = dp_chain(red, dev, cfg, ds)
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "bitwise_equal": equal,
            "equal_route": "sort_pallas_rows, deterministic algorithms",
            "control_equal": not control_differs, "losses": losses,
            "dp_real_step_ms": statistics.median(step_ms),
            "steps_ms": step_ms, "chain": chain}


# the one-rank group's chained step: (vjp_mode, held bit for bit) - the
# route whose kernel sums in a fixed order under deterministic algorithms,
# then the other two routes within phase 15's tolerances; each kernel runs
# in the graph under its own route
DP_CHAIN_RUNS = (("sort_pallas_rows", True), ("hist_rows", False),
                 ("mxu_rows", False))


def dp_chain(red, device, cfg, ds) -> dict:
    """Phase 13a's chained step: for each of DP_CHAIN_RUNS an eager and a
    chained trainer of the one-rank group (NCCL on a card: the chained
    one replays a graph of the step with its all-reduces; gloo on the
    CPU: the graph's body, eagerly) from the same seed take phase 15's two
    blocks (CHAIN_EPOCHS from CHAIN_STEP0: a sampled refresh in the first,
    two captures) and are compared (chain_compare: bit for bit under
    sort_pallas_rows with deterministic algorithms, within phase 15's
    tolerances under hist_rows and mxu_rows); on a card every kernel of
    the mode ran on
    every graphed step and each graph holds at least one all-reduce. Then
    the eager and the graphed one-rank step and the plain trainer's
    graphed step (no group) from this process, each at CHAIN_EPOCHS[1]
    (chain_step_ms), and one traced replayed block. The `dp chain:`
    line's record (dp_phase adds the card)."""
    import torch
    from morpheus_tpu_torch.scripts.trace_step import trace_steps
    cuda = device.type == "cuda"
    out = {"world": red.world, "backend": red.backend, "runs": {}}
    for mode, bitwise in DP_CHAIN_RUNS:
        eager = chain_trainer(device, ds, mode, {}, False, red, cfg)
        e = chain_blocks(eager, bitwise)
        graphed = chain_trainer(device, ds, mode, {}, True, red, cfg)
        g = chain_blocks(graphed, bitwise)
        if graphed.graphed != cuda or len(g["captures"]) != (
                len(CHAIN_EPOCHS) if cuda else 0):
            raise AssertionError(f"dp chain {mode}: graphed "
                                 f"{graphed.graphed}, captures "
                                 f"{g['captures']}")
        cmp = chain_compare(eager, graphed, bitwise=bitwise,
                            losses=(e["losses"], g["losses"]))
        n_steps = graphed.global_step - CHAIN_STEP0
        if cuda:
            for k, v in g["launches"].items():
                if (v < n_steps) if k in PATH_KERNELS[mode] else v:
                    raise AssertionError(f"dp chain {mode}: {k} launched "
                                         f"{v} times in {n_steps} graphed "
                                         "steps")
            if min(c["all_reduces"] for c in g["captures"]) < 1:
                raise AssertionError(f"dp chain {mode}: a graph without "
                                     f"its all-reduces: {g['captures']}")
        run = {"vjp_mode": mode, "deterministic": bitwise,
               "eager": e, "graphed": g, "compare": cmp}
        log("dp chain run:", json.dumps(run))
        if cmp["failed"]:
            raise AssertionError(f"dp chain {mode}: graphed and eager "
                                 f"differ in {cmp['failed']}")
        out["runs"][mode] = run
        del eager, graphed
        if cuda:
            torch.cuda.empty_cache()
    ms = {}
    for key, chain, reducer in (("eager", False, red), ("graphed", True, red),
                                ("plain_graphed", True, None)):
        tr = chain_trainer(device, ds, "hist_rows", {}, chain, reducer, cfg)
        ms[key] = chain_step_ms(tr)
        if key == "graphed":
            trace = trace_steps(tr, n=tr.config["train"]["real_freq"],
                                log=log, chained=True)
            captures = list(tr.captures)
        del tr
        if cuda:
            torch.cuda.empty_cache()
    out.update({
        "dp_real_step_ms": {"eager": statistics.median(ms["eager"]),
                            "graphed": statistics.median(ms["graphed"])},
        "plain_graphed_step_ms": statistics.median(ms["plain_graphed"]),
        "steps_ms": ms, "captures": captures,
        "capture_s": [c["capture_s"] for c in captures],
        "pool_mb": [c["pool_mb"] for c in captures],
        "all_reduces_in_graph": [c["all_reduces"] for c in captures],
        "all_reduce_bytes_in_graph": [c["all_reduce_bytes"]
                                      for c in captures],
        "trace": {k: trace.get(k) for k in (
            "steps", "step_ms_traced", "kernels_per_step",
            "device_busy_ms_per_step", "device_idle_share")}})
    return out


def _count_collectives(red, fn):
    """fn() with its all-reduces counted by the reducer, a replayed graph's
    as its capture recorded them: (its result, {calls, bytes})."""
    before = red.all_reduces, red.all_reduce_bytes
    out = fn()
    return out, {"calls": red.all_reduces - before[0],
                 "bytes": red.all_reduce_bytes - before[1]}


def dp_real(red, device, cfg, ds, n_timed: int = DP_TIMED,
            lines: bool = True) -> dict:
    """Phase 13b on one rank: the data-parallel real step of cfg
    (tpu.data_parallel = world) from one epoch at epoch n_epochs (its
    warm-up occupancy update), then n_timed steps from global step 256
    under hist_rows, each ending in a synchronize, with the kernels'
    launches counted; the collectives of one more step (calls, bytes) and
    the gradient bucket's all-reduce alone (median of 10); one step under
    each vjp_mode with rank 0's kernel calls captured; rank 0's one-rank
    reference of the timed steps (the same state, draws and global batches:
    losses at DP_LOSS_RTOL, parameters within 2*n*lr); the replicas
    checked equal. With `lines`, rank 0's captured calls become kernel
    lines step_dp_<mode>_<i>."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist
    from morpheus_tpu_torch.parallel import sharding
    from morpheus_tpu_torch.train.trainer import Trainer
    rank0 = red.rank == 0
    t0 = time.perf_counter()
    tr = Trainer(cfg, ds, device=device, reducer=red)
    tr.epoch = cfg["train"]["n_epochs"]
    tr.train_one_epoch(n_iters=1)
    _sync(device)
    setup_s = time.perf_counter() - t0
    tr.global_step = 256
    # (deep copies: on the CPU state_dict's arrays share the live storage)
    state0 = copy.deepcopy(tr.state_dict()) if rank0 else None
    rng0 = copy.deepcopy(tr._np_rng)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    step_ms, losses = [], []
    for _ in range(n_timed):
        _sync(device)
        t0 = time.perf_counter()
        loss = tr.real_step(tr.epoch)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = {"hist_rows": read_counts()}
    peak = _peak_gb(device)
    after = [p.detach().clone() for p in tr.params] if rank0 else None
    if not _finite(losses):
        raise AssertionError(f"data-parallel step: non-finite loss {losses}")

    if tr.global_step % cfg["tpu"]["occ_update_every"] == 0:
        tr.global_step += 1
    _, coll = _count_collectives(red, lambda: tr.real_step(tr.epoch))
    n_bucket = sum(p.numel() for p in tr.params) + 1
    bucket = torch.zeros(n_bucket, device=device)
    bucket_ms = []
    for _ in range(10):
        _sync(device)
        t0 = time.perf_counter()
        dist.all_reduce(bucket)
        _sync(device)
        bucket_ms.append((time.perf_counter() - t0) * 1e3)

    calls, called = {}, {}
    for mode in PATH_KERNELS:
        set_vjp_mode(tr, mode)
        if tr.global_step % cfg["tpu"]["occ_update_every"] == 0:
            tr.global_step += 1
        calls[mode] = []
        originals = recording(calls[mode], ["step"]) if rank0 else None
        reset_counts()
        try:
            tr.real_step(tr.epoch)
            _sync(device)
        finally:
            if originals:
                restore(originals)
        counts = read_counts()
        if mode != "hist_rows":
            launches[mode] = counts
        called[mode] = {k: v for k, v in counts.items() if v}
        # (on the CPU the wrappers launch nothing and count nothing)
        if device.type == "cuda" and \
                set(called[mode]) != set(PATH_KERNELS[mode]):
            raise AssertionError(f"data-parallel step under {mode} launched "
                                 f"{counts}")
    set_vjp_mode(tr, "hist_rows")
    chain = dp_chain_block(red, tr)
    equal = sharding.replicas_equal(tr)
    if not equal:
        raise AssertionError("data-parallel ranks' states differ")

    out = {"rank": red.rank, "world": red.world, "backend":
           dist.get_backend(), "rays_per_rank":
           cfg["train"]["real_ray_num"] // red.world, "setup_s": setup_s,
           "dp_real_step_ms": statistics.median(step_ms),
           "steps_ms": step_ms, "losses": losses, "launches": launches,
           "collectives_per_step": coll["calls"],
           "allreduce_bytes_per_step": coll["bytes"],
           "grad_bucket_bytes": 4 * n_bucket,
           "grad_bucket_allreduce_ms": statistics.median(bucket_ms),
           "replicas_equal": equal, "peak_mem_gb": peak, "chain": chain}
    if rank0:
        # the one-rank reference: the same state, draws and global batches
        ref = Trainer(dict(cfg, tpu=dict(cfg["tpu"], data_parallel=1)), ds,
                      device=device)
        ref.load_state_dict(state0)
        ref._set_levels(ref._active_levels())
        ref_losses = []
        for _ in range(n_timed):
            b, bg = sharding.host_sample_real_batch(
                rng0, tr.host_data, ds.num_frames,
                cfg["train"]["real_ray_num"])
            b["bg"] = bg
            b = _batch_tensors(b, device)
            ref_losses.append(float(ref.real_step(ref.epoch, b,
                                                  b.pop("bg"))))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            ref_losses))
        param_diff = max(float((a - b.detach()).abs().max())
                         for a, b in zip(after, ref.params))
        limit = 2 * n_timed * float(tr.curr.learning_rate(tr.epoch))
        out.update(ref_losses=ref_losses, loss_max_rel_diff=loss_rel,
                   loss_rtol=DP_LOSS_RTOL, param_max_diff=param_diff,
                   param_limit=limit)
        if loss_rel > DP_LOSS_RTOL or param_diff > limit:
            raise AssertionError(
                f"data-parallel run against the one-rank run: losses "
                f"{losses} vs {ref_losses}, params {param_diff} (limit "
                f"{limit})")
        del ref
        if lines:
            rows = {k: [] for k in CAPTURED}
            for mode, c in calls.items():
                for k, r in step_lines(mode, c, prefix="step_dp",
                                       k=MODES_K).items():
                    rows[k] += r
            out["rows"] = rows
    red.barrier()
    del tr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dp_chain_block(red, tr) -> dict:
    """Two chained epochs of one iteration of tr, a rank of `red` (its
    virtual_freq real slots and real_freq chained steps each): on NCCL
    ranks replays of a graph with its all-reduces, under gloo its body
    run eagerly; the second block's ms a step, each rank's collectives a
    step, and the captures. A graphed rank must have captured, each graph
    holding at least one all-reduce."""
    want = tr.device.type == "cuda" and red.backend == "nccl"
    if not tr.chain or tr.graphed != want:
        raise AssertionError(f"rank {red.rank}: chain_steps {tr.chain}, "
                             f"graphed {tr.graphed} under {red.backend}")
    tr.train_one_epoch(n_iters=1)
    tr_cfg = tr.config["train"]
    steps = tr_cfg["virtual_freq"] + tr_cfg["real_freq"]
    reset_counts()
    _sync(tr.device)
    t0 = time.perf_counter()
    _, coll = _count_collectives(red, lambda: tr.train_one_epoch(n_iters=1))
    _sync(tr.device)
    out = {"graphed": tr.graphed, "steps": steps,
           "step_ms": (time.perf_counter() - t0) * 1e3 / steps,
           "collectives_per_step": coll["calls"] / steps,
           "launches": read_counts(), "captures": list(tr.captures)}
    if tr.graphed and (not tr.captures or min(
            c["all_reduces"] for c in tr.captures) < 1):
        raise AssertionError(f"rank {red.rank}: the chained data-parallel "
                             f"step captured {tr.captures}")
    return out


def dp_sds(red, device, cfg, ds, epoch: int = DP_SDS_EPOCH,
           n: int = DP_SDS_STEPS) -> dict:
    """Phase 13c on one rank: the data-parallel SDS step of cfg (the
    CLI's guidance, built alike on every rank and checked so by a digest),
    one view a rank, n steps at `epoch` from step 0: finite losses, launches,
    the replicas equal, and on rank 0 the first step's gradients (handed to
    the optimizer under the deform freeze) against the mean of the two
    views' own gradients taken on rank 0 from the same state and draws."""
    import torch
    from morpheus_tpu_torch.__main__ import build_guidance
    from morpheus_tpu_torch.parallel import sharding
    from morpheus_tpu_torch.train.trainer import Trainer
    import copy

    rank0 = red.rank == 0
    t0 = time.perf_counter()
    g = build_guidance(cfg, device, log if rank0 else (lambda *a: None))
    same_guidance = red.agree(sharding.digest(g.state_dict()))
    if not same_guidance:
        raise AssertionError("the ranks' random Zero123 weights differ")
    tr = Trainer(cfg, ds, device=device, guidance=g, reducer=red)
    del g
    tr.epoch = epoch
    tr._set_levels(tr._active_levels())
    sampler = tr.virtual_sampler(tr._novel_view_scale())
    setup_s = time.perf_counter() - t0
    state0 = copy.deepcopy(tr.state_dict()) if rank0 else None
    applied = []
    update = tr.optim.update

    def record(grads, lr, **kw):
        if not applied:
            applied.append([x.detach().clone() for x in grads])
        return update(grads, lr, **kw)

    tr.optim.update = record
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    step_ms, losses = [], []
    try:
        for _ in range(n):
            _sync(device)
            t0 = time.perf_counter()
            loss, _ = tr.virtual_step(epoch, sampler)
            _sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
    finally:
        del tr.optim.update
    launches = read_counts()
    peak = _peak_gb(device)
    if not _finite(losses) or not applied:
        raise AssertionError(f"data-parallel SDS step: losses {losses}, "
                             f"optimizer steps {len(applied)}")
    equal = sharding.replicas_equal(tr)
    if not equal:
        raise AssertionError("data-parallel SDS ranks' states differ")
    out = {"rank": red.rank, "epoch": epoch,
           "rays_per_view": sampler.H * sampler.W, "setup_s": setup_s,
           "sds_step_ms": step_ms, "losses": losses, "launches": launches,
           "same_guidance": same_guidance, "replicas_equal": equal,
           "peak_mem_gb": peak}
    if rank0:
        tr.load_state_dict(state0)
        want = None
        for v in range(red.world):
            tr.load_state_dict(state0)
            draws = tr.draws
            occ = tr._maybe_update_occ(tr.occ, tr.global_step,
                                       draws.uniform("t_occ", ()), draws)
            loss, _ = tr._virtual_loss(
                occ, sharding.ViewDraws(draws, v, red.world), epoch,
                tr.curr.max_level(epoch), sampler)
            gv = tr._grads(loss)
            want = gv if want is None else [a + b for a, b in zip(want, gv)]
        vf = float(cfg["train"]["virtual_freq"])
        worst = 0.0
        for got, w in zip(applied[0], want):
            w = w / red.world / vf
            scale = float(w.abs().max())
            if scale > 0:
                worst = max(worst, float((got - w).abs().max()) / scale)
        out.update(grad_max_rel_diff=worst, grad_tol=DP_SDS_GRAD_TOL)
        if not worst <= DP_SDS_GRAD_TOL:
            raise AssertionError(f"data-parallel SDS gradients differ from "
                                 f"the views' mean by {worst}")
    red.barrier()
    del tr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dp_rank(red, device, out_dir: str, real_cfg: dict, sds_cfg: dict,
            n_timed: int = DP_TIMED, sds_epoch: int = DP_SDS_EPOCH):
    """One rank of phase 13 (sharding.launch): dp_real on real_cfg, then
    dp_sds on sds_cfg at sds_epoch; writes out_dir/rank<r>.json."""
    import torch
    from morpheus_tpu_torch.data.dataset import load_synthetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cpu":
        # each rank refreshes the occupancy grid itself: one thread keeps
        # the CPU's float sums in one order, where several can sum in orders
        # that differ between the ranks under load, and the replicas' grids
        # then differ in the last bits
        torch.set_num_threads(1)
    # configs/synthetic_full.yaml has synthetic_bench's scene
    ds = load_synthetic(real_cfg)
    res = {"real": dp_real(red, device, real_cfg, ds, n_timed,
                           lines=device.type == "cuda"),
           "sds": dp_sds(red, device, sds_cfg, ds, sds_epoch)}
    with open(os.path.join(out_dir, f"rank{red.rank}.json"), "w") as f:
        json.dump(res, f)


def dp_configs(world: int = DP_WORLD) -> tuple:
    """(the bench's config, synthetic_full's), each at tpu.data_parallel
    `world`."""
    from morpheus_tpu_torch.config import load_config
    out = []
    for name in ("synthetic_bench.yaml", "synthetic_full.yaml"):
        cfg = load_config(os.path.join(HERE, "configs", name))
        cfg["tpu"]["data_parallel"] = world
        out.append(cfg)
    return tuple(out)


def dp_cli_refusal() -> dict:
    """The CLI with `tpu --data_parallel 2` on one card: refused before a
    rank starts, naming the visible card count."""
    cmd = [sys.executable, "-m", "morpheus_tpu_torch", "--config",
           os.path.join(HERE, "configs", "synthetic_bench.yaml"), "tpu",
           "--data_parallel", str(DP_WORLD)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=300)
    want = f"tpu.data_parallel={DP_WORLD} but only 1 CUDA devices are visible"
    if proc.returncode == 0 or want not in proc.stderr:
        raise AssertionError(f"the CLI on one card did not refuse "
                             f"data_parallel {DP_WORLD}: rc "
                             f"{proc.returncode}\n{proc.stderr[-2000:]}")
    return {"rc": proc.returncode, "error": want,
            "seconds": time.perf_counter() - t0}


def dp_phase(device, workdir: str) -> tuple:
    """Phase 13: data parallelism on the one card. (a) a one-rank NCCL
    group against the plain trainer, bit for bit (dp_one_rank, at
    configs/synthetic_bench.yaml); (b, c) two ranks sharing the card over
    gloo (sharding.launch's share_card), each running dp_real at the
    bench's full width (2048 global rays, 1024 a rank) and dp_sds at
    configs/synthetic_full.yaml's (the "<random>" full-size Zero123, one
    5,184-ray view a rank); (d) the CLI's refusal of two ranks on one
    card. Prints the `dp:` and `dp sds:` lines; returns (results, rank 0's
    kernel lines)."""
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.parallel import sharding
    t_phase = time.perf_counter()
    real_cfg, sds_cfg = dp_configs()
    one_cfg = dict(real_cfg, tpu=dict(real_cfg["tpu"], data_parallel=1))
    one = dp_one_rank(device, one_cfg, load_synthetic(one_cfg))
    chain = one.pop("chain")
    chain["card"] = card_line()
    log("dp one rank:", json.dumps(one))
    log("dp chain:", json.dumps({k: v for k, v in chain.items()
                                 if k != "runs"}))
    out_dir = os.path.join(workdir, "dp")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    sharding.launch(dp_rank, DP_WORLD, device.type, args=(
        out_dir, real_cfg, sds_cfg), share_card=True)
    ranks_s = time.perf_counter() - t0
    result, sds_line, rows = dp_summary(out_dir, DP_WORLD)
    cli = dp_cli_refusal()
    result.update({
        "dp_real_step_ms": {"world_1": one["dp_real_step_ms"],
                            "world_2": result["dp_real_step_ms"]},
        "world_1_backend": one["backend"],
        "world_1_bitwise_equal": one["bitwise_equal"],
        "dp_chain_step_ms": {
            "world_1": chain["dp_real_step_ms"]["graphed"],
            f"world_{DP_WORLD}": result["chain"]["step_ms"]},
        "ranks_s": ranks_s, "cli_refusal": cli})
    log("dp:", json.dumps(result))
    log("dp sds:", json.dumps(sds_line))
    log(f"phase 13 seconds: {time.perf_counter() - t_phase:.1f}")
    result["sds"] = sds_line
    result["one_rank_chain"] = chain
    return result, rows


def dp_summary(out_dir: str, world: int) -> tuple:
    """What the ranks of dp_rank wrote to out_dir, checked: each kernel of
    each mode launched in every rank, the ranks' losses equal. Returns
    (the real steps' line, the SDS steps' line, rank 0's kernel lines)."""
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    real = [r["real"] for r in ranks]
    sds = [r["sds"] for r in ranks]
    for r in real:
        for mode, counts in r["launches"].items():
            for k in PATH_KERNELS[mode]:
                if counts[k] < 1:
                    raise AssertionError(f"rank {r['rank']}: {k} did not run "
                                         f"under {mode}: {counts}")
    if len({r["losses"][-1] for r in real}) != 1:
        raise AssertionError("the ranks report different losses")
    r0 = real[0]
    result = {
        "world": world, "backend": r0["backend"],
        "rays_per_rank": r0["rays_per_rank"],
        "dp_real_step_ms": [r["dp_real_step_ms"] for r in real],
        "collectives_per_step": r0["collectives_per_step"],
        "allreduce_bytes_per_step": r0["allreduce_bytes_per_step"],
        "grad_bucket_bytes": r0["grad_bucket_bytes"],
        "grad_bucket_allreduce_ms": [r["grad_bucket_allreduce_ms"]
                                     for r in real],
        "loss_max_rel_diff": r0["loss_max_rel_diff"],
        "loss_rtol": r0["loss_rtol"],
        "param_max_diff": r0["param_max_diff"],
        "param_limit": r0["param_limit"],
        "replicas_equal": all(r["replicas_equal"] for r in real),
        "peak_mem_gb": [r["peak_mem_gb"] for r in real],
        "launches": [r["launches"] for r in real],
        "chain": {"graphed": r0["chain"]["graphed"],
                  "step_ms": [r["chain"]["step_ms"] for r in real],
                  "collectives_per_step":
                      r0["chain"]["collectives_per_step"],
                  "launches": [r["chain"]["launches"] for r in real],
                  "captures": r0["chain"]["captures"]},
        "card": card_line()}
    sds_line = {
        "world": world, "epoch": sds[0]["epoch"],
        "rays_per_view": sds[0]["rays_per_view"],
        "sds_step_ms": [s["sds_step_ms"] for s in sds],
        "losses": sds[0]["losses"],
        "grad_max_rel_diff": sds[0]["grad_max_rel_diff"],
        "grad_tol": sds[0]["grad_tol"],
        "same_guidance": all(s["same_guidance"] for s in sds),
        "replicas_equal": all(s["replicas_equal"] for s in sds),
        "peak_mem_gb": [s["peak_mem_gb"] for s in sds],
        "launches": [s["launches"] for s in sds],
        "setup_s": [s["setup_s"] for s in sds]}
    return result, sds_line, r0.get("rows", {k: [] for k in CAPTURED})


def dp_cards_phase(workdir: str) -> dict:
    """Data parallelism over every visible card (`--dp-cards`; not part of
    the one-card run): dp_rank on one NCCL rank a card (the bench's 2048
    global rays split over them, the chained blocks replaying a graph on
    each card, the replicas checked equal after them; one SDS view a
    card), then the CLI on
    configs/synthetic_bench.yaml cut in depth (cli_phase) with
    tpu.data_parallel = the card count (`dp cards:`, `dp cards sds:` and
    `dp cli:` lines)."""
    import torch
    from morpheus_tpu_torch.parallel import sharding
    world = torch.cuda.device_count()
    if world < 2:
        raise AssertionError(f"--dp-cards needs 2 cards or more, not {world}")
    real_cfg, sds_cfg = dp_configs(world)
    out_dir = os.path.join(workdir, "dp_cards")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    sharding.launch(dp_rank, world, "cuda", args=(out_dir, real_cfg,
                                                   sds_cfg))
    result, sds_line, _ = dp_summary(out_dir, world)
    result["ranks_s"] = time.perf_counter() - t0
    log("dp cards:", json.dumps(result))
    log("dp cards sds:", json.dumps(sds_line))
    result["sds"] = sds_line
    result["cli"] = cli_phase(workdir, world)
    return result


# phase 14: the JAX package's measurement tools, ported
BENCH_POSITIVE = ("value", "vs_baseline", "steps_per_sec",
                  "rays_per_sec_isolated", "rays_per_sec_late",
                  "rays_per_sec_epoch_loop", "compile_s", "step_gflops",
                  "mfu_vs_bf16_peak")
BENCH_FINITE = ("loss", "kernel_build_s")
BENCH_SDS = ("sds_step_ms_s05", "sds_step_ms_s02",
             "sds_step_ms_bf16_s05_late")
# the profilers' runs after the bench: (module under morpheus_tpu_torch,
# arguments)
BENCH_TOOLS = (("scripts.bench_gather", []),
               ("scripts.profile_step", ["base", "occ_off", "late"]),
               ("scripts.profile_step", ["--roofline", "300"]),
               ("scripts.trace_step", ["base"]),
               ("scripts.profile_sds", ["s02"]),
               ("scripts.bench_dense_scale", ["--smoke"]),
               ("entry", []))


def run_tool(module: str, args: list, env_extra=None,
             timeout: int = 600) -> str:
    """python -m morpheus_tpu_torch.<module> on the card; its lines are
    echoed (standard output, then standard error); a non-zero exit
    raises. Returns its standard output."""
    cmd = [sys.executable, "-m", f"morpheus_tpu_torch.{module}", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=dict(os.environ,
                                                  **(env_extra or {})),
                          capture_output=True, text=True, timeout=timeout)
    for line in (proc.stdout + proc.stderr).splitlines():
        log(f"  {line}")
    log(f"tool: {' '.join(cmd[1:])} exited {proc.returncode} after "
        f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}")
    return proc.stdout


def check_bench(text: str, card_name: str) -> dict:
    """The bench's last JSON line, held to phase 14's terms: every real-step
    field finite and > 0 (loss and kernel_build_s finite), the three
    default SDS fields present, finite and > 0 with nothing skipped, and
    `device` naming the card."""
    import math
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError("the bench printed no JSON line")
    out = json.loads(lines[-1])

    def finite(v):
        return isinstance(v, (int, float)) and math.isfinite(v)
    faults = [k for k in BENCH_POSITIVE + BENCH_SDS
              if not (finite(out.get(k)) and out[k] > 0)]
    faults += [k for k in BENCH_FINITE if not finite(out.get(k))]
    if "sds_skipped" in out:
        faults.append(f"sds_skipped {out['sds_skipped']}")
    if card_name not in str(out.get("device")):
        faults.append(f"device {out.get('device')!r} is not {card_name!r}")
    if faults:
        raise AssertionError(f"bench line: {faults}")
    return out


def gather_modes(text: str) -> dict:
    """bench_gather's results by mode, its kernels' launches checked: each
    mode of a kernel route launched every kernel of the route (the script
    checks errors and launches itself)."""
    from morpheus_tpu_torch.scripts.bench_gather import MODES, ROUTE_KERNELS
    res = {r["mode"]: r for r in _json_lines(text, "bench_gather:")}
    if sorted(res) != sorted(MODES):
        raise AssertionError(f"bench_gather modes {sorted(res)}")
    for mode, r in res.items():
        if any(r["launches"][k] < 1 for k in ROUTE_KERNELS[mode]):
            raise AssertionError(f"bench_gather {mode}: {r['launches']}")
    return res


def bench_gather_lines(device) -> dict:
    """Kernel lines (as phase 3's) on bench_gather's stream, the bench
    point's (10 levels x 327,680 rows of a 16-level 2^15 grid, C=4, f32):
    the histogram of its hist_rows backward, the gather of its mxu_rows
    forward (three planes) and its mxu_rows_bf16 forward (one), the
    segment sum of its sort_pallas_rows backward (the stable sort's keys,
    read through its order) and the row gather of its hist_rows forward.
    Cases bench_gather_<mode>."""
    import torch
    from morpheus_tpu_torch.scripts.bench_gather import make_stream
    st = make_stream(device)
    idx, emb, ct, starts = st["idx"], st["emb"], st["ct"], st["starts"]
    T = emb.shape[0]
    keys, order = torch.sort(global_rows(idx, starts).to(torch.int32),
                             stable=True)
    return {"level_histogram": [hist_line("bench_gather_hist_rows", idx, ct,
                                          starts, T, {})],
            "level_gather": [gather_line("bench_gather_mxu_rows", idx, emb,
                                         starts, 3),
                             gather_line("bench_gather_mxu_rows_bf16", idx,
                                         emb, starts, 1)],
            "segment_sum_sorted": [segsum_line(
                "bench_gather_sort_pallas_rows", keys, ct, T,
                {"order": order})],
            "row_gather": [rows_line("bench_gather_hist_rows", idx, emb,
                                     starts)]}


def bench_phase(device) -> dict:
    """Phase 14: `python -m morpheus_tpu_torch.bench` (pause off), its line
    checked (check_bench) and printed as a `bench:` line; then each of
    BENCH_TOOLS, bench_gather's modes and launches checked (gather_modes);
    then each kernel on bench_gather's stream against its plain version
    (bench_gather_lines: rows)."""
    import torch
    t0 = time.perf_counter()
    out = check_bench(run_tool("bench", [], {"MORPHEUS_BENCH_NO_PAUSE": "1"},
                               timeout=900),
                      torch.cuda.get_device_name(0))
    log("bench:", json.dumps(out))
    result = {"bench": out, "bench_s": time.perf_counter() - t0}
    for module, args in BENCH_TOOLS:
        text = run_tool(module, args)
        if module == "scripts.bench_gather":
            result["gather"] = gather_modes(text)
    result["rows"] = bench_gather_lines(device)
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 14 seconds: {result['seconds']:.1f}")
    return result


# ---- phase 15: the chained real step (tpu.chain_steps) ---------------------

# two blocks of configs/synthetic_bench.yaml's real_freq 10 (n_iters 1) at
# epochs 100 and 101: 10, then 12 active levels (a second graph), the
# learning rate and max_level's mask changing between them; from global
# step 1000, so that the sampled refresh of step 1008 falls in the first
# block
CHAIN_EPOCHS = (100, 101)
CHAIN_STEP0 = 1000
# (label, vjp_mode, tpu overrides): the three routes, and the bf16 policy
# under the default route
CHAIN_RUNS = (("hist_rows", "hist_rows", {}),
              ("mxu_rows", "mxu_rows", {}),
              ("sort_pallas_rows", "sort_pallas_rows", {}),
              ("bf16_hist_rows", "hist_rows", {"compute_dtype": "bfloat16"}))
# graphed against eager where the kernels sum with float atomics in the
# order the card runs them (level_histogram; index_add_ in every mode
# but under deterministic algorithms): the parameters within 2*n*lr after
# n steps (phase 8's tolerance: Adam with eps 1e-15 turns a round-off
# gradient into a full-lr move) and the occupancy EMA within 1e-3 of its
# largest value; the losses are reported, not held: a step's loss
# depends on which samples the budget keeps (a top-k of march scores), so
# last-bit differences can flip a selection and move one step's loss by a
# fraction of a percent (0.37% in one run), and a second eager run is the
# control beside it; sort_pallas_rows under deterministic algorithms bit
# for bit, losses included
CHAIN_OCC_REL = 1e-3
# timed steps each of the eager and the graphed step (hist_rows)
CHAIN_TIMED = 10


def chain_trainer(device, ds, mode: str, tpu: dict, chain: bool,
                  reducer=None, cfg=None):
    """A Trainer of cfg (by default configs/synthetic_bench.yaml) under
    `mode` and the tpu overrides, tpu.chain_steps `chain`, one iteration
    an epoch, at global step CHAIN_STEP0; with `reducer`, a rank of its
    process group."""
    import copy

    from morpheus_tpu_torch.config import load_config
    from morpheus_tpu_torch.train.trainer import Trainer
    cfg = copy.deepcopy(cfg) if cfg is not None else load_config(
        os.path.join(HERE, "configs", "synthetic_bench.yaml"))
    cfg["tpu"].update(vjp_mode=mode, chain_steps=chain, **tpu)
    cfg["train"]["n_iters"] = 1
    tr = Trainer(cfg, ds, device=device, reducer=reducer)
    tr.global_step = tr.host_step = CHAIN_STEP0
    return tr


def chain_blocks(tr, deterministic: bool) -> dict:
    """train_one_epoch at each of CHAIN_EPOCHS (under torch's deterministic
    algorithms when asked), launches counted from 0 over them; the
    losses, seconds, launches and the trainer's captures."""
    import warnings

    import torch
    reset_counts()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    losses = []
    try:
        with warnings.catch_warnings():
            # cumsum warns; its per-ray scans are short rows
            warnings.simplefilter("ignore", UserWarning)
            _sync(tr.device)
            t0 = time.perf_counter()
            for epoch in CHAIN_EPOCHS:
                tr.epoch = epoch
                losses.append(tr.train_one_epoch())
            _sync(tr.device)
    finally:
        torch.use_deterministic_algorithms(False)
    return {"losses": losses, "seconds": time.perf_counter() - t0,
            "launches": read_counts(), "captures": list(tr.captures)}


def chain_compare(eager, graphed, bitwise: bool, losses=((), ())) -> dict:
    """Graphed against eager after the same blocks: the parameters, the
    optimizer's slots and step, the occupancy grid, the draws' generator
    state and the blocks' losses (eager's, graphed's); bit for bit, or
    within the stated tolerances (the losses then reported only)."""
    import torch
    n = len(CHAIN_EPOCHS) * eager.config["train"]["real_freq"]
    lr = max(float(eager.curr.learning_rate(e)) for e in CHAIN_EPOCHS)
    groups = {"params": (eager.params, graphed.params),
              "step": ([eager.optim.step], [graphed.optim.step]),
              "occ": ([eager.occ.occs], [graphed.occ.occs]),
              # a function of occs: within the tolerance a cell at its
              # threshold may read either way, so counted, not held
              "binaries": ([eager.occ.binaries], [graphed.occ.binaries])}
    groups.update({k: (getattr(eager.optim, k), getattr(graphed.optim, k))
                   for k in eager.optim.SLOTS})
    out = {"generator_equal": torch.equal(
        eager.draws.generator.get_state(), graphed.draws.generator.get_state()),
        "global_step": [eager.global_step, graphed.global_step]}
    for name, (xs, ys) in groups.items():
        out[f"{name}_equal"] = all(torch.equal(x, y) for x, y in zip(xs, ys))
        out[f"{name}_max_abs_diff"] = max(
            float((x.detach().double() - y.detach().double()).abs().max())
            for x, y in zip(xs, ys))
    out["binaries_cells_differ"] = int(
        (eager.occ.binaries != graphed.occ.binaries).sum())
    out["param_limit"] = 2 * n * lr
    out["occ_limit"] = CHAIN_OCC_REL * float(eager.occ.occs.abs().max())
    bad = [k for k in ("generator_equal",) if not out[k]]
    if eager.global_step != graphed.global_step:
        bad.append("global_step")
    out["losses_max_rel_diff"] = max(
        [abs(a - b) / abs(a) for a, b in zip(*losses)], default=0.0)
    if bitwise:
        bad += [f"{k}_equal" for k in groups if not out[f"{k}_equal"]]
        if list(losses[0]) != list(losses[1]):
            bad.append("losses")
    else:
        if out["params_max_abs_diff"] > out["param_limit"]:
            bad.append("params")
        if out["occ_max_abs_diff"] > out["occ_limit"]:
            bad.append("occ")
        if not out["step_equal"]:
            bad.append("step")
    out["failed"] = bad
    return out


def chain_timing(device, ds) -> dict:
    """real_step_ms of the eager step (real_step) and of the graphed step
    (chained_real_step, a replay) at the second block's point (12 levels),
    each step ending in a synchronize (median of CHAIN_TIMED, steps on the
    refresh cadence skipped), and the epoch loop's rays/s of each: one
    train_one_epoch() of 10 iterations (100 real steps, refreshes and the
    EMA included) after one of one iteration that settles."""
    import torch
    out = {}
    for chain in (False, True):
        tr = chain_trainer(device, ds, "hist_rows", {}, chain)
        times = chain_step_ms(tr)
        tr.train_one_epoch()                          # settles
        tr.config["train"]["n_iters"] = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_one_epoch()
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / (10 * 10)
        key = "graphed" if chain else "eager"
        out[f"{key}_step_ms"] = statistics.median(times)
        out[f"{key}_steps_ms"] = times
        out[f"{key}_epoch_rays_per_s"] = (tr.config["train"]["real_ray_num"]
                                          / per_step)
        if chain:
            out["captures"] = list(tr.captures)
        del tr
        torch.cuda.empty_cache()
    out["card"] = card_line()
    return out


def chain_step_ms(tr, n: int = CHAIN_TIMED) -> list:
    """The ms of n steps of tr at CHAIN_EPOCHS[1] (12 levels), chained
    (chained_real_step) under tpu.chain_steps, else eager (real_step), each
    ending in a synchronize, after one that settles (a capture when
    chained); steps on the refresh cadence skipped."""
    tr.epoch = CHAIN_EPOCHS[1]
    tr._set_levels(tr._active_levels())
    step = tr.chained_real_step if tr.chain else tr.real_step
    every = tr.config["tpu"]["occ_update_every"]
    step(tr.epoch)
    times = []
    for _ in range(n):
        if tr.global_step % every == 0:
            tr.global_step += 1
        _sync(tr.device)
        t0 = time.perf_counter()
        step(tr.epoch)
        _sync(tr.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def chain_phase(device, ds) -> dict:
    """Phase 15: tpu.chain_steps on the card. For each of CHAIN_RUNS an
    eager and a graphed trainer from the same seed take the two blocks of
    CHAIN_EPOCHS (a refresh in the first, a level count change between
    them: two captures) and are compared (chain_compare: bit for bit under
    sort_pallas_rows with deterministic algorithms, both runs; within the
    stated tolerances elsewhere); every kernel of the mode must have run on
    every step of the graphed blocks, counted as each replay's captured
    calls; then one replayed block (10 steady chained steps) is traced and
    each kernel of the mode must be in it, as often as its counter says.
    Then chain_timing under hist_rows. `chain:` lines; returns the
    result."""
    import torch
    from morpheus_tpu_torch.scripts.trace_step import trace_steps
    t0 = time.perf_counter()
    result = {"runs": {}}
    for label, mode, tpu in CHAIN_RUNS:
        det = mode == "sort_pallas_rows"
        eager = chain_trainer(device, ds, mode, tpu, False)
        e = chain_blocks(eager, det)
        graphed = chain_trainer(device, ds, mode, tpu, True)
        g = chain_blocks(graphed, det)
        if len(g["captures"]) != len(CHAIN_EPOCHS) or e["captures"]:
            raise AssertionError(f"chain {label}: captures {g['captures']} "
                                 f"(eager {e['captures']})")
        cmp = chain_compare(eager, graphed, bitwise=det,
                            losses=(e["losses"], g["losses"]))
        control = None
        if not det:
            # a second eager run: how far two eager runs part
            again = chain_trainer(device, ds, mode, tpu, False)
            a = chain_blocks(again, det)
            control = chain_compare(eager, again, bitwise=False,
                                    losses=(e["losses"], a["losses"]))
            del again
        del eager
        n_steps = graphed.global_step - CHAIN_STEP0
        for k, v in g["launches"].items():
            if (v < n_steps) if k in PATH_KERNELS[mode] else v:
                raise AssertionError(f"chain {label}: {k} launched {v} "
                                     f"times in {n_steps} graphed steps")
        counted = read_counts()
        trace = trace_steps(graphed, n=graphed.config["train"]["real_freq"],
                            log=log, chained=True)
        per_step = {k: (v - counted[k]) / (trace["steps"] + 1)
                    for k, v in read_counts().items()}
        for k in PATH_KERNELS[mode]:
            seen = trace[f"{k}_launches_per_step"]
            if not seen or seen != per_step[k]:
                raise AssertionError(f"chain {label}: the trace of a "
                                     f"replayed block shows {seen} {k} a "
                                     f"step, its counter {per_step[k]}")
        run = {"vjp_mode": mode, "tpu": tpu, "deterministic": det,
               "eager": e, "graphed": g, "compare": cmp,
               "eager_control": control,
               "counted_per_step": per_step, "card": card_line(),
               "trace": {k: v for k, v in trace.items()
                         if k in ("step_ms_traced", "kernels_per_step",
                                  "device_busy_ms_per_step",
                                  "device_idle_share")
                         or any(k.startswith(n) for n in PATH_KERNELS[mode])}}
        log("chain:", json.dumps({"run": label, **run}))
        if cmp["failed"]:
            raise AssertionError(f"chain {label}: graphed and eager differ "
                                 f"in {cmp['failed']}")
        result["runs"][label] = run
        del graphed
        torch.cuda.empty_cache()
    result["timing"] = chain_timing(device, ds)
    result["seconds"] = time.perf_counter() - t0
    log("chain timing:", json.dumps(result["timing"]))
    log(f"phase 15 seconds: {result['seconds']:.1f}")
    return result


def largest_row(step: list) -> dict:
    """The kernel line of the largest call among `step`'s lines."""
    return max(step, key=lambda r: r["L"] * r["Np"] * r["C"]
               if "Np" in r else r["N"] * r["C"])


def kernels_line(rows, main, cli, sds, sds_cli, modes, mesh_row,
                 pipeline, dp, gather=None, chain=None) -> dict:
    """The {"kernels": [...]} record: each kernel's numbers at its largest
    call of a steady step under its own mode (rows: every kernel line,
    by kernel), its launches on the main path, per launch in each mode's
    trace, in the CLI runs, at the SDS points, in phase 11 and in phase
    12's supervised CLI and viewer (pipeline_launches), its launches in
    each rank of phase 13 under each mode and in its SDS steps
    (dp_launches), and its largest SDS, exact, bf16 and data-parallel
    step calls (sds_case, exact_case, bf16_case, dp_case);
    level_gather's mesh-export call (mesh_case) and the viewer's per-frame
    query call (viewer_case); with phase 14's bench_gather results
    (gather), its launches in each mode's checked calls
    (bench_gather_launches) and its largest call on bench_gather's stream
    (bench_gather_case); with phase 15's result (chain), its launches in
    each run's graphed blocks, each replay counted (chain_launches); with
    phase 13's chained records, its launches in the one-rank group's
    graphed blocks under each mode and in each rank's chained block
    (dp_chain_launches)."""

    def entry(name, replaces, mode):
        # the kernel's numbers at its largest captured call of a step under
        # its own mode (every case is on a line above); launches from that
        # mode's main path; device time per launch from each mode's trace
        row = largest_row([r for r in rows[name]
                           if r["case"].startswith(f"step_{mode}_")
                           and r["phase"] == "step"])
        return {"name": name, "route": "cuda",
                "source": f"morpheus_tpu_torch/kernels/{name}.cu",
                "replaces": replaces, "case": row["case"],
                "launches": main[mode]["launches"][name],
                "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                "ms": row["ms"], "call_ms": row["call_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "device_ms_per_launch": {
                    m: main[m]["trace"][f"{name}_ms_per_launch"]
                    for m, ks in PATH_KERNELS.items() if name in ks},
                "cli_launches": [n[name] for n in cli["kernel_launches"]],
                "sds_launches": {f"epoch_{p['epoch']}": p["launches"][name]
                                 for p in sds["points"]},
                "sds_cli_launches": [n[name]
                                     for n in sds_cli["kernel_launches"]],
                "sds_case": largest_case(name, f"step_sds_{mode}_"),
                "exact_case": largest_case(name, f"step_exact_{mode}_"),
                "bf16_case": largest_case(name, f"step_bf16_{mode}_"),
                "modes_launches": {
                    "exact": modes["exact"]["launches"][name],
                    "bf16": modes["bf16"]["launches"][name],
                    **{k: v["launches"][name]
                       for k, v in modes["options"].items()},
                    "exact_cli": modes["cli"]["kernel_launches"][name]},
                "pipeline_launches": {
                    k: v[name] for k, v in pipeline["launches"].items()},
                "dp_launches": {
                    **{m: [r[m][name] for r in dp["launches"]]
                       for m in PATH_KERNELS},
                    "sds": [r[name] for r in dp["sds"]["launches"]]},
                "dp_case": largest_case(name, f"step_dp_{mode}_"),
                **({"dp_chain_launches": {
                    **{m: r["graphed"]["launches"][name] for m, r in
                       dp["one_rank_chain"]["runs"].items()},
                    "ranks": [r[name] for r in dp["chain"]["launches"]]}}
                   if "one_rank_chain" in dp else {}),
                **({"bench_gather_launches": {
                    m: r["launches"][name] for m, r in gather.items()},
                    "bench_gather_case": largest_case(name, "bench_gather_")}
                   if gather else {}),
                **({"chain_launches": {
                    k: r["graphed"]["launches"][name]
                    for k, r in chain["runs"].items()}} if chain else {})}

    def largest_case(name, prefix):
        # the kernel's largest call among the lines of one captured step
        # (the SDS step at scale 0.5, the exact step, the bf16 step, rank
        # 0's data-parallel step) under its own mode
        row = largest_row([r for r in rows[name]
                           if r["case"].startswith(prefix)])
        return {k: row[k] for k in ("case", "dtype", "table", "max_abs_err",
                                    "ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms") if k in row}

    out = {"kernels": [
        entry("level_histogram", "morpheus_tpu/ops/hist_pallas.py:106",
              "hist_rows"),
        entry("segment_sum_sorted", "morpheus_tpu/ops/segsum_pallas.py:82",
              "sort_pallas_rows"),
        entry("level_gather", "morpheus_tpu/ops/gather_pallas.py:80",
              "mxu_rows"),
        # no Pallas kernel: the JAX package gathers these rows with a take
        entry("row_gather", None, "hist_rows")]}
    # the mesh export's call under mxu_rows (phase 9) and the viewer's
    # per-frame query (phase 12)
    for key, row in (("mesh_case", mesh_row), ("viewer_case",
                                                pipeline["row"])):
        out["kernels"][2][key] = {
            k: row[k] for k in ("case", "launches", "L", "Np", "C", "S",
                                "max_abs_err", "ms", "call_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from morpheus_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = kernels.build_all()
    log(f"kernel build seconds (in parallel): {secs}")
    for name, text in kernels.build_logs.items():
        log(f"--- nvcc {name}\n{text.strip()}")

    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        return run(device, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run(device, card: str, workdir: str) -> int:
    import torch
    if "--sds-only" in sys.argv[1:]:
        from morpheus_tpu_torch.config import load_config
        from morpheus_tpu_torch.data.dataset import load_synthetic
        ds = load_synthetic(load_config(os.path.join(
            HERE, "configs", "synthetic_full.yaml")))
        sds, sds_rows = sds_phase(device, ds)
        del ds
        sds_small_reference(device)
        sds_cli_phase(workdir)
        log("sds only: the SDS phase, its kernel lines and the SDS CLI "
            "passed", json.dumps({k: len(v) for k, v in sds_rows.items()}))
        return 0
    if "--modes-only" in sys.argv[1:]:
        from morpheus_tpu_torch.config import load_config
        from morpheus_tpu_torch.data.dataset import load_synthetic
        ds = load_synthetic(load_config(os.path.join(
            HERE, "configs", "synthetic_bench.yaml")))
        modes, modes_rows = modes_phase(device, ds, workdir)
        log("modes only: phase 11 passed", json.dumps(
            {k: len(v) for k, v in modes_rows.items()}))
        return 0
    if "--pipeline-only" in sys.argv[1:]:
        pipeline_phase(device, workdir)
        log("pipeline only: preprocessing, the supervised CLI with the CLIP "
            "eval, the viewer and its level_gather call passed")
        return 0
    if "--dp-cards" in sys.argv[1:]:
        dp_cards_phase(workdir)
        log("dp cards: data parallelism over every card passed")
        return 0
    if "--dp-only" in sys.argv[1:]:
        dp, dp_rows = dp_phase(device, workdir)
        log("dp only: phase 13 passed", json.dumps(
            {k: len(v) for k, v in dp_rows.items()}))
        return 0
    if "--bench-only" in sys.argv[1:]:
        bench_phase(device)
        log("bench only: phase 14 passed")
        return 0
    if "--chain-only" in sys.argv[1:]:
        from morpheus_tpu_torch.config import load_config
        from morpheus_tpu_torch.data.dataset import load_synthetic
        chain_phase(device, load_synthetic(load_config(os.path.join(
            HERE, "configs", "synthetic_bench.yaml"))))
        log("chain only: phase 15 passed")
        return 0
    if "--cli-only" in sys.argv[1:]:
        check_mesh_gather(device, workdir)
        cli_phase(workdir)
        log("cli only: the mesh export's level_gather and the CLI phase "
            "passed")
        return 0
    laps = Laps()
    rows = {"level_histogram": check_hist(device),
            "level_gather": check_gather(device)}
    rows["segment_sum_sorted"], sort_row = check_segsum(device)
    rows["row_gather"] = check_rows(device)
    check_double_backward(device)
    laps("3-4 kernel checks")
    if "--kernels-only" in sys.argv[1:]:
        log("kernels only: every kernel built and matched its plain twin")
        return 0

    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.config import load_config
    t0 = time.perf_counter()
    ds = load_synthetic(load_config(os.path.join(HERE, "configs",
                                                 "synthetic_bench.yaml")))
    log(f"synthetic scene made in {time.perf_counter() - t0:.1f} s")
    main = {}
    for mode, n_timed in (("hist_rows", 20), ("mxu_rows", 10),
                          ("sort_pallas_rows", 10)):
        trainer, main[mode] = main_path(device, ds, mode, n_timed)
        # the step's own index streams, after the counted run
        calls = capture_streams(trainer)
        log(f"captured {mode}:", json.dumps(
            [f"{c['kernel']}/{c['phase']}" for c in calls]))
        main[mode]["trace"] = step_trace(trainer)
        del trainer
        for k, r in step_lines(mode, calls).items():
            rows[k] += r
        del calls
        torch.cuda.empty_cache()
    laps("5-7 main path")
    # phase 8b: the SDS virtual step on the same scene
    # (configs/synthetic_full.yaml has synthetic_bench's 32 frames at 360^2)
    sds, sds_rows = sds_phase(device, ds)
    for k, r in sds_rows.items():
        rows[k] += r
    laps("8b sds")
    for mode in PATH_KERNELS:
        small_reference(device, mode)
    sds_small_reference(device)
    laps("8 small references")
    log("sort of sort_pallas_rows:", json.dumps(sort_row))
    log("step ms by mode:", json.dumps({m: r["real_step_ms"]
                                        for m, r in main.items()}))
    mesh_row = check_mesh_gather(device, workdir)
    rows["level_gather"].append(mesh_row)
    # phases 9 and 10 drive CLI processes and read their artifacts: side by
    # side, the card and the host shared between them
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        cli_f = pool.submit(cli_phase, workdir)
        sds_cli_f = pool.submit(sds_cli_phase, workdir)
        cli, sds_cli = cli_f.result(), sds_cli_f.result()
    laps("9 and 10 cli, sds cli")
    # phase 11: the other modes of the training step
    modes, modes_rows = modes_phase(device, ds, workdir)
    for k, r in modes_rows.items():
        rows[k] += r
    laps("11 modes")
    # phase 15: the chained real step, on the same scene
    chain = chain_phase(device, ds)
    laps("15 chain")
    del ds
    torch.cuda.empty_cache()
    # phase 12: the pipeline around training
    pipeline = pipeline_phase(device, workdir)
    rows["level_gather"].append(pipeline["row"])
    laps("12 pipeline")
    # phase 13: data parallelism
    dp, dp_rows = dp_phase(device, workdir)
    for k, r in dp_rows.items():
        rows[k] += r
    laps("13 dp")
    # phase 14: the bench and the profilers
    bench = bench_phase(device)
    for k, r in bench["rows"].items():
        rows[k] += r
    laps("14 bench")

    kernels = kernels_line(rows, main, cli, sds, sds_cli, modes, mesh_row,
                           pipeline, dp, bench["gather"], chain)
    log("sds:", json.dumps({"setup": sds["setup"], "points": [
        {k: p[k] for k in ("epoch", "rays", "freeze", "active_levels",
                           "sds_step_ms", "peak_mem_gb", "launches_per_step",
                           "trace")}
        for p in sds["points"]], "cli": sds_cli}))
    log("modes summary:", json.dumps({
        "exact_step_ms": modes["exact"]["step_ms"],
        "bf16_step_ms": modes["bf16"]["step_ms"],
        "options_step_ms": {k: v["step_ms"]
                            for k, v in modes["options"].items()
                            if "step_ms" in v},
        "references": modes["references"]}))
    log("phase seconds:", json.dumps(laps.seconds))
    log(card)
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
