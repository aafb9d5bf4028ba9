#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (morpheus_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every hand-written kernel from the sources in this checkout;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the real-view training step gives it, and time kernel, plain
     version and one PyTorch library call computing the same function;
  4. double-backward check of the GatherRows / HistRows autograd pair on the
     card against the same computation on the CPU;
  5. the main path: Trainer(configs/synthetic_bench.yaml) on the card at full
     width, one epoch from step 0 (the full 128^3 warmup occupancy update)
     and 20 timed real steps from global step 256 (sampled occupancy
     updates at 256 and 272), with every kernel's launch count read;
  6. where a steady step's time goes: 5 steps that refresh no occupancy,
     traced with torch.profiler (device kernels per step, device busy time,
     the card's idle share, the level_histogram kernel's share);
  7. the main path at a tiny size on the card against the same run on the
     CPU (same parameters, same random draws).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of fn() over `reps` launches, after a warm-up."""
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


def hist_cases(device):
    """The level_histogram calls of one real step at configs/
    synthetic_bench.yaml: the hashed tail (11 levels of 32768 rows, Np =
    8 corners x 40,960 sites: 32,768 samples + 8,192 smoothness sites) with
    the fused sdf+color table (C=4) and the sdf-only table (C=2); the packed
    dense prefix (5 levels, C = 8 corners x 4); and one stream whose every
    update lands on one slot of its level."""
    import torch
    from morpheus_tpu_torch.ops.hashgrid import HashGridSpec
    grid = HashGridSpec(num_levels=16, level_dim=2, base_resolution=16,
                        log2_hashmap_size=15, desired_resolution=128)
    offs, res = grid.offsets, grid.resolutions
    k_pack = sum(1 for l in range(16) if res[l] ** 3 <= offs[l + 1] - offs[l])
    g = torch.Generator(device=device)
    g.manual_seed(0)
    P = 40960
    cases = []
    for name, starts, sizes, n_rows, C, Np in (
            ("hashed_c4", offs[k_pack:16], [offs[l + 1] - offs[l] for l in
                                            range(k_pack, 16)],
             offs[16], 4, 8 * P),
            ("hashed_c2", offs[k_pack:16], [offs[l + 1] - offs[l] for l in
                                            range(k_pack, 16)],
             offs[16], 2, 8 * P),
            ("packed_c32", [offs[l] for l in range(k_pack)],
             [offs[l + 1] - offs[l] for l in range(k_pack)], offs[k_pack],
             32, P)):
        idx = torch.stack([torch.randint(0, s, (Np,), generator=g,
                                         device=device, dtype=torch.int32)
                           for s in sizes])
        vals = torch.randn((len(sizes) * Np, C), generator=g, device=device)
        cases.append((name, idx, vals, list(starts), n_rows))
    L = 11
    cases.append(("one_slot", torch.zeros((L, 8 * P), dtype=torch.int32,
                                          device=device),
                  torch.ones((L * 8 * P, 4), device=device),
                  [l * 32768 for l in range(L)], L * 32768))
    return cases


def check_hist(device, timed: bool):
    """Phase 3: level_histogram against level_histogram_reference, both
    payload types. Tolerance: |kernel - plain| <= 1e-5 * (histogram of
    |payload|) + 1e-6 per slot - float32 sums taken in another order."""
    import torch
    from morpheus_tpu_torch.ops import hist
    rows_out = []
    worst = 0.0
    for name, idx, vals32, starts, n_rows in hist_cases(device):
        for dt in (torch.float32, torch.bfloat16):
            vals = vals32.to(dt)
            got = hist.level_histogram(idx, vals, starts, n_rows)
            ref = hist.level_histogram_reference(idx, vals, starts, n_rows)
            habs = hist.level_histogram_reference(idx, vals.abs(), starts,
                                                  n_rows)
            err = (got - ref).abs()
            bad = err > 1e-5 * habs + 1e-6
            if bool(bad.any()):
                raise AssertionError(f"level_histogram {name} {dt}: "
                                     f"{int(bad.sum())} slots off, max err "
                                     f"{float(err.max())}")
            max_err = float(err.max())
            worst = max(worst, max_err)
            row = {"case": name, "dtype": str(dt).split(".")[-1],
                   "L": idx.shape[0], "Np": idx.shape[1], "C": vals.shape[1],
                   "rows": n_rows, "max_abs_err": max_err}
            if timed:
                N, C = idx.numel(), vals.shape[1]
                st = torch.as_tensor(starts, device=device).reshape(-1, 1)
                glob = (idx.long() + st).reshape(-1)
                v32 = vals.float()
                lib = torch.zeros((n_rows, C), device=device)
                row["ms"] = time_ms(lambda: hist.level_histogram(
                    idx, vals, starts, n_rows))
                row["plain_ms"] = time_ms(lambda: hist.level_histogram_reference(
                    idx, vals, starts, n_rows))
                row["library_ms"] = time_ms(lambda: lib.index_add_(0, glob, v32))
                nbytes = N * 4 + N * C * vals.element_size() + n_rows * C * 4
                row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                      N * C / F32_OPS_PER_S) * 1e3
                row["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                                   >= N * C / F32_OPS_PER_S else "operations")
            rows_out.append(row)
            log("hist", json.dumps(row))
    # an empty stream launches nothing and is not counted
    n0 = hist.level_histogram.launches
    empty = hist.level_histogram(torch.zeros((2, 0), dtype=torch.int32,
                                             device=device),
                                 torch.zeros((0, 4), device=device), [0, 8], 16)
    if hist.level_histogram.launches != n0 or bool(empty.any()):
        raise AssertionError("level_histogram counted an empty stream")
    return rows_out, worst


def check_double_backward(device):
    """Phase 4: gradient and grad-of-grad through GatherRows / HistRows on
    `device` against the CPU, both payload types (rtol 1e-5, atol 1e-5)."""
    import torch
    from morpheus_tpu_torch.ops.hashgrid import take_hist_rows

    def run(dev, payload):
        g = torch.Generator().manual_seed(1)
        L, Np, C, size = 3, 1000, 4, 300
        emb = torch.randn((L * size, C), generator=g).to(dev).requires_grad_()
        idx = torch.randint(0, size, (L, Np), generator=g).to(dev)
        u = torch.randn((L * size, C), generator=g).to(dev)
        feats = take_hist_rows(emb, idx, [l * size for l in range(L)],
                               payload)
        loss = torch.sin(feats).sum()
        (ge,) = torch.autograd.grad(loss, emb, create_graph=True)
        (h,) = torch.autograd.grad((ge * u).sum(), emb)
        return ge.detach().cpu(), h.cpu()

    for payload in (None, torch.bfloat16):
        a, b = run(device, payload), run(torch.device("cpu"), payload)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    log("double backward: GatherRows/HistRows on", device, "match the CPU")


def main_path(device):
    """Phase 5: the real-view step at configs/synthetic_bench.yaml width."""
    import torch
    from morpheus_tpu_torch.config import load_config
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.ops import hist
    from morpheus_tpu_torch.train.trainer import Trainer

    cfg = load_config(os.path.join(HERE, "configs", "synthetic_bench.yaml"))
    t0 = time.perf_counter()
    ds = load_synthetic(cfg)
    trainer = Trainer(cfg, ds, device=device)
    log(f"main path: {ds.num_frames} frames at {ds.H}x{ds.W}, "
        f"{sum(p.numel() for p in trainer.params)} parameters, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    trainer.epoch = cfg["train"]["n_epochs"]          # all 16 levels active
    before = [p.detach().clone() for p in trainer.params]
    torch.cuda.reset_peak_memory_stats(device)

    hist.level_histogram.launches = 0                  # counts of this run
    t0 = time.perf_counter()
    loss0 = trainer.train_one_epoch(n_iters=1)         # steps 0..9
    torch.cuda.synchronize(device)
    epoch_s = time.perf_counter() - t0
    first_launches = hist.level_histogram.launches
    n_first = trainer.global_step
    trainer.global_step = 256                          # past occ warmup
    step_ms, per_step, losses = [], [], []
    for _ in range(20):
        n0 = hist.level_histogram.launches
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = trainer.real_step(trainer.epoch)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(hist.level_histogram.launches - n0)
        losses.append(float(loss))
    launches = hist.level_histogram.launches
    peak = torch.cuda.max_memory_allocated(device)

    if not (all(map(lambda v: v == v and abs(v) != float("inf"), losses))
            and loss0 == loss0):
        raise AssertionError(f"non-finite loss: {loss0}, {losses}")
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(before,
                                                          trainer.params))
    if moved < len(before) - 1:
        raise AssertionError(f"only {moved}/{len(before)} parameter tensors "
                             "changed")
    if first_launches < n_first or min(per_step) < 1:
        raise AssertionError(f"level_histogram did not run on every step: "
                             f"{first_launches} launches in {n_first} steps, "
                             f"per step {per_step}")
    med = statistics.median(step_ms)
    log(f"main path: epoch of {n_first} steps from step 0 (warmup occupancy "
        f"update) {epoch_s:.3f} s, loss {loss0}")
    log(f"main path: losses from step 256: {losses}")
    log(f"main path: step ms {[round(s, 3) for s in step_ms]}")
    log(f"main path: level_histogram launches per step {per_step}")
    result = {"real_step_ms": med, "rays_per_s": 2048 / (med / 1e3),
              "steps_timed": len(step_ms), "peak_mem_gb": peak / 1e9,
              "params_changed": f"{moved}/{len(before)}",
              "launches": launches, "card": card_line()}
    log("main path:", json.dumps(result))
    return trainer, result


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def step_trace(trainer, n: int = 5):
    """Phase 6: trace n steady steps (none refreshes the occupancy grid)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    every = trainer.config["tpu"]["occ_update_every"]
    trainer.global_step = 257
    trainer.real_step(trainer.epoch)                   # untraced warm step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            if trainer.global_step % every == 0:
                trainer.global_step += 1
            trainer.real_step(trainer.epoch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e for e in dev if "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]
    if not kern:
        raise AssertionError("the profiler saw no device kernels")
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3
    by_name: dict = {}
    for e in kern:
        k = by_name.setdefault(e.name[:80], [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    hist = [v for k, v in by_name.items() if "level_histogram" in k]
    result = {
        "steps": n, "step_ms_traced": window_ms / n,
        "kernels_per_step": len(kern) / n,
        "device_busy_ms_per_step": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "level_histogram_launches_per_step": sum(c for c, _ in hist) / n,
        "level_histogram_ms_per_step": sum(ms for _, ms in hist) / n}
    for k, (c, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"trace: {ms / n:8.3f} ms/step {c / n:7.1f} launches/step  {k}")
    log("trace:", json.dumps(result))
    return result


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


def small_reference(device):
    """Phase 6: four real steps of a tiny config on the card and on the CPU
    from the same parameters and draws: losses at rtol 1e-3, parameters
    within 2*n*lr (Adam with eps 1e-15 turns round-off gradients into
    full-lr moves)."""
    import torch
    from morpheus_tpu_torch.config import merge_defaults
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.train.trainer import Trainer
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
                "occ_update_every": 2, "grad_payload": "bfloat16"}})
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
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"tiny run losses differ: {lg} vs {lc}")
    worst = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
    if worst > 2 * 4 * lr:
        raise AssertionError(f"tiny run params differ by {worst}")
    log(f"small reference: card losses {lg}, CPU losses {lc}, max param "
        f"diff {worst} (limit {2 * 4 * lr})")


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

    secs = {name: kernels.build(name) for name in kernels.SIGNATURES}
    log(f"kernel build seconds: {secs}")
    for name, text in kernels.build_logs.items():
        log(f"--- nvcc {name}\n{text.strip()}")

    hist_rows, worst = check_hist(device, timed=True)
    check_double_backward(device)
    trainer, main = main_path(device)
    step_trace(trainer)
    del trainer
    small_reference(device)

    main_row = next(r for r in hist_rows if r["case"] == "hashed_c4"
                    and r["dtype"] == "bfloat16")
    # the kernel's numbers at its largest call of a step: the hashed tail of
    # the main closure, bf16 payloads (every case is on a "hist" line above)
    kernels_line = {"kernels": [{
        "name": "level_histogram", "route": "cuda",
        "source": "morpheus_tpu_torch/kernels/level_histogram.cu",
        "replaces": "morpheus_tpu/ops/hist_pallas.py:105",
        "launches": main["launches"], "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}
    log(card)
    log(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
