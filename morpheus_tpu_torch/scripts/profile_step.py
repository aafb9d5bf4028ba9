#!/usr/bin/env python
"""Ablation profiler of the real-view step at the bench's operating point
(the port of scripts/profile_step.py). Times a list of config variants,
each toggling one knob or zeroing one loss weight, so that the step's cost
is split by measurement on the card:

    python -m morpheus_tpu_torch.scripts.profile_step              # all
    python -m morpheus_tpu_torch.scripts.profile_step base hist    # subset
    python -m morpheus_tpu_torch.scripts.profile_step --roofline [EPOCH]
    python -m morpheus_tpu_torch.scripts.profile_step --compile-only

Each variant: a Trainer of bench.BENCH_POINT_CFG with the variant's
overrides on the 8-frame 128^2 synthetic scene, at epoch 300 (or the
variant's `_epoch`) and global step epoch * 110; 6 warm-up steps, then 24
enqueued back to back, one synchronize at the end.

--roofline: the step's phases at the bench point: forward (the real loss
alone), forward+backward (the loss and its gradient), the optimizer alone
and the full step, each timed with CUDA events over 24 calls. GFLOP is
torch.utils.flop_counter.FlopCounterMode's count (matrix products and
convolutions; the hand-written kernels count 0; forward+backward's is the
bench's step_gflops, bench.real_step_flops), `res GB` the peak memory
allocated while the phase runs, `%peak` GFLOP/s against the card's dense
bf16 peak (bench.CARDS); the copy line calibrates the card's memory rate
with a 1 GiB out-of-place copy. XLA's cost model and memory analysis,
which scripts/profile_step.py prints, have no counterpart.

--compile-only: nothing is compiled ahead of a run in the port; this
builds the hand-written kernels (kernels.build_all) and exits.

--device cpu runs on the CPU (default: the card).
"""
from __future__ import annotations

import argparse
import copy
import sys

import torch

from morpheus_tpu_torch import bench

VARIANTS = [
    ("base", {}),
    ("hist", {"tpu": {"vjp_mode": "hist_rows"}}),
    ("mxu", {"tpu": {"vjp_mode": "mxu_rows"}}),
    ("late_mxu", {"_epoch": 1900, "tpu": {"vjp_mode": "mxu_rows"}}),
    # occupancy-refresh ablation: the cadence pushed past the timing window,
    # so the sampled refresh never fires: base minus this = its cost
    ("occ_off", {"tpu": {"occ_update_every": 1 << 30}}),
    ("occ_32", {"tpu": {"occ_update_every": 32}}),
    ("occ_linear", {"tpu": {"occ_query_interp": "linear"}}),
    # late-curriculum point (all 16 hash levels active)
    ("late", {"_epoch": 1900}),
    ("late_hist", {"_epoch": 1900, "tpu": {"vjp_mode": "hist_rows"}}),
    ("no_band", {"train": {"normal_smoothness": 0.0}}),
    ("no_perturb", {"train": {"normal_smooth_3d": 0.0}}),
    ("no_smooth", {"train": {"normal_smoothness": 0.0,
                             "normal_smooth_3d": 0.0}}),
    ("no_merge", {"tpu": {"merge_smooth": False}}),
    ("bf16", {"tpu": {"compute_dtype": "bfloat16"}}),
    ("bf16_mlp", {"tpu": {"mlp_dtype": "bfloat16"}}),
    ("late_bf16_mlp", {"_epoch": 1900, "tpu": {"mlp_dtype": "bfloat16"}}),
    ("no_code", {"train": {"code_reg": 0.0}}),
    ("no_orient", {"train": {"ori_weight": 0.0}}),
    ("render_only", {"train": {"normal_smoothness": 0.0,
                               "normal_smooth_3d": 0.0, "ori_weight": 0.0,
                               "code_reg": 0.0, "beta_weight": 0.0}}),
]


def make_trainer(overrides: dict, device, frames: int = 8, hw: int = 128,
                 base: dict | None = None):
    """A Trainer of `base` (BENCH_POINT_CFG) with `overrides` (a VARIANTS
    entry; `_epoch` picks the epoch, 300 by default) at that epoch and
    global step epoch * 110."""
    from morpheus_tpu_torch.train.trainer import Trainer
    overrides = copy.deepcopy(overrides)
    ep = int(overrides.pop("_epoch", bench.BENCH_EPOCH))
    cfg = bench.bench_config(overrides, base)
    trainer = Trainer(cfg, bench.make_dataset(cfg, frames, hw), device=device)
    bench.set_point(trainer, ep, ep * bench.STEPS_PER_EPOCH)
    return trainer


def time_variant(name: str, overrides: dict, device="cuda", frames: int = 8,
                 hw: int = 128, warmup: int = 6, n: int = 24,
                 base: dict | None = None, log=bench.log) -> float:
    """Seconds a real step of one variant (module doc); prints its line."""
    trainer = make_trainer(overrides, device, frames, hw, base)
    dt, warm_s, loss = bench.time_steps(trainer, n, warmup)
    rays = trainer.config["train"]["real_ray_num"]
    log(f"{name:14s} {dt * 1e3:7.1f} ms/step  {rays / dt:9.0f} rays/s  "
        f"(warm-up {warm_s:.1f}s, loss {loss:.3f})")
    return dt


def stream_gbps(device, n_mib: int = 1024) -> float:
    """The memory rate of `device`: an out-of-place copy of an n_mib
    buffer (each byte read once and written once), GB/s."""
    x = torch.zeros(n_mib * (1 << 20) // 4, device=device)
    y = torch.empty_like(x)
    ms = bench.time_ms(lambda: y.copy_(x), device, reps=8)
    return 2 * x.numel() * 4 / (ms / 1e3) / 1e9


def peak_gb(fn, device) -> float | None:
    """The peak memory allocated on the card while fn() runs, GB (None on
    the CPU)."""
    if torch.device(device).type != "cuda":
        fn()
        return None
    bench.sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    bench.sync(device)
    return torch.cuda.max_memory_allocated(device) / 1e9


def roofline(ep: int = bench.BENCH_EPOCH, device="cuda", frames: int = 8,
             hw: int = 128, n: int = 24, base: dict | None = None,
             stream_mib: int = 1024, log=bench.log) -> list:
    """The phase split of the real step (module doc); returns the rows
    (phase, ms, gflop, res_gb, pct_peak)."""
    trainer = make_trainer({"_epoch": ep}, device, frames, hw, base)
    max_level = trainer.curr.max_level(ep)
    lr = trainer.curr.learning_rate(ep)

    def fwd():
        return trainer._real_loss(trainer.occ, trainer.draws, ep,
                                  max_level)[0]

    def fwd_bwd():
        return trainer._grads(fwd())

    grads = fwd_bwd()
    phases = [("forward", fwd), ("fwd+bwd", fwd_bwd),
              ("optimizer", lambda: trainer.optim.update(grads, lr)),
              ("full step", lambda: trainer.real_step(ep))]
    peak = bench.card_peak(device)
    gbps = stream_gbps(device, stream_mib)
    spec = (f"{100 * gbps / (peak['hbm_bytes_per_s'] / 1e9):.0f}% of the "
            f"card's {peak['hbm_bytes_per_s'] / 1e9:.0f} GB/s"
            if peak else "no rate on record for this device")
    log(f"stream calibration ({stream_mib} MiB copy): {gbps:.0f} GB/s "
        f"measured ({spec}); {bench.card_line(device)}")
    log(f"{'phase':10s} {'ms':>8s} {'GFLOP':>8s} {'res GB':>7s} "
        f"{'%peak':>6s}   (ms: CUDA events; GFLOP: FlopCounterMode, "
        "kernels count 0; res GB: peak allocated; %peak: of dense bf16)")
    rows = []
    for name, fn in phases:
        gflop = bench.count_flops(fn) / 1e9
        res = peak_gb(fn, device)
        ms = bench.time_ms(fn, device, reps=n)
        pct = (100 * gflop * 1e9 / (ms / 1e3) / peak["bf16_flops"]
               if peak else None)
        rows.append((name, ms, gflop, res, pct))
        log(f"{name:10s} {ms:8.2f} {gflop:8.1f} "
            f"{'n/a' if res is None else f'{res:.2f}':>7s} "
            f"{'n/a' if pct is None else f'{pct:.2f}':>6s}")
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*",
                        help="variants (default: all); with --roofline, "
                             "the epoch; roofline<EPOCH> runs a roofline")
    parser.add_argument("--roofline", action="store_true")
    parser.add_argument("--compile-only", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from morpheus_tpu_torch import kernels
    from morpheus_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    if args.compile_only:
        print(f"kernel build seconds: {kernels.build_all()}", flush=True)
        return 0
    if args.roofline:
        roofline(int(args.names[0]) if args.names else bench.BENCH_EPOCH,
                 device)
        return 0
    wanted = [n for n in args.names if not n.startswith("roofline")]
    unknown = set(wanted) - {n for n, _ in VARIANTS}
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}; have "
                     f"{[n for n, _ in VARIANTS]}")
    for rl in (n for n in args.names if n.startswith("roofline")):
        roofline(int(rl[len("roofline"):] or bench.BENCH_EPOCH), device)
    for name, ovr in VARIANTS:
        if name in wanted or not args.names:
            time_variant(name, ovr, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
