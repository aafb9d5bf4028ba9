#!/usr/bin/env python
"""Trace the real step of a profile_step variant at the bench's operating
point with torch.profiler and print the top ops by device time (the port
of scripts/trace_step.py):

    python -m morpheus_tpu_torch.scripts.trace_step [variant] [--device cpu]

6 warm-up steps, one more untraced, then 5 traced steps that refresh no
occupancy (a step on the refresh cadence is skipped over). trace_steps is
also chip_smoke.py's trace phase. On the CPU the profiler records host
ops, and their own (self) times stand in for device times.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from morpheus_tpu_torch import bench

# the port's hand-written kernels, by the names their wrappers launch
KERNELS = ("level_histogram", "level_gather", "segment_sum_sorted",
           "row_gather")

# idle seconds on the card at each end of a traced window: the profiler
# drops a device record whose time, mapped onto the host's clock, falls
# outside the window, and in a process that has run for minutes that
# mapping can place a window's last kernels after its end (a block of
# replayed steps lost ~550 of its ~30,500 kernels so, with the last step's
# histograms; an H100 run)
MARGIN_S = 0.05


def busy_us(intervals) -> float:
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


def trace_steps(trainer, n: int = 5, top: int = 8, log=bench.log,
                chained: bool = False) -> dict:
    """Trace n steady steps of `trainer` from its global step (after one
    untraced step): eager steps (real_step), or with `chained` the epoch
    loop's chained steps (chained_real_step: on a card replays of the
    step's CUDA graph). Device time by name: each kernel of the port, and
    the sorts (the route's stable row sort under sort_pallas_rows; the
    samples' sorts of the marcher on every path); the `top` names by time
    are logged as `trace:` lines, then the result as one `trace: {json}`
    line. On the CPU, host ops and their self times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = trainer.device.type == "cuda"
    every = trainer.config["tpu"]["occ_update_every"]
    step = trainer.chained_real_step if chained else trainer.real_step
    step(trainer.epoch)                                # untraced warm step
    bench.sync(trainer.device)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    margin = MARGIN_S if cuda else 0.0
    with profile(activities=activities) as prof:
        time.sleep(margin)
        t0 = time.perf_counter()
        for _ in range(n):
            if trainer.global_step % every == 0:
                trainer.global_step += 1
            step(trainer.epoch)
        bench.sync(trainer.device)
        window_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin)
    if cuda:
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = [(e, (e.time_range.end - e.time_range.start) / 1e3)
                for e in dev if "memcpy" not in e.name.lower()
                and "memset" not in e.name.lower()]
    else:
        dev = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        kern = [(e, e.self_cpu_time_total / 1e3) for e in dev]
    if not kern:
        raise AssertionError("the profiler saw no device kernels")
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in dev]) / 1e3
    by_name: dict = {}
    for e, ms in kern:
        k = by_name.setdefault(e.name[:80], [0, 0.0])
        k[0] += 1
        k[1] += ms
    result = {
        "vjp_mode": trainer.spec.grid.vjp_mode, "chained": chained,
        "steps": n, "step_ms_traced": window_ms / n,
        "kernels_per_step": len(kern) / n,
        "device_busy_ms_per_step": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / window_ms}
    for label in (*KERNELS, "sort"):
        # the sorts: kernels named for sorting, not segment_sum_sorted's
        hits = [v for k, v in by_name.items() if label in k.lower()
                and (label != "sort" or "segment_sum" not in k)]
        result[f"{label}_launches_per_step"] = sum(c for c, _ in hits) / n
        result[f"{label}_ms_per_step"] = sum(ms for _, ms in hits) / n
        launches = sum(c for c, _ in hits)
        result[f"{label}_ms_per_launch"] = (
            sum(ms for _, ms in hits) / launches if launches else None)
    for k, (c, ms) in sorted(by_name.items(),
                             key=lambda kv: -kv[1][1])[:top]:
        log(f"trace: {ms / n:8.3f} ms/step {c / n:7.1f} launches/step  {k}")
    log("trace:", json.dumps(result))
    return result


def main(argv=None) -> int:
    from morpheus_tpu_torch.scripts import profile_step
    from morpheus_tpu_torch.utils import resolve_device
    variants = dict(profile_step.VARIANTS)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variant", nargs="?", default="base",
                        choices=list(variants))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    trainer = profile_step.make_trainer(variants[args.variant], device)
    bench.run_steps(trainer, 6)
    trace_steps(trainer, n=5, top=40)
    return 0


if __name__ == "__main__":
    sys.exit(main())
