"""The port's bench: rays/s of the real-view step at a fixed operating point,
and the full-size Zero123 SDS step at the reference's two view sizes (the
port of bench.py). Prints ONE JSON line, then again a superset of it.

    python -m morpheus_tpu_torch.bench                # on the card
    BENCH_SDS=all python -m morpheus_tpu_torch.bench  # + two bf16 variants
    BENCH_SDS=0 python -m morpheus_tpu_torch.bench    # real step only

The operating point (BENCH_POINT_CFG, a copy of bench.py's): 2048 rays a
step, a 128^3 occupancy grid, 16 hash levels, step_size 0.01, sample /
band / smooth budgets 16 / 4 / 4, bf16 gradient payloads, on an 8-frame
128^2 synthetic scene, at epoch 300 (10 of the 16 levels unlocked) and
global step 33,000: past the occupancy warm-up, so the sampled refresh
fires every 16th step on 1/16 of the cells. The grid starts at its initial
value, as bench.py's state does.

Fields, in bench.py's names:
  value, steps_per_sec   40 chained real steps (Trainer.chained_real_step,
                         tpu.chain_steps: on the card each a replay of the
                         CUDA graph of the step, the occupancy refresh
                         eager between replays) enqueued back to back
                         after 2 that capture the graph and settle, one
                         torch.cuda.synchronize() at the end: the path
                         that `python -m morpheus_tpu_torch`'s epoch loop
                         runs, as bench.py's value times tpu.chain_steps
                         (10 steps in one TPU dispatch).
  rays_per_sec_isolated  32 eager steps (Trainer.real_step), each ending in
                         a synchronize (mean): chip_smoke.py's
                         real_step_ms protocol.
  rays_per_sec_late      epoch 1900, step 209,000, all 16 levels, 16 eager
                         steps back to back after 6 warm-up steps, as
                         bench.py times its unchained step there.
  rays_per_sec_epoch_loop  two train_one_epoch() calls at real_freq 10 and
                         n_iters 10 (110 real steps an epoch, as the JAX
                         count) after one that settles: what the CLI holds.
  vs_baseline            value over 30k rays/s, an A100 estimate of the
                         reference (220k steps of ~2.2k rays in ~4.5 h; the
                         reference publishes no number). Not a TPU number.
  compile_s              seconds of the 6 eager warm-up steps (nothing
                         compiles: the first steps pay the allocator and
                         cuBLAS / cuDNN set-up); the graph's capture is
                         in value's 2 settling steps, untimed.
  kernel_build_s         seconds of kernels.build_all() at the start; 0
                         when the kernels are already built in this
                         checkout, and on the CPU, which builds none.
  device                 the card's name and power limit, as `nvidia-smi
                         --query-gpu=name,power.limit` gives them ("cpu"
                         on the CPU).
  loss                   the last isolated step's loss.
  step_gflops            one real step's forward and backward counted by
                         torch.utils.flop_counter.FlopCounterMode: matrix
                         products and convolutions only; the hand-written
                         kernels (gathers, histograms, segment sums) and
                         the elementwise work count 0.
  mfu_vs_bf16_peak       step_gflops over value's step time, against the
                         card's dense bf16 tensor-core peak (CARDS); absent
                         on a card not in CARDS, with a `notes` entry.
  sds_step_ms_s05, sds_step_ms_s02, sds_step_ms_bf16_s05_late
                         one SDS virtual step (virtual_sampler + virtual_step,
                         the calls train_one_epoch makes) on a 360^2 scene
                         with a full-size random-weight Zero123
                         (Zero123Guidance.init_random, seed 1): float32 at
                         scale 0.5 (32,400 rays) and 0.2 (5,184 rays) at
                         epoch 300, and the bf16 UNet at scale 0.5 at epoch
                         1900 (all 16 levels); 3 warm-up steps, then 8
                         timed, one synchronize at the end. BENCH_SDS=all
                         adds sds_step_ms_bf16_s05 and _s02 (epoch 300).
  sds_skipped            {label: reason} for a variant not run (BENCH_SDS=0,
                         or past BENCH_BUDGET_S seconds, default 5400).
bench.py's xla_cost_bytes_gb (XLA's pre-fusion byte estimate) has no
counterpart: eager PyTorch has no cost model of the whole step.

Card ownership: a full-budget supervisor's trainer (its supervisor's pid in
$MORPHEUS_FULLRUN_PIDFILE, default $TMPDIR/fullrun.pid) is TERMed with every
process under it (its data-parallel ranks), the supervisor held stopped
until the bench exits; a quality A/B arm (morpheus_tpu_torch/scripts/
run_ab.sh publishes its pid in $MORPHEUS_AB_PIDFILE, default
$TMPDIR/ab_run.pid) is stopped with its ranks and continued at exit.
MORPHEUS_BENCH_NO_PAUSE=1 turns both off.

Every function takes the config, the scene size, the device and the step
counts, so the tests run the bench tiny on the CPU; main() runs it at the
widths above on the card.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

import torch

BASELINE_RAYS_PER_SEC = 30000.0
# per card name (torch.cuda.get_device_name): the dense bf16 tensor-core
# peak in FLOP/s and the HBM rate in bytes/s, from NVIDIA's data sheet
CARDS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12,
                                   "hbm_bytes_per_s": 3.35e12}}

# the bench operating point (bench.py:73-87); the profilers take it as
# their base so that their split is measured where the headline is
BENCH_POINT_CFG = {
    "data": {"data_dir": "<synthetic>"},
    "exp": {"seed": 0, "save_guidance": False},
    "train": {"real_ray_num": 2048, "real_freq": 1, "n_iters": 1},
    "model": {"bg_radius": 0.0},
    "render": {"step_size": 0.01},
    "tpu": {"max_samples_per_ray": 64, "march_steps": 288,
            "occ_resolution": 128, "occ_warmup_steps": 256,
            "occ_update_every": 16, "occ_sample_fraction": 0.0625,
            "grad_payload": "bfloat16",
            # accepted and ignored by the port (config.py)
            "donate_state": False,
            "sample_budget": 16, "band_budget": 4, "smooth_budget": 4},
}
BENCH_EPOCH = 300               # 10 of 16 levels; global step epoch * 110
LATE_EPOCH = 1900               # all 16 levels
STEPS_PER_EPOCH = 110           # (virtual_freq 1 + real_freq 10) * 10
SDS_STEP = 33001

_T0 = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def _phase(name: str) -> None:
    print(f"bench: [{time.perf_counter() - _T0:7.1f}s] {name}",
          file=sys.stderr, flush=True)


def deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict):
            dst[k] = deep_update(dict(dst.get(k, {})), v)
        else:
            dst[k] = v
    return dst


def bench_config(overrides: dict | None = None,
                 base: dict | None = None) -> dict:
    """`base` (BENCH_POINT_CFG) with `overrides` merged in, over the
    config defaults."""
    from .config import merge_defaults
    return merge_defaults(deep_update(copy.deepcopy(
        BENCH_POINT_CFG if base is None else base), overrides or {}))


def make_dataset(cfg: dict, frames: int = 8, hw: int = 128):
    from .data.dataset import DeformDataset
    from .data.synthetic import make_synthetic_scene
    return DeformDataset(cfg, scene=make_synthetic_scene(num_frames=frames,
                                                         H=hw, W=hw))


def set_point(trainer, epoch: int, step: int) -> None:
    """Put the trainer at `epoch` and global (and host) step `step`, with
    the step's field at that epoch's levels."""
    trainer.epoch = epoch
    trainer.global_step = trainer.host_step = step
    trainer._set_levels(trainer._active_levels())


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[torch.device(device).index or 0]


def card_peak(device) -> dict | None:
    """CARDS' entry for the card of `device` (None on the CPU or an unknown
    card)."""
    if torch.device(device).type != "cuda":
        return None
    return CARDS.get(torch.cuda.get_device_name(device))


def time_ms(fn, device, reps: int = 20) -> float:
    """Mean ms of one fn() call over `reps` calls enqueued back to back,
    after one untimed call: CUDA events on the card, the host clock on the
    CPU."""
    fn()
    if torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def count_flops(fn) -> float:
    """FLOPs of fn() that FlopCounterMode counts: matrix products and
    convolutions, forward and backward; custom kernels count 0."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def real_step_flops(trainer) -> float:
    """One real step's forward and backward (the real loss on a fresh batch
    and its gradient, the normals' double backward in it), without the
    optimizer; the draws advance, the parameters stay."""
    epoch = trainer.epoch

    def fwd_bwd():
        loss, _ = trainer._real_loss(trainer.occ, trainer.draws, epoch,
                                     trainer.curr.max_level(epoch))
        trainer._grads(loss)
    return count_flops(fwd_bwd)


def run_steps(trainer, n: int, sync_each: bool = False,
              chained: bool = False):
    """(seconds, last loss) of n real steps at trainer.epoch, enqueued back
    to back with one synchronize at the end, or each ending in one
    (sync_each); eager steps (real_step), or with `chained` the epoch
    loop's chained steps (chained_real_step)."""
    dev = trainer.device
    step = trainer.chained_real_step if chained else trainer.real_step
    loss = torch.tensor(float("nan"))
    t0 = time.perf_counter()
    for _ in range(n):
        loss = step(trainer.epoch)
        if sync_each:
            sync(dev)
    sync(dev)
    return time.perf_counter() - t0, float(loss)


def time_steps(trainer, n: int, warmup: int = 0):
    """(seconds a real step, seconds of the warm-up, last loss): `warmup`
    steps, then n timed back to back (run_steps)."""
    warm_s, _ = run_steps(trainer, warmup)
    secs, loss = run_steps(trainer, n)
    return secs / n, warm_s, loss


def epoch_loop_step_s(trainer, epoch: int, step: int, real_freq: int = 10,
                      n_iters: int = 10) -> float:
    """Seconds a step of two train_one_epoch() calls at real_freq and
    n_iters, after one that settles, from `epoch` and `step`."""
    tr = trainer.config["train"]
    tr["real_freq"], tr["n_iters"] = real_freq, n_iters
    set_point(trainer, epoch, step)
    trainer.train_one_epoch()
    sync(trainer.device)
    steps = (tr["virtual_freq"] + real_freq) * n_iters
    t0 = time.perf_counter()
    trainer.train_one_epoch()
    trainer.train_one_epoch()
    sync(trainer.device)
    return (time.perf_counter() - t0) / (2 * steps)


def sds_step(cfg: dict, ds, spec, scale: float, epoch: int, device,
             warmup: int = 3, n: int = 8) -> dict:
    """One SDS variant: a Trainer with a random-weight Zero123 of `spec`
    (init_random casts the UNet to spec.compute_dtype: cast_for_compute),
    at `epoch` and step SDS_STEP; `warmup` virtual steps on a view of
    scale `scale`, then n timed, one synchronize at the end. The trainer
    moves the CLIP tower to the host after its embeddings; the trainer and
    the guidance are freed before this returns. {"ms", "warm_s", "loss",
    "rays"}."""
    from .guidance.zero123 import Zero123Guidance
    from .train.trainer import Trainer
    trainer = Trainer(cfg, ds, device=device,
                      guidance=Zero123Guidance.init_random(spec, device,
                                                           seed=1))
    try:
        set_point(trainer, epoch, SDS_STEP)
        sampler = trainer.virtual_sampler(scale)
        t0 = time.perf_counter()
        for _ in range(warmup):
            loss, _ = trainer.virtual_step(epoch, sampler)
        sync(device)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            loss, _ = trainer.virtual_step(epoch, sampler)
        sync(device)
        out = {"ms": (time.perf_counter() - t0) * 1e3 / n, "warm_s": warm_s,
               "loss": float(loss), "rays": sampler.H * sampler.W}
    finally:
        del trainer
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if not math.isfinite(out["loss"]):
        raise AssertionError(f"SDS step at scale {scale}, epoch {epoch}: "
                             f"loss {out['loss']}")
    return out


def run_bench(cfg: dict, device, frames: int = 8, hw: int = 128,
              warmup: int = 6, n_chain: int = 40, n_isolated: int = 32,
              n_late: int = 16, loop_real_freq: int = 10,
              loop_iters: int = 10, sds_mode: str = "1",
              sds_hw: int = 360, sds_spec=None,
              sds_warmup: int = 3, sds_n: int = 8,
              budget_s: float = 5400.0, emit=log) -> dict:
    """The bench at `cfg` on `device`: emits the headline JSON line, then
    the SDS variants (sds_mode "0", "1" or "all"), then the superset line;
    returns the superset."""
    from . import kernels
    from .guidance.zero123 import Zero123Spec
    from .train.trainer import Trainer
    device = torch.device(device)
    kernel_build_s = 0.0
    if device.type == "cuda":
        t0 = time.perf_counter()
        kernels.build_all()
        kernel_build_s = time.perf_counter() - t0
    rays = cfg["train"]["real_ray_num"]
    trainer = Trainer(cfg, make_dataset(cfg, frames, hw), device=device)
    set_point(trainer, BENCH_EPOCH, BENCH_EPOCH * STEPS_PER_EPOCH)
    _phase(f"real step at epoch {BENCH_EPOCH}: {warmup} warm-up steps")
    compile_s, _ = run_steps(trainer, warmup)
    secs, loss = run_steps(trainer, n_isolated, sync_each=True)
    dt_iso = secs / n_isolated
    _phase("chained real steps: capture, then timed replays")
    run_steps(trainer, 2, chained=True)
    dt = run_steps(trainer, n_chain, chained=True)[0] / n_chain
    _phase("flops of one step")
    flops = real_step_flops(trainer)

    _phase(f"late step at epoch {LATE_EPOCH}")
    set_point(trainer, LATE_EPOCH, LATE_EPOCH * STEPS_PER_EPOCH)
    dt_late, _, _ = time_steps(trainer, n_late, warmup)
    _phase("epoch-loop rate")
    dt_loop = epoch_loop_step_s(trainer, BENCH_EPOCH,
                                BENCH_EPOCH * STEPS_PER_EPOCH,
                                loop_real_freq, loop_iters)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    out = {
        "metric": "rays_per_sec_per_chip",
        "value": rays / dt,
        "unit": "rays/s",
        "vs_baseline": rays / dt / BASELINE_RAYS_PER_SEC,
        "steps_per_sec": 1.0 / dt,
        "rays_per_sec_isolated": rays / dt_iso,
        "rays_per_sec_late": rays / dt_late,
        "rays_per_sec_epoch_loop": rays / dt_loop,
        "compile_s": compile_s,
        "kernel_build_s": kernel_build_s,
        "device": card_line(device),
        "loss": loss,
        "step_gflops": flops / 1e9,
    }
    peak = card_peak(device)
    if peak is not None:
        out["mfu_vs_bf16_peak"] = flops / dt / peak["bf16_flops"]
    else:
        out["notes"] = {"mfu_vs_bf16_peak": (
            f"no bf16 peak for {out['device']!r} in bench.CARDS")}
    emit(json.dumps(out))

    sds_ms, sds_skipped = {}, {}
    spec = Zero123Spec() if sds_spec is None else sds_spec
    bf16 = dataclasses.replace(spec, compute_dtype="bfloat16")
    variants = [("sds_step_ms_s05", spec, 0.5, BENCH_EPOCH),
                ("sds_step_ms_s02", spec, 0.2, BENCH_EPOCH),
                ("sds_step_ms_bf16_s05_late", bf16, 0.5, LATE_EPOCH)]
    if sds_mode == "all":
        variants += [("sds_step_ms_bf16_s05", bf16, 0.5, BENCH_EPOCH),
                     ("sds_step_ms_bf16_s02", bf16, 0.2, BENCH_EPOCH)]
    ds_v = None
    for label, gspec, scale, ep in variants:
        if sds_mode == "0":
            sds_skipped[label] = "BENCH_SDS=0"
            continue
        if time.perf_counter() - _T0 > budget_s:
            _phase(f"SKIP {label} (over {budget_s:.0f}s budget)")
            sds_skipped[label] = f"over {budget_s:.0f}s budget"
            continue
        if ds_v is None:
            ds_v = make_dataset(cfg, frames, sds_hw)
        _phase(f"SDS virtual step ({label})")
        sds_ms[label] = sds_step(cfg, ds_v, gspec, scale, ep, device,
                                 sds_warmup, sds_n)["ms"]
    out.update(sds_ms)
    if sds_skipped:
        out["sds_skipped"] = sds_skipped
    emit(json.dumps(out))
    return out


# ---- card ownership ---------------------------------------------------------

def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def _children(pid: int) -> set:
    import glob
    kids = set()
    for path in glob.glob(f"/proc/{pid}/task/*/children"):
        try:
            with open(path) as f:
                kids.update(int(p) for p in f.read().split())
        except (OSError, ValueError):
            pass
    return kids


def _descendants(pid: int) -> list:
    """Every process under `pid` (children, their children, ...)."""
    out, todo = [], [pid]
    while todo:
        for kid in sorted(_children(todo.pop())):
            if kid not in out:
                out.append(kid)
                todo.append(kid)
    return out


def _pidfile(env: str, name: str) -> str:
    return os.environ.get(env) or os.path.join(tempfile.gettempdir(), name)


def _guard_s() -> int:
    """Seconds after which a detached guard continues a paused process even
    if this one died: 1.5x the SDS budget plus 30 min (at least 2 h), as
    bench.py; MORPHEUS_PAUSE_GUARD_S overrides."""
    try:
        budget = float(os.environ.get("BENCH_BUDGET_S", "5400"))
    except ValueError:
        budget = 5400.0
    return int(os.environ.get("MORPHEUS_PAUSE_GUARD_S",
                              str(int(max(7200, 1.5 * budget + 1800)))))


def _signal(pids, sig) -> list:
    """Send `sig` to each of `pids`; returns the pids it reached (a process
    that has exited is skipped)."""
    reached = []
    for pid in pids:
        try:
            os.kill(pid, sig)
            reached.append(pid)
        except OSError:
            pass
    return reached


def _pause_full_run(pidfile: str | None = None):
    """Free the card of a full-budget run (morpheus_tpu_torch/scripts/
    run_full_budget.sh): SIGSTOP the supervisor (its relaunch loop and
    watchdog freeze), SIGTERM its `morpheus_tpu_torch` trainer and every
    process under it (the data-parallel ranks that torch.multiprocessing
    spawns do not name the package), SIGKILL what is still alive after 60
    s, and SIGCONT the supervisor at exit, which then resumes the run from
    its last checkpoint. A detached guard continues the supervisor after
    _guard_s() even if this process is killed. Returns the resume function,
    or None when no supervisor is live, also when it exits between the
    check of its pid and the stop (the guard is then killed)."""
    import atexit
    try:
        with open(pidfile or _pidfile("MORPHEUS_FULLRUN_PIDFILE",
                                      "fullrun.pid")) as f:
            sup = int(f.read().strip())
    except (OSError, ValueError):
        return None
    # pid reuse: only ever signal a process that is the supervisor
    if "run_full_budget" not in _cmdline(sup):
        return None
    guard = subprocess.Popen(
        ["bash", "-c", f"sleep {_guard_s()}; kill -CONT {sup} 2>/dev/null"],
        start_new_session=True)

    def _resume():
        _signal([sup], signal.SIGCONT)
        if guard.poll() is None:
            guard.kill()

    atexit.register(_resume)      # before the stop: a crash still resumes
    _phase(f"pausing full-budget supervisor (pid {sup}) to free the card")
    if not _signal([sup], signal.SIGSTOP):
        # it exited since the pid check: nothing to pause or resume
        atexit.unregister(_resume)
        guard.kill()
        guard.wait()
        _phase(f"supervisor pid {sup} exited before the stop")
        return None
    trainers = [p for p in sorted(_children(sup))
                if "morpheus_tpu_torch" in _cmdline(p)]
    victims = {}
    for pid in trainers:
        for p in [pid, *_descendants(pid)]:
            victims[p] = _cmdline(p)
    _signal(victims, signal.SIGTERM)

    def alive():
        # an exited process that nobody reaped reads back an empty cmdline
        return [p for p, cmd in victims.items() if cmd and _cmdline(p) == cmd]
    deadline = time.monotonic() + 60
    while alive() and time.monotonic() < deadline:
        time.sleep(0.5)
    _signal(alive(), signal.SIGKILL)
    if victims:
        _phase(f"trainer pid(s) {sorted(victims)} stopped")
    return _resume


def _pause_ab_run(pidfile: str | None = None):
    """SIGSTOP a live quality-A/B arm (morpheus_tpu_torch/scripts/run_ab.sh
    publishes its trainer's pid) and every process under it for the
    bench, SIGCONT at exit. It is stopped, not killed: a recon-only
    trainer holds little card memory, and a stop keeps its progress
    exactly. Returns the resume function, or None when no arm is live."""
    import atexit
    try:
        with open(pidfile or _pidfile("MORPHEUS_AB_PIDFILE",
                                      "ab_run.pid")) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    if "morpheus_tpu_torch" not in _cmdline(pid):     # pid reuse
        return None
    pids = [pid, *_descendants(pid)]

    def _resume():
        _signal(pids, signal.SIGCONT)

    atexit.register(_resume)
    _phase(f"pausing A/B trainer (pids {pids}) for the bench")
    _signal(pids, signal.SIGSTOP)
    # continue them even if this process is killed mid-bench
    subprocess.Popen(
        ["bash", "-c", f"sleep {_guard_s()}; kill -CONT "
         f"{' '.join(map(str, pids))} 2>/dev/null"],
        start_new_session=True)
    return _resume


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    args = parser.parse_args(argv)
    if os.environ.get("MORPHEUS_BENCH_NO_PAUSE", "0") != "1":
        _pause_full_run()
        _pause_ab_run()
    from .utils import resolve_device
    device = resolve_device(args.device)
    try:
        budget_s = float(os.environ.get("BENCH_BUDGET_S", "5400"))
    except ValueError:
        print("bench: malformed BENCH_BUDGET_S, using 5400", file=sys.stderr)
        budget_s = 5400.0
    run_bench(bench_config(), device,
              sds_mode=os.environ.get("BENCH_SDS", "1"), budget_s=budget_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
