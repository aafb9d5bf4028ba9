"""Trainer CLI of the port, with the interface of the JAX package's
morpheus.py (reference: morpheus.py:1522-1554):

    python -m morpheus_tpu_torch --config configs/snoopy.yaml \\
        [--device cuda|cpu] [section --key value ...]

Orchestrates per-scene optimisation, with Zero123 SDS guidance when the
config asks for it (build_guidance), and periodic diagnostics, as
morpheus.py:82-330 does: init mesh, test videos every test_interval,
canonical mesh every mesh_interval, per-frame meshes, mesh videos and the
detached 3-D metric worker every mesh_all_interval, checkpoints, resume
from the newest checkpoint, and the CLIP score of the 360-degree test video
when exp.clip_ckpt names an existing file (morpheus.py:179-184,292-293).
Training, mesh queries, video renders and the CLIP encoder run on
`--device` (the card unless told otherwise); iso-surface extraction, mesh
videos and the metric worker are host code.

Besides the reference's log, every epoch logs one `epoch-stats {json}` line
(the loss and the seconds of each part of the epoch), every mesh export one
`mesh-export {json}` line, and the run ends with `kernel-launches {json}`,
the launches of each hand-written kernel in this process.

With `tpu --data_parallel N` (or tpu.data_parallel in the YAML) the CLI
starts N ranks itself (parallel/sharding.py: NCCL, one card a rank; gloo
under `--device cpu`), which train one scene together; rank 0 alone logs,
writes the checkpoints, exports the meshes, renders the videos, scores
CLIP and starts the eval worker, while the other ranks step and wait.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time

import torch

# mesh resolutions: the canonical meshes, and the per-frame meshes of
# mesh_all, finer at the final epoch (morpheus.py:202,298,305)
MESH_RES = 128
MESH_ALL_RES = 128
MESH_ALL_FINAL_RES = 256


def _apply_degrade(config, level: int) -> list[str]:
    """Degraded-mode overrides for the crash-resume supervisor
    (scripts/run_full_budget.sh sets MORPHEUS_DEGRADE after N consecutive
    no-progress failures). Each level trades throughput — and at level 2,
    virtual-view resolution — for device-memory headroom; every override is
    returned for the log so a degraded run is never mistaken for a clean
    one."""
    notes = []
    if level >= 1:
        config["tpu"]["chain_steps"] = False
        notes.append("tpu.chain_steps=false (single-step dispatch)")
        if config["guidance"].get("compute_dtype") != "bfloat16":
            config["guidance"]["compute_dtype"] = "bfloat16"
            notes.append("guidance.compute_dtype=bfloat16")
    if level >= 2:
        s = min(0.35, float(config["data"].get("novel_view_scale_final", 0.5)))
        config["data"]["novel_view_scale_final"] = s
        notes.append(f"data.novel_view_scale_final={s} "
                     "(SEMANTICS CHANGE: smaller late virtual views)")
    return notes


def _mem_note(device: torch.device) -> str:
    """Device-memory snapshot for the epoch log line (nothing on the
    CPU)."""
    if device.type != "cuda":
        return ""
    gib = 1 << 30
    total = torch.cuda.get_device_properties(device).total_memory
    return (f" mem={torch.cuda.memory_allocated(device) / gib:.2f}"
            f"/{total / gib:.2f}GiB"
            f" peak={torch.cuda.max_memory_allocated(device) / gib:.2f}")


def _check_zero123_ckpt(config, log) -> None:
    """A Zero123 checkpoint path that does not exist trains recon-only with
    the reference's warning (morpheus.py:159-161)."""
    gd = config["guidance"]
    ckpt = gd.get("zero123_ckpt")
    if gd["model"] and ckpt and ckpt not in ("<random>", "<random-tiny>") \
            and not os.path.exists(ckpt):
        log(f"[warn] zero123 ckpt not found at {ckpt}; "
            "training recon-only (no SDS)")


def load_clip_encoder(config, device, log):
    """The CLIP eval encoder of exp.clip_ckpt on `device`, when that file
    exists (morpheus.py:179-184); else None, and no CLIP score."""
    clip_ckpt = config["exp"].get("clip_ckpt", "")
    if not (clip_ckpt and os.path.exists(clip_ckpt)):
        return None
    from .eval.clip_eval import ImageEncoder
    encoder = ImageEncoder.from_clip_checkpoint(clip_ckpt, device)
    log(f"Loaded CLIP eval encoder from {clip_ckpt}")
    return encoder


def build_guidance(config, device, log):
    """The Zero123 guidance a configuration asks for, on `device`, as
    morpheus.py:123-165 builds it: zero123_ckpt "<random>" is a full-size
    random-weight Zero123 (the whole SDS path at its real cost, with no
    checkpoint at hand), "<random-tiny>" a small one with every layer type
    (for driving the SDS path on the CPU), an existing path a real
    checkpoint (its architecture from guidance.zero123_config when that
    file exists); guidance.compute_dtype applies in each case. A path that
    does not exist (_check_zero123_ckpt warns of it), no guidance.model or no
    zero123_ckpt means no guidance (None)."""
    import dataclasses

    from .guidance.checkpoint import load_zero123_checkpoint
    from .guidance.zero123 import TINY_SPEC, Zero123Guidance, Zero123Spec
    gd = config["guidance"]
    ckpt = gd.get("zero123_ckpt")
    if not (gd["model"] and ckpt):
        return None
    dtype = gd.get("compute_dtype", "float32")
    if ckpt in ("<random>", "<random-tiny>"):
        spec = TINY_SPEC if ckpt == "<random-tiny>" else Zero123Spec()
        g = Zero123Guidance.init_random(
            dataclasses.replace(spec, compute_dtype=dtype), device)
        log(f"Initialized RANDOM-weight Zero123 guidance ({ckpt})")
        return g
    if os.path.exists(ckpt):
        zcfg = gd.get("zero123_config", "")
        spec = (Zero123Spec.from_ldm_config(zcfg)
                if zcfg and os.path.exists(zcfg) else Zero123Spec())
        g = load_zero123_checkpoint(
            ckpt, dataclasses.replace(spec, compute_dtype=dtype), device)
        log(f"Loaded Zero123 guidance from {ckpt}")
        return g
    return None


def kernel_launches() -> dict:
    """The launches of each hand-written kernel in this process."""
    from .ops import gather, hist, rows, segsum
    return {"level_histogram": hist.level_histogram.launches,
            "level_gather": gather.level_gather.launches,
            "segment_sum_sorted": segsum.segment_sum_sorted.launches,
            "row_gather": rows.row_gather.launches}


def main(argv=None):
    from .config import parse_cli
    from .utils import resolve_device

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="where training and rendering run (cuda or cpu)")
    args, rest = pre.parse_known_args(argv)
    config = parse_cli(rest)
    device = resolve_device(args.device)
    world = int(config["tpu"].get("data_parallel", 1))
    if world > 1:
        import importlib

        from .parallel import sharding
        sharding.check_rays(config, world)
        # the ranks find _rank_main by the package's module name: spawn does
        # not run a package's __main__ again in a child; they export at this
        # process's mesh resolutions
        cli = importlib.import_module("morpheus_tpu_torch.__main__")
        sharding.launch(cli._rank_main, world, device, args=(
            config, (MESH_RES, MESH_ALL_RES, MESH_ALL_FINAL_RES)))
        return
    _main(config, device)


def _rank_main(red, device, config, mesh_res):
    """One rank of a data-parallel CLI run (sharding.launch)."""
    global MESH_RES, MESH_ALL_RES, MESH_ALL_FINAL_RES
    MESH_RES, MESH_ALL_RES, MESH_ALL_FINAL_RES = mesh_res
    _main(config, device, red)


def _main(config, device, red=None):
    from .parallel.sharding import LOCAL
    from .utils import Logger

    red = red or LOCAL
    workspace = os.path.join(config["exp"]["output"], config["exp"]["exp_name"])
    if red.rank != 0:
        _run(config, device, workspace, lambda *args: None, red)
        return
    os.makedirs(workspace, exist_ok=True)
    log = Logger(workspace, config["exp"]["log"])
    try:
        _run(config, device, workspace, log, red)
    finally:
        log.close()


def _run(config, device, workspace, log, red):
    from . import mesh_export
    from .config import dump_config
    from .data.dataset import DeformDataset, synthetic_scene
    from .eval.backfill import backfill_missing, wait_for_evals
    from .train.trainer import Trainer
    from .utils import file_backup, seed_everything

    rank0 = red.rank == 0
    degrade = int(os.environ.get("MORPHEUS_DEGRADE", "0") or 0)
    if degrade:
        for note in _apply_degrade(config, degrade):
            log(f"[degrade L{degrade}] {note}")
    if rank0:
        dump_config(config, workspace)
        file_backup(workspace)
    seed_everything(config["exp"]["seed"])
    _check_zero123_ckpt(config, log)

    scene = (synthetic_scene(config)
             if config["data"]["data_dir"] == "<synthetic>" else None)
    dataset = DeformDataset(config, scene=scene)
    log(f"Loaded {dataset.num_frames} frames at {dataset.H}x{dataset.W}")
    if scene is not None and rank0:
        # GT backprojection meshes, so the 3-D metric pipeline (Acc/Comp,
        # tools/culling.py:262-268 protocol) runs on the synthetic scene as
        # it would on a KillingFusion scan
        from .eval.backproj import write_backproj_meshes
        dataset.data_dir = write_backproj_meshes(
            scene, os.path.join(workspace, "gt_synth"))

    guidance = build_guidance(config, device, log)
    trainer = Trainer(config, dataset, device=device, guidance=guidance,
                      workspace=workspace, reducer=red)
    del guidance           # the trainer holds it (its CLIP tower on the host)
    clip_encoder = load_clip_encoder(config, device, log) if rank0 else None

    # resume from the newest workspace checkpoint unless told otherwise
    # (preemption recovery; the reference only writes a final ckpt)
    ckpt_mode = config["exp"].get("ckpt", "latest")
    if ckpt_mode and ckpt_mode != "scratch":
        if ckpt_mode == "latest":
            cands = sorted(glob.glob(os.path.join(workspace, "models",
                                                  "model_ep_*.pkl")))
            ckpt_path = cands[-1] if cands else None
        else:
            ckpt_path = ckpt_mode
        if ckpt_path and os.path.exists(ckpt_path):
            trainer.load_ckpt(ckpt_path)
            log(f"Resumed from {ckpt_path} (epoch {trainer.epoch})")

    mesh_dir = os.path.join(workspace, "mesh")
    max_epochs = config["train"]["n_epochs"]
    exp = config["exp"]
    if not rank0:
        _epoch_loop(trainer, dataset, log, workspace, mesh_dir, clip_encoder,
                    max_epochs, exp)
        return
    info = mesh_export.export_mesh(trainer.field,
                                   os.path.join(mesh_dir, "init.ply"),
                                   resolution=MESH_RES, cano=True)[2]
    log("Exported init mesh")
    log("mesh-export " + json.dumps(info))

    # crash-resume repair: any eval epoch whose metric_3d.txt row was lost
    # to a mid-eval kill is re-evaluated from its on-disk meshes by a
    # detached worker before training continues
    backfill_missing(workspace, dataset.num_frames,
                     exp.get("mesh_all_eval_interval", 0), trainer.epoch,
                     max_epochs=max_epochs, log=log)

    _epoch_loop(trainer, dataset, log, workspace, mesh_dir, clip_encoder,
                max_epochs, exp)
    # evals run in detached sessions and survive a trainer crash; on the
    # clean exit path, wait for them so "Training done." implies the final
    # metric rows are on disk. MORPHEUS_EVAL_DRAIN_S=0 skips the wait.
    drain_s = float(os.environ.get("MORPHEUS_EVAL_DRAIN_S", "5400") or 0)
    t0 = time.perf_counter()
    if drain_s > 0 and not wait_for_evals(workspace, timeout_s=drain_s):
        log("[eval] WARNING: eval workers still running at exit "
            "(detached; rows will land late)")
    log(f"[eval] waited {time.perf_counter() - t0:.3f} s for eval workers")
    log("kernel-launches " + json.dumps(kernel_launches()))
    log("Training done.")


def _prune_dense_ckpts(workspace, ci, mesh_all_interval, max_epochs):
    """Dense interval checkpoints are crash insurance only: drop the older
    ones on the dense cadence. Keepers: mesh_all_interval epochs, anything
    not on the dense cadence (e.g. a previous run's final checkpoint), and
    the TWO newest (numeric epoch, not lexical), so that a poisoned newest
    one rolls back one interval, not to the last mesh_all_interval one."""
    cands = []
    for old in glob.glob(os.path.join(workspace, "models", "model_ep_*.pkl")):
        m = re.match(r"model_ep_(\d+)\.pkl$", os.path.basename(old))
        if m:
            cands.append((int(m.group(1)), old))
    cands.sort()
    for ep, old in cands[:-2]:
        if ep % ci == 0 and ep % mesh_all_interval != 0 and ep != max_epochs:
            os.remove(old)


def _epoch_loop(trainer, dataset, log, workspace, mesh_dir, clip_encoder,
                max_epochs, exp):
    from . import mesh_export
    from .eval.backfill import run_eval_detached
    from .vis import mesh_video
    from .vis import video as video_lib

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t0

    for epoch in range(trainer.epoch + 1, max_epochs + 1):
        trainer.epoch = epoch
        try:
            loss, train_s = timed(trainer.train_one_epoch)
        except torch.cuda.OutOfMemoryError:
            log(f"[oom] out of device memory at epoch {epoch} (global step "
                f"{trainer.global_step})")
            log(torch.cuda.memory_summary(trainer.device))
            raise
        stats = {"epoch": epoch, "loss": loss, "train_s": train_s}
        if epoch % 10 == 0 or epoch == 1:
            log(f"epoch {epoch}/{max_epochs} loss={loss:.4f} "
                f"({train_s:.2f}s){_mem_note(trainer.device)}")

        # periodic checkpoint (every mesh_all_interval epochs) + final;
        # exp.ckpt_interval adds a denser cadence for preemption-prone runs
        ci = exp.get("ckpt_interval", 0)
        mai = exp["mesh_all_interval"]
        if epoch % mai == 0 or epoch == max_epochs or (ci and epoch % ci == 0):
            _, stats["ckpt_s"] = timed(trainer.save_ckpt, os.path.join(
                workspace, "models", f"model_ep_{epoch:04d}.pkl"))
            if ci and epoch % mai != 0 and epoch != max_epochs \
                    and trainer.dp.rank == 0:
                _prune_dense_ckpts(workspace, ci, mai, max_epochs)
        if trainer.dp.rank != 0:
            continue        # rank 0 alone writes the diagnostics

        if epoch % exp["test_interval"] == 0 or epoch == max_epochs:
            results = os.path.join(workspace, "results")
            stats["test_video_s"] = [timed(video_lib.render_test_video,
                                           trainer, results, name, **kw)[1]
                                     for name, kw in (
                ("test", {"phis": 0}), ("test_180", {"phis": 0.5}),
                ("test_cano", {"cano": True}),
                ("test_360", {"view_360": True,
                              "eval_clip": clip_encoder is not None,
                              "clip_encoder": clip_encoder, "log": log}),
                ("test_real", {"real_view": True}))]

        if epoch % exp["mesh_interval"] == 0 or epoch == max_epochs:
            # meshes come from the live parameters, videos from the EMA
            info = mesh_export.export_mesh(
                trainer.field, os.path.join(mesh_dir, f"mesh_{epoch:04d}.ply"),
                resolution=MESH_RES, cano=True)[2]
            log("mesh-export " + json.dumps(info))

        if epoch % mai == 0 or epoch == max_epochs:
            mesh_all_dir = os.path.join(workspace, "mesh_all")
            resolution = (MESH_ALL_RES if epoch != max_epochs
                          else MESH_ALL_FINAL_RES)
            for info in mesh_export.export_all_meshes(
                    trainer.field, mesh_all_dir, dataset.num_frames, epoch,
                    resolution=resolution):
                log("mesh-export " + json.dumps(info))

            images_real = os.path.join(workspace, "images_real",
                                       f"image_{epoch:04d}")
            images_360 = os.path.join(workspace, "images_360",
                                      f"image_{epoch:04d}")
            video_dir = os.path.join(workspace, "videos")
            depth_dir = os.path.join(workspace, "depths",
                                     f"depths_{epoch:04d}")
            stats["mesh_video_s"] = [
                timed(mesh_video.render_all_meshes, trainer, mesh_all_dir,
                      images_real, video_dir, epoch, scale=1,
                      save_depths_dir=depth_dir)[1],
                timed(mesh_video.render_all_meshes, trainer, mesh_all_dir,
                      images_360, video_dir, epoch, view_360=True,
                      video_name="video_360")[1]]

            if epoch % exp["mesh_all_eval_interval"] == 0 \
                    or epoch == max_epochs:
                # detached worker (own session): a supervisor SIGTERM of the
                # trainer cannot lose this epoch's metric_3d row
                run_eval_detached(workspace, [epoch], log=log)
        log("epoch-stats " + json.dumps(stats))


if __name__ == "__main__":
    main()
