"""Crash-proof 3-D metric evaluation: detached eval worker + resume backfill
(the port's copy of morpheus_tpu/eval/backfill.py; host code).

The reference hides its per-epoch mesh evaluation in daemon-less background
threads of the training process (reference morpheus.py:1513-1518); a crash or
SIGTERM mid-eval silently loses that epoch's `metric_3d.txt` row forever.
Observed live on the round-4 full-budget run: the supervisor's stall-watchdog
SIGTERM killed the trainer mid-eval twice, and 2 of 3 scheduled 3-D metric
blocks produced nothing (VERDICT r4 weak #2).

Two mechanisms fix this:

1. ``run_eval_detached`` — the per-epoch eval (cull -> ICP -> Acc/Comp via
   eval_mesh, plus depth-L1) runs in its OWN session
   (``start_new_session=True``), so killing the trainer no longer kills the
   eval. The worker reconstructs the dataset from the workspace's dumped
   ``config.yaml`` and reads meshes/depths from disk — it shares nothing
   live with the trainer.
2. ``backfill_missing`` — on (re)start, every mesh_all eval epoch at or below
   the resumed epoch whose ``metric_3d.txt`` row is absent but whose
   per-frame meshes still exist on disk is queued for re-evaluation in one
   sequential detached worker (the host has a single vCPU; parallel workers
   would only contend with the trainer's dispatch thread).

A per-epoch inflight pidfile (``.eval_inflight_{epoch}``) prevents a
crash-resume from double-launching an eval that is already running.

The worker and its metric subprocesses run with ``CUDA_VISIBLE_DEVICES=""``:
the eval is numpy and scipy on the host and never touches the card.
"""
from __future__ import annotations

import os
import subprocess
import sys


def _metric_rows(workspace: str) -> set[int]:
    """Epochs that already have an Ep_{e} row in metric_3d.txt."""
    rows: set[int] = set()
    path = os.path.join(workspace, "metric_3d.txt")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.startswith("Ep_"):
                    try:
                        rows.add(int(line.split(":")[0][3:]))
                    except ValueError:
                        pass
    return rows


def _meshes_exist(workspace: str, epoch: int, num_frames: int) -> bool:
    mesh_all = os.path.join(workspace, "mesh_all")
    return all(os.path.exists(os.path.join(
        mesh_all, f"mesh_{epoch:04d}_{i:04d}.ply")) for i in range(num_frames))


def _inflight_path(workspace: str, epoch: int) -> str:
    return os.path.join(workspace, f".eval_inflight_{epoch:04d}")


def _reap(pid: int) -> bool:
    """True when `pid` is a child of this process that has exited; it is
    reaped here, so a dead worker is no zombie that os.kill(pid, 0) would
    report alive. False for a live child and for any other process."""
    try:
        done, _ = os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:     # not this process's child, or reaped
        return False
    return bool(done)


def _inflight_alive(workspace: str, epoch: int) -> bool:
    """Whether the worker named in the epoch's inflight pidfile still runs.
    A worker that exited - a zombie child of this process included, which
    os.kill(pid, 0) would report alive - counts as dead, and its stale
    pidfile is removed."""
    path = _inflight_path(workspace, epoch)
    try:
        with open(path) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return False
    dead = _reap(pid)
    if not dead:
        try:
            os.kill(pid, 0)
        except OSError:
            dead = True
    if dead:
        try:
            os.remove(path)
        except OSError:
            pass
        return False
    return True


def missing_eval_epochs(workspace: str, num_frames: int, eval_interval: int,
                        upto: int, max_epochs: int | None = None) -> list[int]:
    """Eval epochs <= upto with no metric row, recoverable meshes on disk,
    and no live worker already evaluating them. The eval epochs are the
    multiples of eval_interval and the run's final epoch, max_epochs, which
    the trainer evaluates whether or not it is a multiple."""
    if eval_interval <= 0:
        return []
    done = _metric_rows(workspace)
    cands = set(range(eval_interval, upto + 1, eval_interval))
    if max_epochs is not None and 0 < max_epochs <= upto:
        cands.add(max_epochs)
    out = []
    for e in sorted(cands):
        if e in done or _inflight_alive(workspace, e):
            continue
        if _meshes_exist(workspace, e, num_frames):
            out.append(e)
    return out


def run_eval_detached(workspace: str, epochs: list[int], log=None):
    """Spawn one detached worker evaluating `epochs` sequentially.

    Survives trainer SIGTERM/SIGKILL (own session). Returns the Popen (the
    caller may wait on it for a clean final-epoch exit) or None when every
    epoch is already inflight.
    """
    epochs = [e for e in epochs if not _inflight_alive(workspace, e)]
    if not epochs:
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # never let the eval worker (or its metric subprocesses) touch the card
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logf = open(os.path.join(workspace, "eval_worker.log"), "a")
    # the worker waits for one line on its stdin before it starts, so the
    # pidfiles exist before it can finish (and remove them)
    proc = subprocess.Popen(
        [sys.executable, "-m", "morpheus_tpu_torch.eval.backfill", workspace]
        + [str(e) for e in epochs],
        env=env, cwd=root, stdin=subprocess.PIPE, stdout=logf,
        stderr=subprocess.STDOUT, start_new_session=True)
    logf.close()
    try:
        for e in epochs:
            with open(_inflight_path(workspace, e), "w") as f:
                f.write(str(proc.pid))
    finally:
        proc.stdin.write(b"go\n")
        proc.stdin.close()
    if log:
        log(f"[eval] detached worker pid={proc.pid} for epochs {epochs}")
    return proc


def backfill_missing(workspace: str, num_frames: int, eval_interval: int,
                     upto: int, max_epochs: int | None = None, log=None):
    """Resume-time repair: re-run every recoverable missing eval block."""
    epochs = missing_eval_epochs(workspace, num_frames, eval_interval, upto,
                                 max_epochs)
    if epochs and log:
        log(f"[eval] backfilling missing metric_3d rows for epochs {epochs}")
    if epochs:
        return run_eval_detached(workspace, epochs, log=log)
    return None


def wait_for_evals(workspace: str, timeout_s: float = 5400.0,
                   poll_s: float = 1.0) -> bool:
    """Block until no eval worker is inflight (clean final-epoch exit path).
    Returns True when drained, False on timeout."""
    import glob
    import time
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        live = [p for p in glob.glob(os.path.join(workspace,
                                                  ".eval_inflight_*"))
                if _inflight_alive(workspace, int(p.rsplit("_", 1)[1]))]
        if not live:
            return True
        time.sleep(poll_s)
    return False


def _build_dataset(workspace: str):
    """Reconstruct the dataset exactly as the trainer CLI does
    (morpheus_tpu_torch/__main__.py main), from the workspace's resolved
    config dump."""
    import yaml

    from ..data.dataset import DeformDataset, synthetic_scene
    with open(os.path.join(workspace, "config.yaml")) as f:
        config = yaml.safe_load(f)
    scene = (synthetic_scene(config)
             if config["data"]["data_dir"] == "<synthetic>" else None)
    dataset = DeformDataset(config, scene=scene)
    if scene is not None:
        from .backproj import write_backproj_meshes
        dataset.data_dir = write_backproj_meshes(
            scene, os.path.join(workspace, "gt_synth"))
    return dataset


def _remove_inflight(workspace: str, epoch: int) -> None:
    try:
        os.remove(_inflight_path(workspace, epoch))
    except OSError:
        pass


def _worker_main(argv=None):
    """``python -m morpheus_tpu_torch.eval.backfill <workspace> <epoch>...``
    Prints the seconds each epoch took ('[eval worker] epoch E: done in S
    s')."""
    import time
    argv = argv if argv is not None else sys.argv[1:]
    workspace, epochs = argv[0], [int(e) for e in argv[1:]]
    sys.stdin.readline()         # run_eval_detached has written the pidfiles
    try:
        from .culling import eval_depthL1, eval_mesh
        t0 = time.perf_counter()
        dataset = _build_dataset(workspace)
        print(f"[eval worker] dataset in {time.perf_counter() - t0:.3f} s",
              flush=True)
        mesh_all_dir = os.path.join(workspace, "mesh_all")
        for epoch in epochs:
            t0 = time.perf_counter()
            try:
                print(f"[eval worker] epoch {epoch}: eval_mesh", flush=True)
                eval_mesh(workspace, mesh_all_dir, dataset,
                          f"mesh_{epoch:04d}", epoch)
                depth_dir = os.path.join(workspace, "depths",
                                         f"depths_{epoch:04d}")
                if os.path.exists(os.path.join(depth_dir, "depths.npz")):
                    print(f"[eval worker] epoch {epoch}: eval_depthL1",
                          flush=True)
                    eval_depthL1(depth_dir, dataset, epoch=epoch)
                print(f"[eval worker] epoch {epoch}: done in "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
            except Exception as e:  # one bad epoch must not lose the others
                print(f"[eval worker] epoch {epoch} FAILED: {e!r}",
                      flush=True)
            finally:
                _remove_inflight(workspace, epoch)
    finally:
        # any exit - the dataset failing to build included - leaves no
        # inflight file of this worker's epochs behind
        for epoch in epochs:
            _remove_inflight(workspace, epoch)
    print("[eval worker] done", flush=True)


if __name__ == "__main__":
    _worker_main()
