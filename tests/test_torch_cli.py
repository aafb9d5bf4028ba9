"""The port's trainer CLI (python -m morpheus_tpu_torch) on the CPU: a tiny
synthetic drive writes the artifacts of morpheus.py (meshes, test videos,
mesh videos, checkpoints, metric_3d.txt rows from the detached eval worker)
and a second call resumes from its newest checkpoint; with exp.clip_ckpt
naming a random ViT-B/32 in the OpenAI layout, each call logs one CLIP score
of its 360-degree test video, and the port's wallclock_report reads the
log. The mesh resolutions
are cut to 16 (canonical and per-frame) and 20 (per-frame at the final
epoch). Also: the eval worker and its metric subprocess run with jax and the
JAX package unimportable, and the final epoch's lost metric row is
backfilled though the epoch is no multiple of the eval interval."""
import dataclasses
import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import morpheus_tpu_torch.__main__ as cli  # noqa: E402
from morpheus_tpu.eval import backfill as jbackfill  # noqa: E402
from morpheus_tpu_torch.eval import backfill  # noqa: E402
from morpheus_tpu_torch.ops import meshing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 2
TINY = {
    "data": {"data_dir": "<synthetic>", "synthetic_frames": FRAMES,
             "synthetic_res": 32},
    "exp": {"exp_name": "vsphere", "test_interval": 2, "mesh_interval": 1,
            "mesh_all_interval": 2, "mesh_all_eval_interval": 3, "seed": 7},
    "render": {"step_size": 0.02},
    "train": {"n_epochs": 1, "n_iters": 1, "real_freq": 2, "warm_up_end": 3,
              "warm_up_steps": 2, "lr": 0.003, "normal_smoothness": 0.0,
              "normal_smooth_3d": 0.0},
    "model": {"bg_radius": 0.0, "grid_num_levels": 4,
              "grid_log2_hashmap_size": 12, "grid_desired_resolution": 48},
    "tpu": {"max_samples_per_ray": 32, "march_steps": 128,
            "occ_resolution": 32, "occ_warmup_steps": 20,
            "occ_update_every": 8},
}


def _config(tmp, **exp):
    cfg = {k: dict(v) for k, v in TINY.items()}
    cfg["exp"].update(output=str(tmp / "exp"), **exp)
    path = tmp / "tiny.yaml"
    path.write_text(yaml.dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """Two CLI calls: 1 epoch, then `train --n_epochs 2`, which resumes.
    Each ends on a final epoch, which writes every artifact and scores the
    360-degree test video with the CLIP eval encoder."""
    from morpheus_tpu_torch.eval.clip_eval import ImageEncoder
    tmp = tmp_path_factory.mktemp("cli")
    # the CLIP eval encoder: a random ViT-B/32 (seeded), OpenAI layout
    cfg = _config(tmp, clip_ckpt=ImageEncoder(device="cpu", seed=1)
                  .save_checkpoint(str(tmp / "clip_b32.pt")))
    logs = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cli, "MESH_RES", 16)
        m.setattr(cli, "MESH_ALL_RES", 16)
        m.setattr(cli, "MESH_ALL_FINAL_RES", 20)
        m.setenv("MORPHEUS_EVAL_DRAIN_S", "600")
        for extra in ([], ["train", "--n_epochs", "2"]):
            ws = str(tmp / "exp" / "vsphere")
            n0 = (os.path.getsize(os.path.join(ws, "log.txt"))
                  if os.path.exists(os.path.join(ws, "log.txt")) else 0)
            cli.main(["--config", cfg, "--device", "cpu"] + extra)
            with open(os.path.join(ws, "log.txt")) as f:
                logs.append(f.read()[n0:])
    return ws, logs


def _artifacts(epochs, frames):
    out = ["mesh/init.ply"] + [f"mesh/mesh_{e:04d}.ply" for e in epochs]
    out += [f"mesh_all/mesh_{e:04d}_{i:04d}.ply" for e in epochs
            for i in range(frames)]
    out += [f"results/{n}_ep{e:04d}_{k}.mp4" for n in (
        "test", "test_180", "test_cano", "test_360", "test_real")
        for k in ("rgb", "depth") for e in epochs]
    out += [f"videos/video_{v}_{e:04d}.mp4" for v in ("real", "360")
            for e in epochs]
    out += [f"models/model_ep_{e:04d}.pkl" for e in epochs]
    return out + ["metric_3d.txt", "config.yaml",
                  "recording/morpheus_tpu_torch/__main__.py"]


def test_cli_writes_the_artifacts(drive):
    ws, _ = drive
    missing = [p for p in _artifacts((1, 2), FRAMES)
               if not os.path.exists(os.path.join(ws, p))]
    assert not missing
    with open(os.path.join(ws, "metric_3d.txt")) as f:
        rows = {line.split(":")[0] for line in f if line.startswith("Ep_")}
    assert rows == {"Ep_1", "Ep_2"}
    for path in glob.glob(os.path.join(ws, "mesh*", "*.ply")):
        v, faces, _ = meshing.load_ply(path)
        assert len(faces) and np.median(np.linalg.norm(v, axis=-1)) < 1.0
    assert not glob.glob(os.path.join(ws, ".eval_inflight_*"))


def test_cli_resumes_from_its_newest_checkpoint(drive):
    ws, (first, second) = drive
    assert "Resumed" not in first
    assert re.search(r"Resumed from \S+model_ep_0001\.pkl \(epoch 1\)", second)
    epochs = [int(e) for e in re.findall(r'epoch-stats \{"epoch": (\d+)',
                                         first + second)]
    assert epochs == [1, 2]
    losses = [float(x) for x in re.findall(r'"loss": ([-0-9.e]+)',
                                           first + second)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    for log in (first, second):
        assert '"backend": "native"' in log
        assert "Training done." in log


def test_cli_logs_one_finite_clip_score_per_run(drive):
    """exp.clip_ckpt names a random ViT-B/32: each run loads it and logs
    one CLIP score, of its final epoch's 360-degree test video, as
    morpheus.py:292-293 does."""
    _, logs = drive
    for log, epoch in zip(logs, (1, 2)):
        assert "Loaded CLIP eval encoder from" in log
        scores = re.findall(r"==> CLIP=(\S+) \((\S+)\)", log)
        assert len(scores) == 1, scores
        assert np.isfinite(float(scores[0][0]))
        assert scores[0][1] == f"test_360_ep{epoch:04d}"


def test_wallclock_report_reads_the_cli_log(drive, capsys):
    """The port's wallclock_report parses the port CLI's log: its epoch
    lines (epoch 1 and every tenth, as morpheus.py logs them), the launch
    and resume markers and the end marker."""
    from morpheus_tpu_torch.scripts import wallclock_report
    ws, _ = drive
    epochs, order = wallclock_report.parse(ws)
    assert list(epochs) == [1] and epochs[1][1] > 0
    kinds = [(k, e) for k, _, e in order]
    assert [k for k, _ in kinds].count("Training done") == 2
    assert ("epoch", 1) in kinds and ("Resumed", 1) in kinds
    assert kinds.index(("epoch", 1)) < kinds.index(("Resumed", 1))
    wallclock_report.main([ws])
    out = capsys.readouterr().out
    assert "epoch 1 reached" in out and "stepping" in out


def test_cli_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--config", _config(tmp_path)])


@pytest.mark.parametrize("ckpt", ["<random>", "<random-tiny>", "exists"])
def test_cli_refuses_zero123_guidance(tmp_path, ckpt):
    """Zero123 guidance is ported: "<random>" builds the full-size random
    Zero123 (on the meta device here, so no memory is spent) and
    "<random-tiny>" the small one, each under guidance.compute_dtype; a
    zero123_ckpt path that exists but does not hold a checkpoint fails with
    the loader's error."""
    from morpheus_tpu_torch.config import merge_defaults
    from morpheus_tpu_torch.guidance.zero123 import TINY_SPEC, Zero123Spec
    cfg = merge_defaults({"guidance": {"zero123_ckpt": ckpt,
                                       "compute_dtype": "bfloat16"}})
    logged = []
    if ckpt == "exists":
        path = tmp_path / "zero123.ckpt"
        path.write_bytes(b"")
        cfg["guidance"]["zero123_ckpt"] = str(path)
        with pytest.raises(ValueError, match="not a readable Zero123"):
            cli.build_guidance(cfg, torch.device("cpu"), logged.append)
        return
    device = torch.device("meta" if ckpt == "<random>" else "cpu")
    g = cli.build_guidance(cfg, device, logged.append)
    base = Zero123Spec() if ckpt == "<random>" else TINY_SPEC
    assert g.spec == dataclasses.replace(base, compute_dtype="bfloat16")
    assert {p.dtype for p in g.unet.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in g.vae.parameters()} == {torch.float32}
    assert {p.device.type for p in g.parameters()} == {device.type}
    assert logged == [f"Initialized RANDOM-weight Zero123 guidance ({ckpt})"]


def test_dead_eval_worker_leaves_no_inflight_file(tmp_path):
    """An eval worker that fails at start-up (its config.yaml does not
    parse) removes its inflight files, and the trainer's wait sees it dead
    at once although its Popen was dropped (a zombie child is not alive)."""
    import time
    ws = str(tmp_path)
    (tmp_path / "config.yaml").write_text("data: [unclosed\n")
    assert backfill.run_eval_detached(ws, [2, 4]) is not None
    t0 = time.perf_counter()
    assert backfill.wait_for_evals(ws, timeout_s=60, poll_s=0.2)
    assert time.perf_counter() - t0 < 30
    deadline = time.time() + 30
    while glob.glob(os.path.join(ws, ".eval_inflight_*")) \
            and time.time() < deadline:
        time.sleep(0.2)
    assert not glob.glob(os.path.join(ws, ".eval_inflight_*"))
    assert "Error" in open(os.path.join(ws, "eval_worker.log")).read()


def test_missing_zero123_ckpt_warns_and_clip_ckpt_raises(tmp_path):
    """A missing Zero123 checkpoint warns; an existing exp.clip_ckpt no
    longer raises: it loads as the CLIP eval encoder (a file that holds no
    checkpoint fails in the loader), and a missing one means no encoder."""
    from morpheus_tpu_torch.config import merge_defaults
    cfg = merge_defaults({"guidance": {"zero123_ckpt": "/nonexistent.ckpt"}})
    logged = []
    cli._check_zero123_ckpt(cfg, logged.append)
    assert logged and "training recon-only" in logged[0]
    clip = tmp_path / "clip.pt"
    cfg["exp"]["clip_ckpt"] = str(clip)
    assert cli.load_clip_encoder(cfg, torch.device("cpu"), logged.append) \
        is None
    clip.write_bytes(b"")
    cli._check_zero123_ckpt(cfg, logged.append)
    with pytest.raises(EOFError):
        cli.load_clip_encoder(cfg, torch.device("cpu"), logged.append)
    from morpheus_tpu_torch.eval.clip_eval import ImageEncoder
    ImageEncoder(device="cpu").save_checkpoint(str(clip))
    enc = cli.load_clip_encoder(cfg, torch.device("cpu"), logged.append)
    assert isinstance(enc, ImageEncoder) and enc.device.type == "cpu"
    assert logged[-1] == f"Loaded CLIP eval encoder from {clip}"


def test_final_epoch_row_is_a_backfill_candidate(tmp_path):
    """The eval epochs are the multiples of the interval and the final
    epoch; the JAX copy scans the multiples only."""
    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "mesh_all"))
    for e in (2, 3):
        for i in range(FRAMES):
            open(os.path.join(ws, "mesh_all", f"mesh_{e:04d}_{i:04d}.ply"),
                 "w").close()
    with open(os.path.join(ws, "metric_3d.txt"), "w") as f:
        f.write("Ep_2:\t Acc:1.0\t Comp:1.0\n")
    assert backfill.missing_eval_epochs(ws, FRAMES, 2, 3, max_epochs=3) == [3]
    assert backfill.missing_eval_epochs(ws, FRAMES, 2, 3) == []
    assert jbackfill.missing_eval_epochs(ws, FRAMES, 2, 3) == []


# one tiny SDS virtual step of the port's trainer with its guidance
SDS_STEP = (
    "import torch; "
    "from morpheus_tpu_torch.config import merge_defaults; "
    "from morpheus_tpu_torch.data.dataset import load_synthetic; "
    "from morpheus_tpu_torch.guidance import zero123 as z; "
    "from morpheus_tpu_torch.train.trainer import Trainer; "
    "cfg = merge_defaults({'data': {'data_dir': '<synthetic>', "
    "'synthetic_frames': 2, 'synthetic_res': 16}, "
    "'model': {'grid_num_levels': 4, 'grid_log2_hashmap_size': 10}, "
    "'tpu': {'max_samples_per_ray': 8, 'march_steps': 32, "
    "'occ_resolution': 16, 'sample_budget': 4, 'band_budget': 2, "
    "'smooth_budget': 2}}); "
    "spec = z.Zero123Spec(image_size=16, unet_channels=32, "
    "unet_mult=(1, 2), unet_heads=2, context_dim=16, clip_width=32, "
    "clip_layers=1, clip_heads=2, clip_patch=14, vae_ch=32, "
    "vae_mult=(1, 2), vae_res_blocks=1); "
    "tr = Trainer(cfg, load_synthetic(cfg), device='cpu', "
    "guidance=z.Zero123Guidance.init_random(spec, 'cpu')); "
    "loss, diag = tr.virtual_step(5, tr.virtual_sampler(0.5)); "
    "assert torch.isfinite(loss) and tr.global_step == 1, loss")


def test_backfill_worker_runs_without_jax(drive, tmp_path):
    """The final epoch's lost metric row is backfilled by the port's worker,
    with jax and the JAX package unimportable in the worker and in its
    metric subprocess (a package of each name on the path ahead of the real
    ones records any import and raises); in the same process the port's
    guidance imports and one tiny SDS virtual step runs."""
    ws_src, _ = drive
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "morpheus_tpu_torch"),
                    root / "morpheus_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    block = tmp_path / "block"
    marker = tmp_path / "imported.txt"
    for name in ("jax", "morpheus_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"open({str(marker)!r}, 'a').write({name!r} + '\\n')\n"
            f"raise ImportError('{name} is blocked')\n")
    ws = str(tmp_path / "ws")
    shutil.copytree(ws_src, ws, ignore=shutil.ignore_patterns("recording"))
    with open(os.path.join(ws, "metric_3d.txt")) as f:
        kept = [line for line in f if not line.startswith("Ep_2:")]
    with open(os.path.join(ws, "metric_3d.txt"), "w") as f:
        f.writelines(kept)

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['morpheus_tpu'] = None; "
            "from morpheus_tpu_torch.eval import backfill as b; "
            f"p = b.backfill_missing({ws!r}, {FRAMES}, 3, 2, max_epochs=2); "
            "assert p is not None and p.wait(600) == 0; " + SDS_STEP)
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{block}")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(root),
                   env=env)
    log = open(os.path.join(ws, "eval_worker.log")).read()
    assert not marker.exists(), marker.read_text()
    assert "FAILED" not in log and "worker died" not in log, log
    with open(os.path.join(ws, "metric_3d.txt")) as f:
        rows = [line.split(":")[0] for line in f if line.startswith("Ep_")]
    assert rows == ["Ep_1", "Ep_2"]
