"""The port's trainer CLI (python -m morpheus_tpu_torch) on the CPU at a
tiny shape of configs/ab_exact.yaml: no sample, smooth or band budget, the
exact surface-band ladder (band_reuse false), float32 payloads, linear
occupancy queries refreshing a quarter of the cells, with the smoothness
terms on. One epoch writes the artifacts of morpheus.py's epoch loop (the
mesh resolutions cut to 16 and 20, as tests/test_torch_cli.py cuts them)
and logs a finite loss."""
import os
import re

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import morpheus_tpu_torch.__main__ as cli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_trains_ab_exact_shape(tmp_path, monkeypatch):
    with open(os.path.join(ROOT, "configs", "ab_exact.yaml")) as f:
        cfg = yaml.safe_load(f)
    # the config's own tpu section and train weights; scale cut to a tiny
    # scene, grid and schedule
    cfg["data"].update(synthetic_frames=2, synthetic_res=32)
    cfg["exp"].update(output=str(tmp_path / "exp"), test_interval=1,
                      mesh_interval=1, mesh_all_interval=1,
                      mesh_all_eval_interval=1, seed=7)
    cfg["render"]["step_size"] = 0.02
    cfg["train"].update(n_epochs=1, n_iters=1, real_freq=2, warm_up_end=3,
                        real_ray_num=64)
    cfg["model"].update(grid_num_levels=4, grid_log2_hashmap_size=12,
                        grid_desired_resolution=48)
    cfg["tpu"].update(max_samples_per_ray=16, march_steps=64,
                      occ_resolution=16, occ_warmup_steps=2,
                      occ_update_every=2)
    assert cfg["tpu"]["band_reuse"] is False
    assert cfg["tpu"]["band_budget"] == cfg["tpu"]["sample_budget"] == 0
    path = tmp_path / "ab_exact_tiny.yaml"
    path.write_text(yaml.dump(cfg))
    monkeypatch.setattr(cli, "MESH_RES", 16)
    monkeypatch.setattr(cli, "MESH_ALL_RES", 16)
    monkeypatch.setattr(cli, "MESH_ALL_FINAL_RES", 20)
    monkeypatch.setenv("MORPHEUS_EVAL_DRAIN_S", "600")
    cli.main(["--config", str(path), "--device", "cpu"])
    ws = tmp_path / "exp" / "ab_exact"
    for p in ("mesh/init.ply", "mesh/mesh_0001.ply",
              "mesh_all/mesh_0001_0000.ply", "results/test_ep0001_rgb.mp4",
              "models/model_ep_0001.pkl", "metric_3d.txt"):
        assert (ws / p).exists(), p
    log = (ws / "log.txt").read_text()
    losses = [float(x) for x in re.findall(r'"loss": ([-0-9.e]+)', log)]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert "Training done." in log
