"""The port's trainer CLI with Zero123 SDS guidance on the CPU: the
"<random-tiny>" guidance (morpheus.py:139-142's spec) trains through
`python -m morpheus_tpu_torch --device cpu` (called in-process), its
virtual steps writing a guidance panel, and a second call resumes from the
checkpoint, which carries pending_grads and host_step. Mesh resolutions are
cut as in tests/test_torch_cli.py."""
import glob
import os
import pickle
import re

import cv2
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import morpheus_tpu_torch.__main__ as cli  # noqa: E402
from test_torch_cli import TINY  # noqa: E402


def test_cli_trains_sds_with_random_tiny_guidance_and_resumes(tmp_path):
    cfg = {k: dict(v) for k, v in TINY.items()}
    cfg["exp"].update(output=str(tmp_path / "exp"), exp_name="sds",
                      save_guidance=True, save_guide_intervel=2,
                      mesh_all_eval_interval=100)
    # one virtual slot and two real steps an epoch, SDS from the first
    # host step; the deform freeze ends after epoch 1, so the resumed
    # epoch's virtual step carries its gradients into the real steps
    cfg["train"].update(virtual_freq=1, warm_up_steps=0, freeze_epoch=1)
    cfg["guidance"] = {"model": ["zero123"], "zero123_ckpt": "<random-tiny>"}
    path = tmp_path / "sds.yaml"
    path.write_text(yaml.dump(cfg))
    ws = str(tmp_path / "exp" / "sds")
    logs = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cli, "MESH_RES", 16)
        m.setattr(cli, "MESH_ALL_RES", 16)
        m.setattr(cli, "MESH_ALL_FINAL_RES", 16)
        m.setenv("MORPHEUS_EVAL_DRAIN_S", "600")
        for extra in ([], ["train", "--n_epochs", "2"]):
            n0 = (os.path.getsize(os.path.join(ws, "log.txt"))
                  if os.path.exists(os.path.join(ws, "log.txt")) else 0)
            cli.main(["--config", str(path), "--device", "cpu"] + extra)
            with open(os.path.join(ws, "log.txt")) as f:
                logs.append(f.read()[n0:])
    first, second = logs
    for log in logs:
        assert "Initialized RANDOM-weight Zero123 guidance (<random-tiny>)" \
            in log
        assert "Training done." in log
    assert re.search(r"Resumed from \S+model_ep_0001\.pkl \(epoch 1\)",
                     second)
    losses = [float(x) for x in re.findall(r'"loss": ([-0-9.e]+)',
                                           first + second)]
    assert len(losses) == 2 and np.isfinite(losses).all()

    # host steps 0 (epoch 1) and 3 (epoch 2) are the virtual ones; the
    # panel cadence of 2 writes step 0's: render | noised | denoised | grad
    panels = sorted(glob.glob(os.path.join(ws, "guidance",
                                           "*_zero123_*.png")))
    assert [os.path.basename(p).split("_")[0] for p in panels] == ["000000"]
    img = cv2.imread(panels[0])
    assert img.shape == (64, 4 * 64, 3)

    with open(os.path.join(ws, "models", "model_ep_0002.pkl"), "rb") as f:
        state = pickle.load(f)
    assert state["host_step"] == 6 and state["global_step"] == 6
    assert set(state["pending_grads"]) == set(state["params"])
    for name, g in state["pending_grads"].items():
        # the last real step folded the carried gradients in and cleared
        # them
        assert not np.any(g), name
