"""The port's trainer CLI under data parallelism on the CPU:
`python -m morpheus_tpu_torch --device cpu ... tpu --data_parallel 2`
starts two gloo ranks that train one scene; rank 0 alone writes the log
and the artifacts (one set, as tests/test_torch_cli.py checks them), and
a second call resumes both ranks from the newest checkpoint. The mesh
resolutions are cut as in tests/test_torch_cli.py (the ranks take the
launching process's). A ray count the ranks cannot split evenly is
refused before any rank starts."""
import os
import re
import subprocess
import sys

import pytest
import yaml

torch = pytest.importorskip("torch")

import morpheus_tpu_torch.__main__ as cli  # noqa: E402
from test_torch_cli import TINY, _artifacts  # noqa: E402

FRAMES = TINY["data"]["synthetic_frames"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp, name, **tpu):
    cfg = {k: dict(v) for k, v in TINY.items()}
    cfg["exp"]["output"] = str(tmp / "exp")
    cfg["train"]["real_ray_num"] = 256
    cfg["tpu"].update(tpu)
    path = tmp / name
    path.write_text(yaml.dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """`tpu --data_parallel 2` for one epoch, then a config holding
    data_parallel 2 with `train --n_epochs 2`, which resumes."""
    tmp = tmp_path_factory.mktemp("dp_cli")
    ws = str(tmp / "exp" / TINY["exp"]["exp_name"])
    logs = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cli, "MESH_RES", 16)
        m.setattr(cli, "MESH_ALL_RES", 16)
        m.setattr(cli, "MESH_ALL_FINAL_RES", 20)
        m.setenv("MORPHEUS_EVAL_DRAIN_S", "600")
        for argv in ([_config(tmp, "a.yaml"), "tpu", "--data_parallel", "2"],
                     [_config(tmp, "b.yaml", data_parallel=2), "train",
                      "--n_epochs", "2"]):
            path = os.path.join(ws, "log.txt")
            n0 = os.path.getsize(path) if os.path.exists(path) else 0
            cli.main(["--config", argv[0], "--device", "cpu"] + argv[1:])
            with open(path) as f:
                logs.append(f.read()[n0:])
    return ws, logs


def test_dp_cli_writes_one_log_and_one_set_of_artifacts(drive):
    ws, logs = drive
    missing = [p for p in _artifacts((1, 2), FRAMES)
               if not os.path.exists(os.path.join(ws, p))]
    assert not missing
    for log in logs:
        for line in ("Loaded 2 frames", "Exported init mesh",
                     "Training done.", "kernel-launches"):
            assert log.count(line) == 1, (line, log)
    assert [int(e) for e in re.findall(r'epoch-stats \{"epoch": (\d+)',
                                       "".join(logs))] == [1, 2]


def test_dp_cli_resumes_every_rank(drive):
    _, (first, second) = drive
    assert "Resumed" not in first
    assert re.search(r"Resumed from \S+model_ep_0001\.pkl \(epoch 1\)",
                     second)
    losses = [float(x) for x in re.findall(r'"loss": ([-0-9.e]+)',
                                           first + second)]
    assert len(losses) == 2 and all(l == l for l in losses)


def test_dp_cli_refuses_an_uneven_ray_split(tmp_path):
    cfg = _config(tmp_path, "c.yaml")
    with pytest.raises(ValueError, match="divisible by tpu.data_parallel"):
        cli.main(["--config", cfg, "--device", "cpu", "tpu",
                  "--data_parallel", "3"])


def test_python_m_starts_the_ranks(tmp_path):
    """`python -m morpheus_tpu_torch` (the package's __main__, which spawn
    does not run again in a child) starts its ranks: a run of no epochs
    exports the init mesh and ends."""
    cfg = _config(tmp_path, "d.yaml")
    with open(cfg) as f:
        body = yaml.safe_load(f)
    body["train"]["n_epochs"] = 0
    body["tpu"]["data_parallel"] = 2
    with open(cfg, "w") as f:
        yaml.dump(body, f)
    proc = subprocess.run(
        [sys.executable, "-m", "morpheus_tpu_torch", "--config", cfg,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, MORPHEUS_EVAL_DRAIN_S="0"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Exported init mesh") == 1
    assert proc.stdout.count("Training done.") == 1
