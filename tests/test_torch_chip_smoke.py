"""chip_smoke.py's stream capture (capture_streams) on the CPU, over the tiny
config of its card-against-CPU phase: the recorders see every kernel call
that one steady step and one occupancy refresh make under each vjp_mode,
with arguments cloned, and the real functions, their launch counters and
the trainer's refresh are restored afterwards."""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.ops import gather, hashgrid, hist, segsum  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# kernel calls of one steady tiny step: three differentiated encodes, each
# accumulating its embedding cotangents in one launch per stream (hist_rows:
# the packed dense level and the hashed tail)
STEP_CALLS = {"hist_rows": {"level_histogram": 6},
              "mxu_rows": {"level_gather": 3, "level_histogram": 3},
              "sort_pallas_rows": {"segment_sum_sorted": 3}}


@pytest.mark.parametrize("mode", list(STEP_CALLS))
def test_capture_streams_records_one_step_and_restores(chip_smoke, mode):
    cfg = chip_smoke.tiny_config(mode)
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr.epoch = 5
    real = {"level_histogram": hist.level_histogram,
            "level_gather": gather.level_gather,
            "segment_sum_sorted": segsum.segment_sum_sorted}
    counts = {k: fn.launches for k, fn in real.items()}

    calls = chip_smoke.capture_streams(tr)

    for name, fn in real.items():
        assert getattr(hashgrid, name) is fn
        assert fn.launches == counts[name]
    assert "_maybe_update_occ" not in vars(tr)
    step = [c for c in calls if c["phase"] == "step"]
    got = {}
    for c in step:
        got[c["kernel"]] = got.get(c["kernel"], 0) + 1
    assert got == STEP_CALLS[mode]
    refresh = [c for c in calls if c["phase"] == "refresh"]
    # the sampled refresh's 'nearest' queries gather through level_gather
    # under mxu_rows only (the other modes use index_select)
    if mode == "mxu_rows":
        assert refresh and all(c["kernel"] == "level_gather"
                               for c in refresh)
    else:
        assert not refresh
    assert calls[:len(step)] == step                 # the steady step first
    for c in calls:
        for a in c["args"]:
            if isinstance(a, torch.Tensor):
                assert a.device.type == "cpu" and not a.requires_grad
    # each recorded call replays through the real function
    for c in calls:
        out = real[c["kernel"]](*c["args"], **c["kw"])
        assert bool(torch.isfinite(out).all())


def test_cli_config_cuts_only_depth(chip_smoke, tmp_path):
    """The CLI phase's config keeps every width of
    configs/synthetic_bench.yaml and cuts frames, epochs and cadence."""
    import yaml
    with open(os.path.join(os.path.dirname(_PATH), "configs",
                           "synthetic_bench.yaml")) as f:
        bench = yaml.safe_load(f)
    cfg = chip_smoke.cli_config(str(tmp_path))
    for section, kv in bench.items():
        for key, value in kv.items():
            cut = chip_smoke.CLI_CUTS.get(section, {})
            if key in cut:
                assert cfg[section][key] == cut[key]
            elif (section, key) not in (("exp", "output"),
                                        ("exp", "exp_name")):
                assert cfg[section][key] == value, (section, key)
    assert cfg["data"]["synthetic_res"] == 360
    assert cfg["train"]["real_ray_num"] == 2048


def test_capture_mesh_gather_records_and_restores(chip_smoke, tmp_path):
    """capture_mesh_gather on the CPU at the tiny config under mxu_rows:
    the dense query's first level_gather call is recorded, every launch of
    the export is counted, and the real function is restored."""
    cfg = chip_smoke.tiny_config("mxu_rows")
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    real = gather.level_gather
    args, launches, info = chip_smoke.capture_mesh_gather(
        tr.field, str(tmp_path / "m.ply"), resolution=24)
    assert hashgrid.level_gather is real
    assert info["backend"] == "native" and info["faces"] > 0
    idx, emb, starts, n_split = args
    # one chunk of 24^3 points, 8 corners each, on the 3 hashed and dense
    # levels; the sdf table; one bf16 plane
    assert idx.shape == (4, 8 * 24 ** 3) and emb.shape[1] == 2
    assert n_split == 1
    out = real(*args)
    assert out.shape == (4 * 8 * 24 ** 3, 2) and bool(torch.isfinite(out).all())
    # the CPU runs the plain twin: no launch is counted
    assert launches == {"level_histogram": 0, "level_gather": 0,
                        "segment_sum_sorted": 0}
