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
