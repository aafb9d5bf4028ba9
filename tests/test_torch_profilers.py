"""The port's profilers and microbenches (morpheus_tpu_torch/scripts/
profile_step.py, trace_step.py, profile_sds.py, bench_gather.py,
bench_dense_scale.py) and entry point (morpheus_tpu_torch/entry.py),
tiny on the CPU: the variant lists equal the JAX scripts'; the step
variants, the roofline split, the trace and an SDS variant run; every
gather mode's forward, gradient and second order agree with the plain
index_select route (f32 payloads 1e-5, a bf16 payload 2^-7 of the largest
value); entry() renders what __graft_entry__.entry() renders from the same
parameters (convert.py) and the same march draws, at the render parity
tests' rtol 1e-4, atol 1e-5."""
import copy
import importlib.util
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402
import jax  # noqa: E402

from morpheus_tpu_torch import bench, convert, entry  # noqa: E402
from morpheus_tpu_torch.guidance.zero123 import Zero123Spec  # noqa: E402
from morpheus_tpu_torch.scripts import (  # noqa: E402
    bench_dense_scale, bench_gather, profile_sds, profile_step, trace_step)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

# the bench point cut to CPU size (tests/test_torch_bench.py's TINY)
TINY = bench.deep_update(copy.deepcopy(bench.BENCH_POINT_CFG), {
    "model": {"grid_num_levels": 4, "grid_log2_hashmap_size": 10,
              "grid_desired_resolution": 32},
    "train": {"real_ray_num": 64},
    "tpu": {"occ_resolution": 16, "march_steps": 64,
            "max_samples_per_ray": 16}})


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variant_lists_equal_the_jax_scripts():
    assert profile_step.VARIANTS == _jax_script("profile_step").VARIANTS
    assert profile_sds.VARIANTS == _jax_script("profile_sds").VARIANTS


def test_every_step_variant_runs_tiny():
    """Each of the 19 variants: one warm-up and one timed step, finite;
    `_epoch` moves the point (all 4 levels either way at this size)."""
    lines = []
    for name, ovr in profile_step.VARIANTS:
        dt = profile_step.time_variant(name, ovr, "cpu", hw=16, warmup=1,
                                       n=1, base=TINY, log=lines.append)
        assert math.isfinite(dt) and dt > 0
    assert [ln.split()[0] for ln in lines] == [
        n for n, _ in profile_step.VARIANTS]
    tr = profile_step.make_trainer({"_epoch": 1900, "tpu": {
        "merge_smooth": False}}, "cpu", hw=16, base=TINY)
    assert (tr.epoch, tr.global_step) == (1900, 209000)
    assert tr.rcfg.merge_smooth is False


def test_roofline_phases_run_tiny():
    lines = []
    rows = profile_step.roofline(300, "cpu", hw=16, n=1, base=TINY,
                                 stream_mib=1, log=lines.append)
    assert [r[0] for r in rows] == ["forward", "fwd+bwd", "optimizer",
                                    "full step"]
    ms, gf = {r[0]: r[1] for r in rows}, {r[0]: r[2] for r in rows}
    assert all(math.isfinite(v) and v > 0 for v in ms.values())
    # the backward adds products; Adam has none; no card, no memory peak
    assert 0 < gf["forward"] < gf["fwd+bwd"] and gf["optimizer"] == 0
    assert all(r[3] is None and r[4] is None for r in rows)
    assert lines[0].startswith("stream calibration (1 MiB copy)")


def test_trace_steps_with_cpu_activities():
    tr = profile_step.make_trainer({}, "cpu", hw=16, base=TINY)
    lines = []
    res = trace_step.trace_steps(tr, n=2, top=5,
                                 log=lambda *a: lines.append(" ".join(a)))
    assert res["steps"] == 2 and res["kernels_per_step"] > 0
    assert math.isfinite(res["step_ms_traced"])
    # no kernel on the CPU: the plain twins run instead
    assert res["level_histogram_launches_per_step"] == 0
    assert len(lines) == 6 and lines[-1].startswith("trace: {")
    assert trace_step.busy_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_sds_variant_runs_tiny():
    """The last variant (bf16 UNet, 16 levels, bf16 MLPs, no
    recomputation) with the smallest guidance spec."""
    spec = Zero123Spec(image_size=16, unet_channels=32, unet_mult=(1, 2),
                       unet_heads=2, context_dim=16, clip_width=32,
                       clip_layers=1, clip_heads=2, clip_patch=14,
                       vae_ch=32, vae_mult=(1, 2), vae_res_blocks=1)
    lines = []
    name = "s05_bf16_late_mlpbf16_noremat"
    dt = profile_sds.time_sds_variant(name, **profile_sds.VARIANTS[name],
                                      device="cpu", hw=16, spec=spec,
                                      base=TINY, warmup=1, n=1,
                                      log=lines.append)
    assert math.isfinite(dt) and dt > 0 and lines[0].startswith(name)


@pytest.mark.parametrize("mode", list(bench_gather.MODES))
def test_gather_modes_agree_with_index_select(mode):
    """3 levels x 8 corners x 512 points of a 4-level grid: forward,
    gradient and second order within TOL of the plain route; no kernel
    launches on the CPU."""
    stream = bench_gather.make_stream("cpu", num_levels=4,
                                      log2_hashmap_size=10, active=3,
                                      points=512)
    res = bench_gather.run_mode(mode, stream, reps=1)
    _, payload = bench_gather.MODES[mode]
    assert res["tol"] == (2.0 ** -7 if payload is torch.bfloat16 else 1e-5)
    assert set(res["max_rel_err"]) == {"fwd", "grad", "second"}
    assert bench_gather.check(res, on_card=False) == []
    assert all(v == 0 for v in res["launches"].values())
    for k in ("fwd_ms", "fwd_bwd_ms", "second_ms"):
        assert math.isfinite(res[k]) and res[k] > 0
    if payload is torch.bfloat16:
        # the bf16 payload rounds: the error shows, under its tolerance
        assert res["max_rel_err"]["grad"] > 1e-5


def test_gather_check_refuses_errors_and_missing_launches():
    res = {"mode": "mxu_rows", "tol": 1e-5,
           "max_rel_err": {"fwd": 0.0, "grad": 2e-5, "second": float("nan")},
           "launches": {"level_histogram": 3, "level_gather": 0,
                        "segment_sum_sorted": 1}}
    faults = bench_gather.check(res, on_card=True)
    assert len(faults) == 4          # grad, second, no gather, a segsum
    assert bench_gather.check(res, on_card=False) == faults[:2]
    assert bench_gather.main(["rows", "--device", "cpu"], reps=1,
                             stream_kw=dict(num_levels=4,
                                            log2_hashmap_size=10, active=2,
                                            points=64),
                             log=lambda *a: None) == 0


def test_dense_scale_smoke_runs_on_the_cpu():
    rows = bench_dense_scale.run("cpu", smoke=True, reps=1,
                                 log=lambda *a: None)
    assert len(rows) == 1 and rows[0]["max_rel_err"] <= bench_dense_scale.TOL
    assert bench_dense_scale.main(["--smoke", "--device", "cpu"]) == 0


def test_entry_matches_jax_entry():
    """The same tiny trainer's forward render as __graft_entry__.entry():
    the JAX parameters carried across with convert.params_from_jax, the
    JAX render's PRNGKey(0) march draws replayed, the same frame-0 rays."""
    import __graft_entry__ as ge
    jfn, jargs = ge.entry()
    want = jax.jit(jfn)(*jargs)
    jtr = ge._tiny_trainer()
    ttr = entry._tiny_trainer("cpu")
    ttr.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    n = jargs[0].shape[0]
    fn, args = entry.entry("cpu", trainer=ttr, draws=lambda: tp.ReplayDraws(
        tp.render_draws(jax.random.PRNGKey(0), jtr.config, n)))
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    for g, w, name in zip(got, want, ("image", "depth", "opacity")):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert float(got[2].max()) > 0.1           # the frame sees the object
    # the default draws: two calls render alike
    fn, args = entry.entry("cpu", trainer=ttr)
    assert all(torch.equal(a, b) for a, b in zip(fn(*args), fn(*args)))


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
