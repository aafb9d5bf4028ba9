"""chip_smoke.py's stream capture (capture_streams) on the CPU, over the tiny
config of its card-against-CPU phase: the recorders see every kernel call
that one steady step and one occupancy refresh make under each vjp_mode,
with arguments cloned, and the real functions, their launch counters and
the trainer's refresh are restored afterwards. Also the pure helpers of the
other phases: configs cut to depth, the kernels line, the phase-12 raw
capture and output readers, and each --*-only switch."""
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.ops import (gather, hashgrid, hist, rows,  # noqa: E402
                                    segsum)
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
# gathering its rows and accumulating its embedding cotangents in one launch
# per stream (hist_rows: the packed dense level and the hashed tail)
STEP_CALLS = {"hist_rows": {"row_gather": 6, "level_histogram": 6},
              "mxu_rows": {"level_gather": 3, "level_histogram": 3},
              "sort_pallas_rows": {"row_gather": 3,
                                   "segment_sum_sorted": 3}}
# the kernels' wrappers, by the names ops/hashgrid.py calls them
REAL = {"level_histogram": hist.level_histogram,
        "level_gather": gather.level_gather,
        "segment_sum_sorted": segsum.segment_sum_sorted,
        "row_gather": rows.row_gather}


@pytest.mark.parametrize("mode", list(STEP_CALLS))
def test_capture_streams_records_one_step_and_restores(chip_smoke, mode):
    cfg = chip_smoke.tiny_config(mode)
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr.epoch = 5
    real = REAL
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
    # the sampled refresh's 'nearest' queries gather through the route's
    # gather: level_gather under mxu_rows, row_gather under the others
    want = "level_gather" if mode == "mxu_rows" else "row_gather"
    assert refresh and all(c["kernel"] == want for c in refresh)
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
                        "segment_sum_sorted": 0, "row_gather": 0}


def _tiny_sds_trainer(chip_smoke, mode):
    """chip_smoke's tiny config with SDS on and a tiny random guidance,
    remat_virtual off as configs/synthetic_full.yaml has it."""
    from morpheus_tpu_torch.guidance.zero123 import (Zero123Guidance,
                                                     Zero123Spec)
    import torch_parity as tp
    cfg = chip_smoke.tiny_config(mode)
    cfg["train"].update(virtual_freq=1, warm_up_steps=0, freeze_epoch=4)
    cfg["data"]["novel_view_scale"] = 0.375
    cfg["tpu"]["remat_virtual"] = False
    g = Zero123Guidance.init_random(Zero123Spec(**tp.SPEC_KW), "cpu")
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu", guidance=g)
    tr.epoch = 6
    tr.global_step = 5
    return tr


@pytest.mark.parametrize("mode", list(STEP_CALLS))
def test_capture_sds_streams_under_each_mode(chip_smoke, mode):
    """One SDS step's kernel calls, captured after the route is switched in
    place (set_vjp_mode): the mode's kernels only, the originals and their
    counters restored; the step carried its gradients (epoch 6 is past the
    freeze)."""
    tr = _tiny_sds_trainer(chip_smoke, "hist_rows")
    chip_smoke.set_vjp_mode(tr, mode)
    assert tr.step_field.spec.grid.vjp_mode == mode
    real = REAL
    counts = {k: fn.launches for k, fn in real.items()}
    calls = chip_smoke.capture_sds_streams(tr, 6)
    for name, fn in real.items():
        assert getattr(hashgrid, name) is fn
        assert fn.launches == counts[name]
    got = {c["kernel"] for c in calls}
    assert got == set(STEP_CALLS[mode]) and all(c["phase"] == "sds"
                                                for c in calls)
    assert tr._pending_live
    for c in calls:
        out = real[c["kernel"]](*c["args"], **c["kw"])
        assert bool(torch.isfinite(out).all())


def test_instrument_sds_marks_each_part_and_undoes(chip_smoke):
    """The SDS step's marks come in the order render, VAE encoder, UNet,
    backward (VAE, then render), Adam (freeze on), and every wrapper is
    removed afterwards."""
    from morpheus_tpu_torch import renderer
    from morpheus_tpu_torch.guidance import zero123 as z123
    tr = _tiny_sds_trainer(chip_smoke, "hist_rows")
    tr.epoch = 3
    before = (renderer.render_rays, z123.vae_encode_sample, z123.apply_unet,
              z123.sds_loss)
    names = []
    undo = chip_smoke.instrument_sds(tr, names.append)
    try:
        tr.virtual_step(3, tr.virtual_sampler(0.375))
    finally:
        undo()
    assert names == ["render", "render_end", "vae_fwd", "vae_fwd_end",
                     "unet", "unet_end", "vae_bwd", "render_bwd",
                     "grads_end", "adam", "adam_end"]
    assert (renderer.render_rays, z123.vae_encode_sample, z123.apply_unet,
            z123.sds_loss) == before
    assert "_grads" not in vars(tr) and "update" not in vars(tr.optim)


def test_sds_cli_config_cuts_only_depth(chip_smoke):
    """The SDS CLI phase cuts configs/synthetic_full.yaml in depth only:
    frames, epochs, iterations, warm-up and the diagnostics' cadence; its
    guidance, rays, grid, budgets and scales stay."""
    import yaml
    with open(os.path.join(os.path.dirname(_PATH), "configs",
                           "synthetic_full.yaml")) as f:
        full = yaml.safe_load(f)
    cuts = chip_smoke.SDS_CLI_CUTS
    assert set(cuts["data"]) == {"synthetic_frames"}
    assert set(cuts["train"]) == {"n_epochs", "n_iters", "warm_up_steps"}
    assert set(cuts["exp"]) <= {"test_interval", "mesh_interval",
                                "mesh_all_interval", "mesh_all_eval_interval",
                                "ckpt_interval", "save_guidance",
                                "save_guide_intervel"}
    assert full["guidance"]["zero123_ckpt"] == "<random>"
    assert full["guidance"]["compute_dtype"] == "bfloat16"


def test_split_busy_sums_kernels_between_markers(chip_smoke):
    """split_busy: each window between two marker kernels (short spins)
    goes to the part its opening mark names (render's forward and backward
    together, the VAE encoder's too), as the union of the device intervals
    inside it, clipped to the window; the long bracket spins are passed
    over; with a marker missing from the trace the split is None."""
    m = chip_smoke._Marks.__new__(chip_smoke._Marks)
    m.names = ["step", "render", "render_end", "vae_fwd", "vae_fwd_end",
               "unet", "unet_end", "vae_bwd", "render_bwd", "grads_end",
               "step_end"]
    spins = [("spin_kernel(long)", 100 * i, 100 * i + 1)
             for i in range(len(m.names))]
    # one kernel of 10 us in each window, two overlapping ones in the
    # render's forward window
    work = [("k", 100 * i + 10, 100 * i + 20)
            for i in range(len(m.names) - 1)]
    work.append(("k2", 115, 130))
    bracket = [("spin_kernel(long)", -100 + 30 * i, -100 + 30 * i + 25)
               for i in range(3)] + [("spin_kernel(long)", 2000, 2025)]
    (part,) = chip_smoke.split_busy(
        sorted(bracket + spins + work, key=lambda k: k[1]), [m])
    assert part == {"render": 0.020 + 0.010, "vae_encoder": 0.020,
                    "unet": 0.010, "adam": 0.0, "other": 0.050}
    assert chip_smoke.split_busy(bracket + spins[1:] + work, [m]) is None


# phase 11's captured steady steps on the CPU at the tiny config: the exact
# ladder's two sdf-only normal passes (n1 and n2) take the place of the
# reuse form's one, beside the main closure and the surface-point query:
# four differentiated encodes, each one gather and one histogram per
# stream under hist_rows; the bf16 policy hands the kernels bf16 payloads
# and a bf16 table
MODE_CALLS = {"exact_ladder": {"hist_rows": {"row_gather": 8,
                                             "level_histogram": 8},
                               "mxu_rows": {"level_gather": 4,
                                            "level_histogram": 4},
                               "sort_pallas_rows": {"row_gather": 4,
                                                    "segment_sum_sorted": 4}},
              "bf16_policy": STEP_CALLS}


@pytest.mark.parametrize("name", list(MODE_CALLS))
def test_capture_step_under_each_route_of_a_mode(chip_smoke, name):
    over = {n: o for n, _, o, _ in chip_smoke.MODE_REFERENCES}[name]
    cfg = chip_smoke.tiny_config("hist_rows", over)
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr.epoch = 5
    tr.global_step = 4                      # a refresh step: captured after
    for mode, want in MODE_CALLS[name].items():
        chip_smoke.set_vjp_mode(tr, mode)
        calls = chip_smoke.capture_step(tr)
        assert tr.global_step % cfg["tpu"]["occ_update_every"] == 0
        got = {}
        for c in calls:
            got[c["kernel"]] = got.get(c["kernel"], 0) + 1
        assert got == want, mode
        for c in calls:
            a = c["args"]
            if name != "bf16_policy":
                continue
            if c["kernel"] in ("level_gather", "row_gather"):
                assert a[1].dtype == torch.bfloat16     # the table
            else:
                assert a[1].dtype == (torch.float32 if mode == "mxu_rows"
                                      else torch.bfloat16)  # the payload
        assert hashgrid.level_histogram is hist.level_histogram


def test_exact_cli_config_cuts_only_depth(chip_smoke, tmp_path):
    """Phase 11e's config keeps every width of configs/ab_exact.yaml (the
    exact ladder, no budgets, linear occupancy queries) and cuts frames,
    epochs and cadence."""
    import yaml
    with open(os.path.join(os.path.dirname(_PATH), "configs",
                           "ab_exact.yaml")) as f:
        exact = yaml.safe_load(f)
    cfg = chip_smoke.exact_cli_config(str(tmp_path))
    for section, kv in exact.items():
        for key, value in kv.items():
            cut = chip_smoke.EXACT_CLI_CUTS.get(section, {})
            if key in cut:
                assert cfg[section][key] == cut[key]
            elif (section, key) not in (("exp", "output"),
                                        ("exp", "exp_name")):
                assert cfg[section][key] == value, (section, key)
    assert cfg["tpu"]["band_reuse"] is False
    assert cfg["data"]["synthetic_res"] == 360


def test_modes_only_runs_phase_11_alone(chip_smoke, tmp_path, monkeypatch):
    """--modes-only: the kernels are built (main), then phase 11 alone runs
    and the script returns 0; no other phase is called."""
    import sys
    from morpheus_tpu_torch.data import dataset
    seen = []
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--modes-only"])
    monkeypatch.setattr(dataset, "load_synthetic", lambda cfg: "ds")
    monkeypatch.setattr(chip_smoke, "modes_phase", lambda device, ds, wd: (
        seen.append(ds) or ({}, {k: [] for k in chip_smoke.CAPTURED})))
    for other in ("check_hist", "check_gather", "check_segsum", "main_path",
                  "sds_phase", "cli_phase", "check_mesh_gather"):
        monkeypatch.setattr(chip_smoke, other, lambda *a, **k: 1 / 0)
    assert chip_smoke.run(torch.device("cpu"), "card", str(tmp_path)) == 0
    assert seen == ["ds"]


def _line(case, **kw):
    row = {"case": case, "phase": "step", "L": 2, "Np": 10, "C": 4,
           "max_abs_err": 0.0, "ms": 0.1, "call_ms": 0.2, "plain_ms": 1.0,
           "bound_ms": 0.05, "bound_by": "bytes", "library_ms": 0.3}
    row.update(kw)
    return row


def _kernels_line(chip_smoke, rows, dp_chain=None):
    """kernels_line over `rows` with 7 launches of every kernel in every
    phase but phase 12's CLI (6 histograms) and viewer (300 gathers) and
    phase 13's second rank (5 of each under each mode, 4 in its SDS
    steps); dp_chain: phase 13's chained records, merged into its
    result."""
    counts = {k: 7 for k in chip_smoke.CAPTURED}
    trace = {f"{k}_ms_per_launch": 0.1 for k in chip_smoke.CAPTURED}
    main = {m: {"launches": counts, "trace": trace}
            for m in chip_smoke.PATH_KERNELS}
    modes = {"exact": {"launches": counts}, "bf16": {"launches": counts},
             "options": {"adan": {"launches": counts}},
             "cli": {"kernel_launches": counts}}
    fives = {k: 5 for k in chip_smoke.CAPTURED}
    dp = {"launches": [{m: counts for m in chip_smoke.PATH_KERNELS},
                       {m: fives for m in chip_smoke.PATH_KERNELS}],
          "sds": {"launches": [counts, {k: 4 for k in counts}]},
          **(dp_chain or {})}
    return chip_smoke.kernels_line(
        rows, main, {"kernel_launches": [counts]},
        {"points": [{"epoch": 300, "launches": counts}]},
        {"kernel_launches": [counts]}, modes,
        _line("mesh_mxu_rows_0", launches=9, S=1),
        {"row": _line("viewer_mxu_rows_0", launches=70, S=1),
         "launches": {"cli": {**counts, "level_histogram": 6},
                      "viewer": {**counts, "level_gather": 300}}}, dp)


def test_kernels_line_carries_exact_and_bf16_cases(chip_smoke):
    """Each kernel's entry takes its largest call of the exact and the bf16
    step under its own mode (exact_case, bf16_case), its phase-11 launch
    counts (modes_launches) and its phase-12 launches in the supervised CLI
    and the viewer (pipeline_launches); level_gather's entry also takes the
    viewer's per-frame query call (viewer_case)."""
    rows = {k: [] for k in chip_smoke.CAPTURED}
    for k in rows:
        mode = {"level_histogram": "hist_rows", "level_gather": "mxu_rows",
                "segment_sum_sorted": "sort_pallas_rows",
                "row_gather": "hist_rows"}[k]
        for prefix in ("step", "step_sds", "step_exact", "step_bf16",
                       "step_dp"):
            rows[k] += [_line(f"{prefix}_{mode}_{i}", Np=10 * (i + 1))
                        for i in range(3)]
    out = _kernels_line(chip_smoke, rows)
    assert sorted(e["name"] for e in out["kernels"]) == sorted(
        chip_smoke.CAPTURED)
    for e in out["kernels"]:
        for key, prefix in (("exact_case", "step_exact_"),
                            ("bf16_case", "step_bf16_")):
            assert e[key]["case"].startswith(prefix)
            assert e[key]["case"].endswith("_2")          # the largest
        assert e["modes_launches"] == {"exact": 7, "bf16": 7, "adan": 7,
                                       "exact_cli": 7}
        assert e["pipeline_launches"] == {
            "cli": 6 if e["name"] == "level_histogram" else 7,
            "viewer": 300 if e["name"] == "level_gather" else 7}
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in e
    gather_entry = [e for e in out["kernels"] if e["name"] == "level_gather"]
    view = gather_entry[0]["viewer_case"]
    assert view["case"] == "viewer_mxu_rows_0" and view["launches"] == 70
    for key in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err"):
        assert key in view
    assert all("viewer_case" not in e for e in out["kernels"]
               if e["name"] != "level_gather")


def test_pipeline_config_cuts_only_depth(chip_smoke, tmp_path):
    """Phase 12's config keeps every width of configs/synthetic_bench.yaml,
    cuts epochs and cadence, and points at the preprocessed capture and
    the CLIP checkpoint."""
    import yaml
    with open(os.path.join(os.path.dirname(_PATH), "configs",
                           "synthetic_bench.yaml")) as f:
        bench = yaml.safe_load(f)
    cfg = chip_smoke.pipeline_config(str(tmp_path), "/data/cap", "/c.pt")
    for section, kv in bench.items():
        for key, value in kv.items():
            cut = chip_smoke.PIPELINE_CUTS.get(section, {})
            if key in cut:
                assert cfg[section][key] == cut[key]
            elif (section, key) not in (("exp", "output"),
                                        ("exp", "exp_name"),
                                        ("data", "data_dir")):
                assert cfg[section][key] == value, (section, key)
    assert cfg["data"]["data_dir"] == "/data/cap"
    assert cfg["exp"]["clip_ckpt"] == "/c.pt"
    assert cfg["train"]["n_epochs"] == 1 and cfg["exp"]["test_interval"] == 1
    assert cfg["train"]["real_ray_num"] == 2048
    assert chip_smoke.VIRTUAL_SIZE == cfg["data"]["synthetic_res"] == 360


def test_pipeline_line_readers(chip_smoke):
    """The readers of phase 12's subprocess output: the CLI's CLIP score
    lines, and the viewer's viewer-stats and kernel-launches lines (a
    missing line fails)."""
    cli = ("[2026-01-01_00-00-00] ==> CLIP=0.8123 (test_360_ep0001)\n"
           "==> CLIP=nan (test_360_ep0002)\n")
    got = chip_smoke.clip_scores(cli)
    assert got[0] == (0.8123, "test_360_ep0001")
    assert got[1][1] == "test_360_ep0002" and got[1][0] != got[1][0]
    stats = {"tsdf_s": 1.5, "fg_export_s": 9.0, "raster_s": 3.0,
             "video_s": 0.2, "bg_voxels": 401 ** 3, "bg_faces": 1000,
             "frames": 4}
    launches = {"level_histogram": 0, "level_gather": 300,
                "segment_sum_sorted": 0}
    text = ("[warn] x\nviewer-stats " + json.dumps(stats)
            + "\nkernel-launches " + json.dumps(launches) + "\n")
    assert chip_smoke.viewer_summary(text) == {**stats,
                                               "kernel_launches": launches}
    with pytest.raises(AssertionError, match="viewer-stats"):
        chip_smoke.viewer_summary("kernel-launches " + json.dumps(launches))


def test_raw_capture_goes_through_the_preprocessing(chip_smoke, tmp_path):
    """Phase 12's raw capture at a small size: the object's mask, a wall
    behind it in every depth frame, and the port's preprocessing writes a
    training layout the port's dataset loads."""
    import cv2
    import numpy as np
    from morpheus_tpu_torch.config import merge_defaults
    from morpheus_tpu_torch.data.dataset import DeformDataset
    from morpheus_tpu_torch.preprocess import pose_init, virtual_cams
    d = chip_smoke.write_raw_capture(str(tmp_path), frames=2, H=72, W=96)
    depth = cv2.imread(os.path.join(d, "depth", "0001.png"),
                       cv2.IMREAD_UNCHANGED)
    mask = cv2.imread(os.path.join(d, "mask", "0001.png"),
                      cv2.IMREAD_UNCHANGED)
    assert depth.shape == (72, 96) and mask.any()
    assert depth[mask == 0].min() >= 3300 and depth[mask > 0].max() < 3300
    pose_init.run_pose_init(d)
    virtual_cams.preprocess_sequence(d, size_h=48, size_w=48)
    ds = DeformDataset(merge_defaults({"data": {"data_dir": d}}))
    assert ds.num_frames == 2 and (ds.H, ds.W) == (48, 48)
    assert np.isfinite(ds.poses).all() and ds.masks.sum() > 50


def test_pipeline_only_runs_phase_12_alone(chip_smoke, tmp_path,
                                           monkeypatch):
    """--pipeline-only: phase 12 alone runs and the script returns 0."""
    import sys
    seen = []
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--pipeline-only"])
    monkeypatch.setattr(chip_smoke, "pipeline_phase",
                        lambda device, wd: seen.append(wd) or {})
    for other in ("check_hist", "check_gather", "check_segsum", "main_path",
                  "sds_phase", "cli_phase", "check_mesh_gather",
                  "modes_phase"):
        monkeypatch.setattr(chip_smoke, other, lambda *a, **k: 1 / 0)
    assert chip_smoke.run(torch.device("cpu"), "card", str(tmp_path)) == 0
    assert seen == [str(tmp_path)]


def test_bf16_gemm_check_reads_every_layer_of_both_nets(chip_smoke):
    """Phase 11's check of the bf16 MLP product at the step's own inputs:
    every layer of the sdf and color nets is read, the readings sit inside
    their limits, and the bf16-rounded control lies outside them (here both
    sides are the CPU, so the readings are 0)."""
    cfg = chip_smoke.tiny_config("hist_rows")
    cfg["tpu"]["mlp_dtype"] = "bfloat16"
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr.epoch = 5
    tr._set_levels(tr._active_levels())
    res = chip_smoke.bf16_gemm_check(tr)
    f = tr.field
    want = [("sdf_net", l) for l in range(len(f.sdf_net.layers))] + [
        ("color_net", l) for l in range(len(f.color_net.layers))]
    assert [tuple(s[:2]) for s in res["shapes"]] == want
    assert all(v <= 1.0 for v in res["err_over_limit"].values())
    assert res["y_rel_err"] == 0.0
    assert res["control_rel_err_min"] > chip_smoke.GEMM_TOL


def test_kernels_line_carries_dp_launches_and_case(chip_smoke):
    """Phase 13's record in the kernels line: each kernel's launches in
    each rank under each vjp_mode and in the data-parallel SDS steps
    (dp_launches), and its largest call of rank 0's captured
    data-parallel step under its own mode (dp_case), with every number a
    kernel line has."""
    rows = {k: [] for k in chip_smoke.CAPTURED}
    for k in rows:
        for mode in chip_smoke.PATH_KERNELS:
            for prefix in ("step", "step_sds", "step_exact", "step_bf16",
                           "step_dp"):
                rows[k] += [_line(f"{prefix}_{mode}_{i}", Np=10 * (i + 1))
                            for i in range(3)]
    own = {"level_histogram": "hist_rows", "level_gather": "mxu_rows",
           "segment_sum_sorted": "sort_pallas_rows",
           "row_gather": "hist_rows"}
    for e in _kernels_line(chip_smoke, rows)["kernels"]:
        assert e["dp_launches"] == {**{m: [7, 5]
                                       for m in chip_smoke.PATH_KERNELS},
                                    "sds": [7, 4]}
        case = e["dp_case"]
        assert case["case"] == f"step_dp_{own[e['name']]}_2"
        for key in ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms"):
            assert key in case


def test_kernels_line_carries_dp_chain_launches(chip_smoke):
    """Phase 13's chained steps in the kernels line: each kernel's
    launches in the one-rank group's graphed blocks under each of
    DP_CHAIN_RUNS' modes, each replay counted, and in each rank's chained
    block (dp_chain_launches); absent when phase 13 has no such record."""
    rows = {k: [] for k in chip_smoke.CAPTURED}
    for k in rows:
        for mode in chip_smoke.PATH_KERNELS:
            for prefix in ("step", "step_sds", "step_exact", "step_bf16",
                           "step_dp"):
                rows[k].append(_line(f"{prefix}_{mode}_0"))
    runs = {m: {"graphed": {"launches": {k: 22 + i for k in rows}}}
            for i, (m, _) in enumerate(chip_smoke.DP_CHAIN_RUNS)}
    line = _kernels_line(chip_smoke, rows, {
        "one_rank_chain": {"runs": runs},
        "chain": {"launches": [{k: 11 for k in rows}, {k: 0 for k in rows}]}})
    for e in line["kernels"]:
        assert e["dp_chain_launches"] == {
            "sort_pallas_rows": 22, "hist_rows": 23, "mxu_rows": 24,
            "ranks": [11, 0]}
    assert all("dp_chain_launches" not in e
               for e in _kernels_line(chip_smoke, rows)["kernels"])


def test_dp_only_runs_phase_13_alone(chip_smoke, tmp_path, monkeypatch):
    """--dp-only: phase 13 alone runs and the script returns 0."""
    import sys
    seen = []
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--dp-only"])
    monkeypatch.setattr(chip_smoke, "dp_phase", lambda device, wd: (
        seen.append(wd) or ({}, {k: [] for k in chip_smoke.CAPTURED})))
    for other in ("check_hist", "check_gather", "check_segsum", "main_path",
                  "sds_phase", "cli_phase", "check_mesh_gather",
                  "modes_phase", "pipeline_phase"):
        monkeypatch.setattr(chip_smoke, other, lambda *a, **k: 1 / 0)
    assert chip_smoke.run(torch.device("cpu"), "card", str(tmp_path)) == 0
    assert seen == [str(tmp_path)]


def test_dp_phase_ranks_on_the_cpu(chip_smoke, tmp_path, monkeypatch):
    """Phase 13's code at tiny_config's widths on the CPU: the one-rank
    group (gloo here) equal to the plain trainer bit for bit, then two
    gloo ranks through dp_real (their one-rank reference within
    DP_LOSS_RTOL and 2*n*lr, the replicas equal, 10 all-reduces a step)
    and dp_sds on a tiny random Zero123 (the gradients the views' mean)."""
    import sys
    from morpheus_tpu_torch.parallel import sharding
    # the ranks' function goes to them by its module's name
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    one_cfg = chip_smoke.tiny_config("hist_rows")
    one = chip_smoke.dp_one_rank(torch.device("cpu"), one_cfg,
                                 load_synthetic(one_cfg), n_timed=1)
    assert one["bitwise_equal"] and one["backend"] == "gloo"
    # the one-rank group's chained blocks (gloo: the graph's body, eager)
    chain = one["chain"]
    assert [m for m, _ in chip_smoke.DP_CHAIN_RUNS] == list(chain["runs"])
    for run in chain["runs"].values():
        assert run["compare"]["failed"] == [] and not run["graphed"][
            "captures"]
    assert chain["trace"]["steps"] > 0
    real = chip_smoke.tiny_config("hist_rows", {"tpu": {"data_parallel": 2}})
    sds = chip_smoke.tiny_config("hist_rows", {
        "train": {"virtual_freq": 1, "real_freq": 1, "warm_up_steps": 0,
                  "freeze_epoch": 4},
        "model": {"bg_radius": 1.4}, "data": {"novel_view_scale": 0.375},
        "guidance": {"zero123_ckpt": "<random-tiny>"},
        "tpu": {"data_parallel": 2}})
    sharding.launch(chip_smoke.dp_rank, 2, "cpu",
                    args=(str(tmp_path), real, sds, 2, 3))
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    r0 = ranks[0]["real"]
    assert r0["loss_max_rel_diff"] <= chip_smoke.DP_LOSS_RTOL
    assert r0["param_max_diff"] <= r0["param_limit"]
    assert ranks[0]["sds"]["grad_max_rel_diff"] <= chip_smoke.DP_SDS_GRAD_TOL
    for r in ranks:
        assert r["real"]["replicas_equal"] and r["sds"]["replicas_equal"]
        assert r["real"]["collectives_per_step"] == 10
        assert r["real"]["losses"] == r0["losses"]
        # the chained block's body: the eager step's all-reduces
        assert r["real"]["chain"]["collectives_per_step"] == 10
        assert not r["real"]["chain"]["graphed"]


# ---- phase 14: the bench and the profilers ----------------------------------

CARD = "NVIDIA H100 80GB HBM3"


def _bench_out(**kw):
    out = {"metric": "rays_per_sec_per_chip", "value": 38000.0,
           "unit": "rays/s", "vs_baseline": 1.27, "steps_per_sec": 18.6,
           "rays_per_sec_isolated": 37000.0, "rays_per_sec_late": 34000.0,
           "rays_per_sec_epoch_loop": 33000.0, "compile_s": 1.8,
           "kernel_build_s": 0.0, "device": f"{CARD}, 700.00 W",
           "loss": 0.71, "step_gflops": 47.8, "mfu_vs_bf16_peak": 0.0009,
           "sds_step_ms_s05": 378.0, "sds_step_ms_s02": 184.5,
           "sds_step_ms_bf16_s05_late": 513.8}
    out.update(kw)
    return out


def _bench_text(out, head=None):
    """The bench's standard output: the headline line, then the superset."""
    head = head or {k: v for k, v in out.items() if not k.startswith("sds")}
    return json.dumps(head) + "\n" + json.dumps(out) + "\n"


def test_check_bench_reads_the_last_line(chip_smoke):
    out = _bench_out()
    assert chip_smoke.check_bench(_bench_text(out), CARD) == out
    # the headline alone (the SDS part never printed) is refused
    with pytest.raises(AssertionError, match="sds_step_ms_s05"):
        chip_smoke.check_bench(json.dumps(out) + "\n" + json.dumps(
            {k: v for k, v in out.items() if not k.startswith("sds")}),
            CARD)
    with pytest.raises(AssertionError, match="no JSON line"):
        chip_smoke.check_bench("bench: [0.5s] real step\n", CARD)


@pytest.mark.parametrize("bad", [
    {"sds_skipped": {"sds_step_ms_s02": "over 5400s budget"}},
    {"sds_step_ms_bf16_s05_late": None},
    {"value": float("nan")},
    {"rays_per_sec_late": float("inf")},
    {"rays_per_sec_epoch_loop": 0.0},
    {"loss": float("nan")},
    {"mfu_vs_bf16_peak": None},
    {"device": "cpu"},
], ids=["sds_skipped", "sds_missing", "value_nan", "late_inf",
        "loop_zero", "loss_nan", "no_mfu", "not_the_card"])
def test_check_bench_refuses(chip_smoke, bad):
    out = _bench_out(**bad)
    out = {k: v for k, v in out.items() if v is not None}
    with pytest.raises(AssertionError, match="bench line"):
        chip_smoke.check_bench(_bench_text(out), CARD)


def _gather_text(launches):
    """bench_gather's lines with `launches` of each mode's route kernels."""
    from morpheus_tpu_torch.scripts import bench_gather
    kernels = ("level_histogram", "level_gather", "segment_sum_sorted",
               "row_gather")
    return "".join(
        "bench_gather: " + json.dumps({"mode": m, "launches": {
            k: (launches if k in bench_gather.ROUTE_KERNELS[m] else 0)
            for k in kernels}}) + "\n"
        for m in bench_gather.MODES)


def test_gather_modes_needs_every_route_kernel(chip_smoke):
    res = chip_smoke.gather_modes(_gather_text(2))
    assert sorted(res) == sorted(["rows", "hist_rows", "mxu_rows",
                                  "mxu_rows_bf16", "sort_pallas_rows"])
    with pytest.raises(AssertionError, match="bench_gather"):
        chip_smoke.gather_modes(_gather_text(0))
    with pytest.raises(AssertionError, match="modes"):
        chip_smoke.gather_modes(_gather_text(2).split("\n", 1)[1])


def test_bench_phase_runs_the_bench_then_each_tool(chip_smoke, monkeypatch):
    """Phase 14 runs the bench with the pause off, then BENCH_TOOLS in
    order; a tool that exits non-zero fails the phase."""
    seen = []

    def tool(module, args, env_extra=None, timeout=600):
        seen.append((module, args, env_extra))
        if module == "bench":
            return _bench_text(_bench_out())
        if module == "scripts.bench_gather":
            return _gather_text(1)
        return ""
    monkeypatch.setattr(chip_smoke, "run_tool", tool)
    monkeypatch.setattr(chip_smoke, "bench_gather_lines", lambda dev: {})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: CARD)
    res = chip_smoke.bench_phase(torch.device("cpu"))
    assert seen[0] == ("bench", [], {"MORPHEUS_BENCH_NO_PAUSE": "1"})
    assert [(m, a) for m, a, _ in seen[1:]] == list(chip_smoke.BENCH_TOOLS)
    assert res["bench"]["value"] == 38000.0 and len(res["gather"]) == 5


def test_run_tool_echoes_and_fails_on_a_nonzero_exit(chip_smoke,
                                                     monkeypatch):
    import subprocess
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lines.append)
    monkeypatch.setattr(subprocess, "run", lambda cmd, **k: subprocess.
                        CompletedProcess(cmd, 3, "out\n", "err\n"))
    with pytest.raises(AssertionError, match="exited 3"):
        chip_smoke.run_tool("scripts.trace_step", ["base"])
    assert lines[:2] == ["  out", "  err"]
    monkeypatch.setattr(subprocess, "run", lambda cmd, **k: subprocess.
                        CompletedProcess(cmd, 0, "ok\n", ""))
    assert chip_smoke.run_tool("bench", []) == "ok\n"


def test_bench_only_runs_phase_14_alone(chip_smoke, tmp_path, monkeypatch):
    import sys
    seen = []
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--bench-only"])
    monkeypatch.setattr(chip_smoke, "bench_phase",
                        lambda dev: seen.append(dev) or {})
    for other in ("check_hist", "check_gather", "check_segsum", "main_path",
                  "sds_phase", "cli_phase", "check_mesh_gather",
                  "modes_phase", "pipeline_phase", "dp_phase"):
        monkeypatch.setattr(chip_smoke, other, lambda *a, **k: 1 / 0)
    assert chip_smoke.run(torch.device("cpu"), "card", str(tmp_path)) == 0
    assert seen == [torch.device("cpu")]


def test_kernels_line_carries_bench_gather_launches(chip_smoke):
    rows = {k: [] for k in chip_smoke.CAPTURED}
    for k in rows:
        for mode in chip_smoke.PATH_KERNELS:
            for prefix in ("step", "step_sds", "step_exact", "step_bf16",
                           "step_dp"):
                rows[k] += [_line(f"{prefix}_{mode}_0")]
        rows[k] += [_line(f"bench_gather_{k}", Np=99)]
    gather = chip_smoke.gather_modes(_gather_text(3))
    counts = {k: 7 for k in chip_smoke.CAPTURED}
    trace = {f"{k}_ms_per_launch": 0.1 for k in chip_smoke.CAPTURED}
    main = {m: {"launches": counts, "trace": trace}
            for m in chip_smoke.PATH_KERNELS}
    modes = {"exact": {"launches": counts}, "bf16": {"launches": counts},
             "options": {}, "cli": {"kernel_launches": counts}}
    dp = {"launches": [{m: counts for m in chip_smoke.PATH_KERNELS}],
          "sds": {"launches": [counts]}}
    out = chip_smoke.kernels_line(
        rows, main, {"kernel_launches": [counts]},
        {"points": [{"epoch": 300, "launches": counts}]},
        {"kernel_launches": [counts]}, modes,
        _line("mesh_mxu_rows_0", launches=9, S=1),
        {"row": _line("viewer_mxu_rows_0", launches=70, S=1),
         "launches": {"cli": counts}}, dp, gather)
    from morpheus_tpu_torch.scripts.bench_gather import ROUTE_KERNELS
    for e in out["kernels"]:
        assert e["bench_gather_launches"] == {
            m: 3 if e["name"] in ks else 0 for m, ks in ROUTE_KERNELS.items()}
        assert e["bench_gather_case"]["case"] == f"bench_gather_{e['name']}"


def test_bench_gather_lines_on_the_cpu(chip_smoke, monkeypatch):
    """Phase 14's kernel lines on bench_gather's stream, cut to a tiny
    stream and timed once: each kernel against its plain version."""
    from morpheus_tpu_torch.scripts import bench_gather
    real = bench_gather.make_stream
    monkeypatch.setattr(bench_gather, "make_stream", lambda dev: real(
        dev, num_levels=4, log2_hashmap_size=10, active=3, points=64))
    monkeypatch.setattr(chip_smoke, "timings", lambda *a, **k: {
        "ms": 1.0, "plain_ms": 1.0, "library_ms": 1.0, "call_ms": 1.0})
    monkeypatch.setattr(chip_smoke, "device_ms", lambda *a, **k: (1.0, 0))
    rows = chip_smoke.bench_gather_lines(torch.device("cpu"))
    assert [r["case"] for k in chip_smoke.CAPTURED for r in rows[k]] == [
        "bench_gather_hist_rows", "bench_gather_mxu_rows",
        "bench_gather_mxu_rows_bf16", "bench_gather_sort_pallas_rows",
        "bench_gather_hist_rows"]
    for k in rows:
        for r in rows[k]:
            assert r["max_abs_err"] < 1e-4 and r["bound_ms"] > 0
