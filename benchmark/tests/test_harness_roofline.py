"""rooflines/level_histogram.py's launches against the port's
level_histogram calls in a real step on the CPU, and its bytes against a
count by hand."""
import pytest
import torch

from benchmark.rooflines import level_histogram as roof


def _cfg(rays):
    from benchmark import inputs
    cell = inputs.load_cell("snoopy_sds.e1900")
    cfg = inputs.run_config(cell)
    cfg["data"].update(synthetic_frames=4, synthetic_res=32)
    cfg["train"]["real_ray_num"] = rays
    cfg["tpu"]["occ_resolution"] = 16
    return cell, cfg


def test_by_hand():
    cell, cfg = _cfg(2)
    # 2 rays, 16 levels: sites 2*(16+4) + 2*4 + 2 with 4, 2, 4 channels.
    # Levels 0-4 (16^3 .. 28^3 corners) fit their 2^15-row tables: the
    # packed launch reads an index and 8 corners of C f32 a site and level
    # and writes their 59,192 rows 8*C wide; the other 11 levels' launch
    # reads an index and C f32 a site, corner and level and writes rows
    # 59,192 to 419,640 C wide.
    sites = [(40, 4), (8, 2), (2, 4)]
    assert roof.encodes(cfg) == sites
    assert roof.active_levels(cfg, cell["epoch"]) == 16
    assert roof.packed_levels(cfg, 16) == 5
    total = 0
    for s, c in sites:
        total += 5 * s * 4 + 5 * s * 8 * c * 4 + 59192 * 8 * c * 4
        total += 11 * 8 * s * 4 + 11 * 8 * s * c * 4 \
            + (419640 - 59192) * c * 4
    assert roof.real_step_bytes(cfg, cell) == total
    from benchmark import inputs
    sds = inputs.load_cell("snoopy_sds.e300")
    sds_cfg = inputs.run_config(sds)
    assert roof.active_levels(sds_cfg, sds["epoch"]) == 10
    assert roof.packed_levels(sds_cfg, 10) == 5
    sds_cfg["tpu"]["vjp_mode"] = "mxu_rows"
    assert roof.packed_levels(sds_cfg, 10) == 0


def ports_calls(cell, cfg) -> list:
    """The level_histogram calls of one chained real step of the port at
    the cell's point, on the CPU."""
    from morpheus_tpu_torch.data.dataset import DeformDataset
    from morpheus_tpu_torch.ops import hashgrid, hist
    from morpheus_tpu_torch.train.trainer import Trainer

    from benchmark import inputs
    calls = []
    orig = hist.level_histogram

    def rec(idx, vals, starts, n_rows, round_bf16=False):
        calls.append({"idx": tuple(idx.shape), "vals": tuple(vals.shape),
                      "starts": tuple(int(x) for x in starts),
                      "n_rows": int(n_rows)})
        assert idx.dtype == torch.int32
        assert vals.dtype == torch.float32 and round_bf16
        return orig(idx, vals, starts, n_rows, round_bf16=round_bf16)
    hashgrid.level_histogram = rec
    try:
        t = Trainer(cfg, DeformDataset(cfg, scene=inputs.make_scene(cfg)),
                    device="cpu", seed=3)
        t.epoch, t.global_step = cell["epoch"], cell["step"] + 1
        t._set_levels(t._active_levels())
        t.chained_real_step(t.epoch)
    finally:
        hashgrid.level_histogram = orig
    return calls


def launch_key(x):
    return x["idx"], x["vals"], x["starts"], x["n_rows"]


@pytest.mark.parametrize("rays", [16, 48])
def test_launches_match_the_ports_calls(rays):
    """Every launch's index, payload, level starts and table rows as the
    port makes them in a real step, and the rows the count writes lie in
    the launch's levels."""
    cell, cfg = _cfg(rays)
    calls = ports_calls(cell, cfg)
    predicted = roof.launches(cfg, cell)
    assert sorted(map(launch_key, calls)) == sorted(map(launch_key,
                                                         predicted))
    offs = roof._grid(cfg).offsets
    for x in predicted:
        first = offs.index(x["starts"][0])
        assert x["written"] == offs[first + x["idx"][0]] - x["starts"][0]
        assert x["starts"][0] + x["written"] <= x["n_rows"]


def test_exact_step_encodes_every_site():
    """Without budgets (snoopy_exact, the exact tiny harness's cell): every
    marched slot with a smoothness site at each, the band ladder's two
    normals at every rung, one surface point a ray; the launches as the
    port makes them, the active levels (11 at epoch 700) rounded up to the
    12 that the port's graph launches."""
    from harness_exact_tiny import exact_tiny
    cell, cfg = exact_tiny()
    N, K = cfg["train"]["real_ray_num"], cfg["tpu"]["max_samples_per_ray"]
    assert cfg["tpu"]["sample_budget"] == cfg["tpu"]["band_budget"] == 0
    assert roof.encodes(cfg) == [(2 * K * N, 4), (11 * N, 2), (11 * N, 2),
                                 (N, 4)]
    assert roof.active_levels(cfg, cell["epoch"]) == 11
    assert roof.launched_levels(cfg, cell["epoch"]) == 12
    calls = ports_calls(cell, cfg)
    sites = sorted((c["idx"][1] // 8, c["vals"][1]) for c in calls
                   if c["idx"][0] == 12 - roof.packed_levels(cfg, 12))
    assert sites == sorted(roof.encodes(cfg))
    assert sorted(map(launch_key, calls)) == sorted(
        map(launch_key, roof.launches(cfg, cell)))
