"""The benchmark's snoopy_exact configuration (MorpheuS as published: every
marched sample, the full band ladder, every smoothness site, the trilinear
occupancy EMA; bf16 cotangents, as every configuration of the benchmark)
on the port, on the CPU at the tiny size of benchmark/tests/harness_tiny.py
with the cell's own march (benchmark/tests/harness_exact_tiny.py):

- the first three steps of set-up's epoch (virtual, real, real) against
  the plain reference (benchmark/reference), through the harness;
- the eager twin of the real step's CUDA graph keeps its sizes fixed and
  reads nothing back to the host, whatever the occupancy grid holds: N*K
  samples and P*N ladder rungs a step;
- the span render.band and the band.* counters against a hand count of
  the epoch's in-band rungs, and the budgeted cells' reuse form inside the
  same span.
"""
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, inputs
from benchmark.tests.harness_exact_tiny import exact_knobs, exact_tiny
from benchmark.tests.harness_tiny import metrics, tiny
from morpheus_tpu_torch import renderer, trace
from morpheus_tpu_torch.utils import Draws
from torch_dp_ranks import NoHostRead

SEED = 2 ** 31 + 4242


def program(cell, cfg, seed=SEED, guided=True):
    """The port's trainer at the cell's point, as a run's set-up builds it
    (harness.build_program), from the seed's inputs."""
    scene = inputs.make_scene(cfg)
    fstate = inputs.field_state(cfg, scene["num_frames"], 1.01, seed, "cpu")
    zstate = zfields = None
    if guided:
        import dataclasses
        zspec = inputs.zero123_spec(cell)
        zfields = dataclasses.asdict(zspec)
        zstate = inputs.zero123_state(zspec, seed, "cpu")
    else:
        cfg["guidance"]["model"] = []
    return harness.build_program(cell, cfg, scene, fstate, zstate, seed,
                                 "cpu", zfields)


def test_exact_cell_matches_the_reference():
    cell, cfg = exact_tiny()
    knobs = exact_knobs()
    del knobs["grad_payload"]           # bf16, as in every configuration
    assert {k: cfg["tpu"][k] for k in knobs} == knobs
    r = harness.run_cell(cell, SEED, 0.1, False, "cpu", cfg=cfg,
                         metrics=metrics())
    assert r["correct"], r["compared"]
    assert r["device"]["platform"] == "cpu"
    for k, v in r["compared"].items():
        # the same operations in float32 (benchmark/tests/
        # test_harness_reference.py's bound)
        assert v["value"] <= 1e-4, (k, v)
    assert r["attempted"] > 0 and r["failed"] == 0


def _grids(occ):
    """Occupancy grids of every kind: never refreshed (all occupied), a
    random tenth of the cells, one cell, and every cell over the
    threshold."""
    n = occ.occs.numel()
    gen = torch.Generator().manual_seed(5)
    sparse = torch.where(torch.rand(n, generator=gen) < 0.1, 1.0, 0.0)
    one = torch.zeros(n)
    one[n // 2 + occ.binaries.shape[0] ** 2 // 2] = 1.0
    return {"initial": torch.zeros(n), "tenth": sparse, "one": one,
            "full": torch.ones(n)}


def test_real_body_keeps_fixed_sizes_and_reads_nothing_back():
    cell, cfg = exact_tiny()
    tr = program(cell, cfg, guided=False)
    tr._set_levels(tr._active_levels())
    tr.scalars.set(tr.epoch)
    N, K = cfg["train"]["real_ray_num"], cfg["tpu"]["max_samples_per_ray"]
    P = int(cfg["train"]["trunc"] * 100 + 1)
    valid = {}
    for name, occs in _grids(tr.occ).items():
        tr.occ.occs.copy_(occs)         # the march reads occs alone
        trace.reset()
        with NoHostRead():
            loss = tr._real_body()
        got = trace.read()
        assert got["real.samples_slots"] == N * K, name
        assert got["band.samples_slots"] == P * N, name
        assert torch.isfinite(loss), name
        valid[name] = got["real.samples_valid"]
    # the grids do reach the march: the same slots, other samples in them
    assert valid["initial"] == valid["full"]
    assert valid["one"] < valid["tenth"] < valid["initial"]


def test_band_span_and_counters_count_the_in_band_rungs(monkeypatch):
    cell, cfg = exact_tiny()
    tr = program(cell, cfg)
    calls, jitter = [], []
    band = renderer._surface_band_normal_smoothness
    uniform = Draws.uniform

    def rec_band(field, draws, rays_o, rays_d, rays_t, depth, rcfg, *a):
        calls.append((rays_o.detach().clone(), rays_d.detach().clone(),
                      depth.detach().clone()))
        return band(field, draws, rays_o, rays_d, rays_t, depth, rcfg, *a)

    def rec_uniform(self, name, shape):
        v = uniform(self, name, shape)
        if name == "ladder_jitter":
            jitter.append(v.clone())
        return v
    monkeypatch.setattr(renderer, "_surface_band_normal_smoothness",
                        rec_band)
    monkeypatch.setattr(Draws, "uniform", rec_uniform)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_one_epoch()
    got = trace.read()
    steps = cfg["train"]["n_iters"] * (cfg["train"]["virtual_freq"]
                                       + cfg["train"]["real_freq"])
    spans = {e.key: e.count for e in prof.key_averages()}
    assert spans.get("render.band") == steps == len(calls) == len(jitter)

    trunc, radius = cfg["train"]["trunc"], 1.1
    P = int(trunc * 100 + 1)
    inside = slots = 0
    for (o, d, depth), jit in zip(calls, jitter):
        o, d, depth = (x.double().numpy() for x in (o, d, depth))
        for p in range(P):
            rung = -0.5 * trunc + trunc * p / (P - 1) + 0.01 * float(jit[p])
            x = o + (depth + rung)[:, None] * d
            inside += int((np.linalg.norm(x, axis=-1) < radius).sum())
        slots += P * depth.shape[0]
    assert got["band.samples_slots"] == slots
    assert got["band.samples_valid"] == inside
    # the ladder meets the surface on some rays and misses it on others
    assert 0 < inside < slots


def test_reuse_form_opens_the_same_span(monkeypatch):
    """The budgeted cells' reuse form runs inside render.band too, and
    fills the counters over its sample stream."""
    cell, cfg = tiny("snoopy_sds.e300")
    tr = program(cell, cfg, guided=False)
    seen = []
    reuse = renderer._band_reuse_normal_smoothness

    def rec(*a):
        seen.append(a[5].numel())           # the samples' valid mask
        return reuse(*a)
    monkeypatch.setattr(renderer, "_band_reuse_normal_smoothness", rec)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_one_epoch()
    spans = {e.key: e.count for e in prof.key_averages()}
    assert spans.get("render.band") == len(seen) > 0
    assert trace.read()["band.samples_slots"] == sum(seen)
