"""The harness's run on the CPU at a tiny size: the port's first steps
against the plain reference (the same numbers to round-off), each fault of
the timed path that a training cell can have comes out not correct, and
nothing is written under a device metric."""
import pytest

from harness_tiny import metrics, tiny

CELLS = ["snoopy_sds.e1900", "snoopy_sds.e300"]
SEED = 2 ** 31 + 12345


def run(name, seed=SEED):
    from benchmark import harness
    cell, cfg = tiny(name)
    return harness.run_cell(cell, seed, 0.1, True, "cpu", cfg=cfg,
                            metrics=metrics())


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name):
    r = run(name)
    assert r["correct"], r["compared"]
    for k, v in r["compared"].items():
        # the same operations in float32; the port's packed dense prefix
        # sums the same terms in another order
        assert v["value"] <= 1e-4, (k, v)
    assert r["device"]["platform"] == "cpu"
    assert r["attempted"] > 0 and r["failed"] == 0
    # a CPU run is never written under a device metric
    assert not set(r["metrics"]) & {"idle_share", "real_step.device_ms",
                                    "sds_step.device_ms",
                                    "sds_render.device_ms", "mfu",
                                    "level_histogram_roofline",
                                    "peak_mem_gib"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    from benchmark.readings import FAULTS
    with FAULTS[fault]():
        r = run(name)
    assert not r["correct"], r["compared"]
