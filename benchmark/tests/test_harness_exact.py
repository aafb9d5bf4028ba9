"""The snoopy_exact configuration and its cell snoopy_exact.e700 in the
harness, on the CPU: each planted fault of the timed path reads not
correct at the tiny size (tests/test_torch_exact_config.py holds the sound
cell against the plain reference), and the configuration is snoopy_sds
with the published method's knobs but its f32 gradient payload."""
import json
import os

import pytest

from harness_exact_tiny import exact_knobs, exact_tiny
from harness_tiny import metrics

SEED = 2 ** 31 + 777
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_is_not_correct(fault):
    from benchmark import harness
    from benchmark.readings import FAULTS
    cell, cfg = exact_tiny()
    with FAULTS[fault]():
        r = harness.run_cell(cell, SEED, 0.1, True, "cpu", cfg=cfg,
                             metrics=metrics())
    assert not r["correct"], r["compared"]


def test_config_is_snoopy_sds_with_the_exact_knobs():
    def load(name):
        with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
            return json.load(f)
    sds, exact = load("snoopy_sds"), load("snoopy_exact")
    assert set(sds) == set(exact)
    differ = {k for k in sds if sds[k] != exact[k]}
    assert differ == {"source", "about", "assumed", "tpu"}
    assert exact["reduced"] == []
    assert exact["source"].startswith(sds["source"] + " ")
    assert "morpheus.py semantics" in exact["source"]
    assert "ab_exact.yaml" in exact["about"]
    assert set(sds["assumed"].items()) <= set(exact["assumed"].items())
    # the payload stays the bf16 that benchmark/tests/test_harness_cells.py
    # asks of every configuration
    knobs = exact_knobs()
    assert knobs.pop("grad_payload") == "float32"
    assert exact["tpu"]["grad_payload"] == sds["tpu"]["grad_payload"] \
        == "bfloat16"
    tpu = {k for k in set(sds["tpu"]) | set(exact["tpu"])
           if sds["tpu"].get(k) != exact["tpu"].get(k)}
    assert tpu == set(knobs)
    assert {k: exact["tpu"][k] for k in knobs} == knobs
