"""No module that a run of the harness loads has the top-level name jax,
jaxlib, flax or morpheus_tpu (compared whole: morpheus_tpu_torch is the
program), and the reference loads nothing of the program."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "morpheus_tpu"}


def _modules(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.path.join(ROOT, "benchmark", "tests"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json;"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_reference_loads_neither_jax_nor_the_program():
    tops = _modules(
        "import benchmark.reference.step, benchmark.reference.guidance."
        "zero123, benchmark.inputs, benchmark.compare\n"
        "from benchmark.rooflines import level_histogram\n"
        "benchmark.inputs.load_prior('zero123')")
    assert not tops & FORBIDDEN
    assert "morpheus_tpu_torch" not in tops


def test_a_run_loads_no_jax():
    tops = _modules(
        "from benchmark import harness\n"
        "from harness_tiny import tiny, metrics\n"
        "cell, cfg = tiny('snoopy_sds.e300')\n"
        "r = harness.run_cell(cell, 7, 0.1, True, 'cpu', cfg=cfg, "
        "metrics=metrics())\n"
        "assert r['correct']\n"
        "import benchmark.run\n"
        "assert not harness.forbidden_modules()")
    assert "morpheus_tpu_torch" in tops
    assert not tops & FORBIDDEN
