"""The manifest and every file it names: each cell, configuration and
metric parses, and each name, unit and line keeps to the benchmark
contract's characters and lengths."""
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_and_limits():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"][1] == \
        "benchmark/run.py"
    assert 1 <= m["run_seconds"] <= 51
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert {"step_ms", "setup_s"} <= set(e2e)
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(m)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_lines(kind):
    m = manifest()
    names = [x["name"] for x in m[kind]]
    assert len(names) == len(set(names))
    for x in m[kind]:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in x:
                assert line_ok(x[k]), (x["name"], k)


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_file(cell):
    from benchmark import inputs
    m = manifest()
    w = next(x for x in m["workloads"] if x["name"] == cell)
    c = inputs.load_cell(cell)
    assert c["config"] == w["config"] and c["chips"] == w["chips"] == 1
    assert NAME.match(w["traffic"]) and line_ok(w["why"])
    assert set(c["limits"]) == {"loss", "grad", "update"}
    assert 0 < min(c["limits"].values())
    cfg = inputs.run_config(c)
    assert cfg["tpu"]["vjp_mode"] == c["route"]
    assert cfg["tpu"]["chain_steps"] is True
    for m_ in m["per_layer"]:
        assert m_["moves"] == "step_ms"
    if c.get("view_scale") is not None:
        d = cfg["data"]
        scale = (d["novel_view_scale_final"] if c["epoch"] > 800
                 else d["novel_view_scale"])
        assert scale == c["view_scale"]


@pytest.mark.parametrize("config", [c["name"] for c in manifest()["configs"]])
def test_config_file(config):
    m = manifest()
    c = next(x for x in m["configs"] if x["name"] == config)
    assert c["file"] == f"benchmark/configs/{config}.json"
    with open(os.path.join(ROOT, c["file"])) as f:
        whole = json.load(f)
    assert whole["reduced"] == c["reduced"] == []
    assert line_ok(c["source"]) and c["source"].startswith("https://")
    for k in ("data", "train", "model", "tpu", "guidance"):
        assert isinstance(whole[k], dict)
    assert whole["tpu"]["grad_payload"] == "bfloat16"
    assert whole["model"].get("grid_num_levels", 16) == 16
    assert whole["train"]["real_ray_num"] == 2048
    # the SDS prior's file, found by its kind's name, takes the widths that
    # the configuration gives under "<kind>_spec"
    from benchmark import inputs
    kind = inputs.prior_kind(whole)
    assert os.path.isfile(os.path.join(HERE, "guidance", f"{kind}.py"))
    assert inputs.load_prior(kind).spec(whole[f"{kind}_spec"])


@pytest.mark.parametrize("metric", [x["name"] for x in manifest()["per_layer"]])
def test_metric_reader(metric):
    from benchmark import harness
    read = harness.load_reader(metric)
    assert callable(read)
    m = next(x for x in manifest()["per_layer"] if x["name"] == metric)
    cells = {w["name"] for w in manifest()["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    assert line_ok(m["layer"])
