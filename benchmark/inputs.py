"""What a run hands to the program and to the reference alike, made from the
run's seed: the config of the cell, the synthetic scene, the field's
initial parameters and the weights of the configuration's SDS prior, whose
file (PRIORS/<kind>.py) is found by the kind's name. Nothing is read from
the program or downloaded; the weights are made on the device in a few
large draws."""
from __future__ import annotations

import copy
import importlib.util
import json
import os
import re

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SECTIONS = ("data", "exp", "render", "train", "model", "guidance", "tpu")
# the SDS priors' files, one a kind
PRIORS = os.path.join(HERE, "guidance")


def load_cell(name: str) -> dict:
    """The cell's file, benchmark/workloads/<name>.json."""
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as f:
        cell = json.load(f)
    cell["name"] = name
    return cell


def load_config_file(name: str) -> dict:
    """The configuration's file, benchmark/configs/<name>.json, whole."""
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def run_config(cell: dict) -> dict:
    """The config as the cell runs it: the configuration's sections, the
    cell's route as tpu.vjp_mode."""
    whole = load_config_file(cell["config"])
    cfg = copy.deepcopy({k: whole[k] for k in SECTIONS})
    cfg["tpu"]["vjp_mode"] = cell["route"]
    return cfg


def sub_seed(seed: int, k: int) -> int:
    """The k-th seed drawn from the run's seed (any whole number)."""
    return int(np.random.SeedSequence([int(seed), k]).generate_state(
        1, np.uint64)[0] >> 1)


def make_scene(cfg: dict) -> dict:
    """The synthetic deforming sphere at the config's frames and size."""
    from .reference.synthetic import make_synthetic_scene
    d = cfg["data"]
    res = int(d["synthetic_res"])
    return make_synthetic_scene(num_frames=int(d["synthetic_frames"]),
                                H=res, W=res)


def field_state(cfg: dict, num_frames: int, bound: float, seed: int,
                device) -> dict:
    """The field's initial parameters by name: the port's init recipe
    (reference/field.py reset_parameters) from a generator on `device`."""
    from .reference.field import Field
    from .reference.step import field_spec
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    field = Field(field_spec(cfg, num_frames, bound), device)
    field.reset_parameters(gen)
    return {k: v.detach() for k, v in field.state_dict().items()}


def prior_kind(cfg: dict) -> str:
    """The kind of the configuration's SDS prior: its guidance.model[0]."""
    kind = cfg["guidance"]["model"][0]
    if not re.fullmatch(r"[A-Za-z0-9_]+", kind):
        raise ValueError(f"guidance.model: {kind!r} is no prior's name")
    return kind


def load_prior(kind: str):
    """PRIORS/<kind>.py, the SDS prior of that kind, loaded by path as
    harness.load_reader loads a metric's reader. A prior's file gives:

    - spec(fields), TINY_SPEC: its widths, a dataclass whose fields the
      configuration's "<kind>_spec" lists, and those of the CPU tests;
    - state(spec, seed, device): its weights by name, from a generator of
      `seed` (prior_state hands it the run's sub_seed(seed, 2));
    - program(state, fields, device): the port's guidance from them;
    - reference(state, spec, device), release(g): the reference's guidance,
      cast as the configuration states, and what the reference frees once
      its set-up has made the conditioning;
    - conditioning(ref), views(ref, epoch), loss(ref, batch, out, epoch):
      the reference's parts of the SDS step (reference/step.py's
      ReferenceTrainer `ref` renders `batch`, the views' rays, into `out`),
      which take the port's draws in the port's order.
    """
    path = os.path.join(PRIORS, f"{kind}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"guidance.model names the prior {kind!r}, "
                                f"and {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.guidance.{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prior_spec(cell: dict, kind: str):
    """The prior's widths: the cell's own "<kind>_spec", as a test's tiny
    cell gives, or its configuration's."""
    fields = (cell.get(f"{kind}_spec")
              or load_config_file(cell["config"])[f"{kind}_spec"])
    return load_prior(kind).spec(fields)


def prior_state(kind: str, spec, seed: int, device) -> dict:
    """The prior's weights by name on `device`, from the run's seed."""
    return load_prior(kind).state(spec, sub_seed(seed, 2), device)


def __getattr__(name: str):
    """inputs.<kind>_spec(cell) and inputs.<kind>_state(spec, seed, device),
    prior_spec and prior_state under the kind's name, for callers that name
    the kind (tests/test_torch_exact_config.py)."""
    kind, _, what = name.rpartition("_")
    if kind and what == "spec":
        return lambda cell: prior_spec(cell, kind)
    if kind and what == "state":
        return lambda spec, seed, device: prior_state(kind, spec, seed,
                                                      device)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
