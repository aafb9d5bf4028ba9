"""What a run hands to the program and to the reference alike, made from the
run's seed: the config of the cell, the synthetic scene, the field's
initial parameters and the Zero123 weights. Nothing is read from the
program or downloaded; the weights are made on the device in a few large
draws."""
from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SECTIONS = ("data", "exp", "render", "train", "model", "guidance", "tpu")


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


def zero123_spec(cell: dict):
    """The Zero123 widths of the cell's configuration (or the cell's own
    "zero123_spec", as a test's tiny cell gives)."""
    from .reference.guidance.zero123 import Zero123Spec
    s = dict(cell.get("zero123_spec")
             or load_config_file(cell["config"])["zero123_spec"])
    for k in ("unet_mult", "vae_mult"):
        s[k] = tuple(s[k])
    return Zero123Spec(**s)


def _init_plan(g) -> dict:
    """name -> ("normal", std) | ("const", value) for every weight of the
    guidance module `g` (on the meta device): lecun-normal kernels, zero
    biases, unit norms, N(0, 0.02) CLIP embeddings and cc_projection, and
    zero weights where ldm starts at zero (each ResBlock's last conv, each
    SpatialTransformer's proj_out, the UNet's output conv)."""
    from torch import nn

    from .reference.guidance import clip_vit
    from .reference.guidance.layers import ResBlock, SpatialTransformer
    zero = {id(m.out_layers[3]) for m in g.modules()
            if isinstance(m, ResBlock)}
    zero |= {id(m.proj_out) for m in g.modules()
             if isinstance(m, SpatialTransformer)}
    zero.add(id(g.unet.out[2]))
    plan = {}
    names = {id(p): n for n, p in g.named_parameters()}
    for m in g.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            plan[names[id(m.weight)]] = (("const", 0.0) if id(m) in zero
                                         else ("normal", fan_in ** -0.5))
            if m.bias is not None:
                plan[names[id(m.bias)]] = ("const", 0.0)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            plan[names[id(m.weight)]] = ("const", 1.0)
            plan[names[id(m.bias)]] = ("const", 0.0)
        elif isinstance(m, clip_vit._Attention):
            plan[names[id(m.in_proj_weight)]] = (
                "normal", m.in_proj_weight.shape[1] ** -0.5)
            plan[names[id(m.in_proj_bias)]] = ("const", 0.0)
    for p in (g.clip.class_embedding, g.clip.positional_embedding,
              g.clip.proj, g.cc_projection.weight):
        plan[names[id(p)]] = ("normal", 0.02)
    missing = set(names.values()) - set(plan)
    if missing:
        raise AssertionError(f"no init for {sorted(missing)[:4]}")
    return plan


def zero123_state(spec, seed: int, device) -> dict:
    """An ldm-named state dict of the Zero123 guidance (UNet, VAE, CLIP image
    tower, cc_projection) in float32 on `device`: each of the four parts'
    normal weights are views of one draw of a generator of the seed, scaled
    per tensor; cc_projection starts near the identity on its CLIP part."""
    from .reference.guidance.zero123 import Zero123Guidance
    with torch.device("meta"):
        g = Zero123Guidance(spec)
    plan = _init_plan(g)
    shapes = {n: p.shape for n, p in g.named_parameters()}
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))
    out = {}
    for prefix in ("model.", "first_stage_model.", "cond_stage_model.",
                   "cc_projection."):
        part = [n for n in shapes if n.startswith(prefix)]
        normal = [n for n in part if plan[n][0] == "normal"]
        flat = torch.randn(sum(shapes[n].numel() for n in normal),
                           generator=gen, device=device)
        off = 0
        for n in part:
            kind, v = plan[n]
            if kind == "normal":
                k = shapes[n].numel()
                out[n] = flat[off:off + k].view(shapes[n]).mul_(v)
                off += k
            else:
                out[n] = torch.full(shapes[n], v, device=device)
    cd = spec.context_dim
    w = out["cc_projection.weight"]
    w[:, :cd] += torch.eye(cd, device=device)
    return out
