"""Parameter bridge between the JAX package's `init_field` tree
(morpheus_tpu/model/field.py:135-164) and the port's `Field` state dict,
between the JAX package's Zero123Guidance leaves and the port's guidance
state dict (guidance_from_jax), between the JAX CLIP eval tower's params
and the port's (clip_visual_from_jax), and the reader of the JAX package's
checkpoints.

JAX MLPs are {"w": [(in, out), ...], "b": [(out,), ...]}; the port's
nn.Linear weight is (out, in), so weights are transposed both ways. Code
tables (lists) become numbered entries. The input tree holds numpy arrays
(np.asarray of the JAX leaves); nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> Field state dict."""
    state = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            for l, (w, b) in enumerate(zip(value["w"], value["b"])):
                state[f"{key}.layers.{l}.weight"] = _t(np.asarray(w).T)
                state[f"{key}.layers.{l}.bias"] = _t(b)
        elif isinstance(value, (list, tuple)):
            for i, a in enumerate(value):
                state[f"{key}.{i}"] = _t(a)
        else:
            state[key] = _t(value)
    return state


def params_to_jax(state) -> dict:
    """Field state dict (or Field) -> JAX-layout tree of numpy arrays."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    tree: dict = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        parts = name.split(".")
        if len(parts) == 4 and parts[1] == "layers":       # key.layers.l.x
            mlp = tree.setdefault(parts[0], {"w": [], "b": []})
            l = int(parts[2])
            lst = mlp["w" if parts[3] == "weight" else "b"]
            lst.extend([None] * (l + 1 - len(lst)))
            lst[l] = a.T.copy() if parts[3] == "weight" else a
        elif len(parts) == 2:                              # key.i
            lst = tree.setdefault(parts[0], [])
            i = int(parts[1])
            lst.extend([None] * (i + 1 - len(lst)))
            lst[i] = a
        else:
            tree[name] = a
    return tree


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


class _AdamState(NamedTuple):
    """Stand-in for morpheus_tpu.train.optim.AdamState in a JAX pickle."""
    step: object
    mu: dict
    nu: dict


class _AdanState(NamedTuple):
    """Stand-in for morpheus_tpu.train.optim.AdanState in a JAX pickle."""
    step: object
    m: dict
    v: dict
    n: dict
    prev_grad: dict


class _OccupancyState(NamedTuple):
    """Stand-in for morpheus_tpu.ops.occupancy.OccupancyState."""
    occs: object
    binaries: object


class _JaxCkptUnpickler(pickle.Unpickler):
    """Reads a JAX `model_ep_*.pkl` without importing JAX or the JAX
    package: its NamedTuple classes (an optimizer state, Adam's or Adan's,
    and the occupancy state) map to the stand-ins above, numpy's classes
    load as usual, and every other class is refused."""

    STAND_INS = {("morpheus_tpu.train.optim", "AdamState"): _AdamState,
                 ("morpheus_tpu.train.optim", "AdanState"): _AdanState,
                 ("morpheus_tpu.ops.occupancy", "OccupancyState"):
                     _OccupancyState}

    def find_class(self, module, name):
        if (module, name) in self.STAND_INS:
            return self.STAND_INS[(module, name)]
        if module.split(".")[0] != "numpy":
            raise pickle.UnpicklingError(
                f"refusing {module}.{name} in a JAX checkpoint")
        return super().find_class(module, name)


def _named(tree: dict) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def load_jax_ckpt(path: str) -> dict:
    """A JAX `model_ep_*.pkl` (morpheus_tpu/train/trainer.py:921-955) as
    the port's checkpoint dict (train/trainer.py Trainer.state_dict), for
    Trainer.load_state_dict. The JAX run's PRNG key has no counterpart in
    the port's draws and is left out; the virtual-step gradients it carries
    (pending_grads) and its host step come across."""
    with open(path, "rb") as f:
        payload = _JaxCkptUnpickler(f).load()
    st = payload["state"]
    opt = st["opt_state"]
    name = "adan" if isinstance(opt, _AdanState) else "adam"
    return {
        "params": _named(st["params"]),
        "optim": {"name": name, "step": float(np.asarray(opt.step)),
                  **{k: _named(v) for k, v in opt._asdict().items()
                     if k != "step"}},
        "ema": _named(st["ema"]),
        "occ": {"occs": np.asarray(st["occ"].occs),
                "binaries": np.asarray(st["occ"].binaries)},
        "global_step": int(np.asarray(st["global_step"])),
        "epoch": int(payload["epoch"]),
        "draws": None,
        "host_step": int(payload.get("host_step", 0)),
        "pending_grads": (None if st.get("pending_grads") is None
                          else _named(st["pending_grads"])),
    }


# ---- Zero123 guidance (inverse of morpheus_tpu/guidance/convert.py) --------

def _leaf(out: dict, prefix: str, d: dict) -> None:
    """One flax module's parameters as torch names under `prefix`: a Dense
    kernel (in, out) becomes weight (out, in), a Conv kernel (kh, kw, in,
    out) weight (out, in, kh, kw), a norm's scale its weight;
    GroupNorm32's inner 'norm' is flattened."""
    if "norm" in d and isinstance(d["norm"], dict):
        return _leaf(out, prefix, d["norm"])
    if "kernel" in d:
        k = np.asarray(d["kernel"])
        out[f"{prefix}.weight"] = (k.T if k.ndim == 2
                                   else k.transpose(3, 2, 0, 1))
    if "scale" in d:
        out[f"{prefix}.weight"] = np.asarray(d["scale"])
    if "bias" in d:
        out[f"{prefix}.bias"] = np.asarray(d["bias"])


def _res_block(out, p, d):
    for flax, port in (("in_norm", "in_layers.0"), ("in_conv", "in_layers.2"),
                       ("emb_proj", "emb_layers.1"),
                       ("out_norm", "out_layers.0"),
                       ("out_conv", "out_layers.3"),
                       ("skip", "skip_connection")):
        if flax in d:
            _leaf(out, f"{p}.{port}", d[flax])


def _spatial_transformer(out, p, d):
    for n in ("norm", "proj_in", "proj_out"):
        _leaf(out, f"{p}.{n}", d[n])
    for name, blk in d.items():
        if not name.startswith("block_"):
            continue
        b = f"{p}.transformer_blocks.{name[len('block_'):]}"
        for n in ("norm1", "norm2", "norm3"):
            _leaf(out, f"{b}.{n}", blk[n])
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _leaf(out, f"{b}.{a}.{n}", blk[a][n])
            _leaf(out, f"{b}.{a}.to_out.0", blk[a]["to_out"])
        _leaf(out, f"{b}.ff.net.0.proj", blk["ff"]["geglu"]["proj"])
        _leaf(out, f"{b}.ff.net.2", blk["ff"]["out"])


def _unet_from_jax(out, p, spec):
    P = "model.diffusion_model."
    mult = tuple(spec.unet_mult)
    _leaf(out, f"{P}time_embed.0", p["time_embed_0"])
    _leaf(out, f"{P}time_embed.2", p["time_embed_2"])
    _leaf(out, f"{P}input_blocks.0.0", p["input_conv"])
    _leaf(out, f"{P}out.0", p["out_norm"])
    _leaf(out, f"{P}out.2", p["out_conv"])
    idx = 1
    for level in range(len(mult)):
        for nr in range(2):
            _res_block(out, f"{P}input_blocks.{idx}.0",
                       p[f"in_{level}_{nr}_res"])
            if f"in_{level}_{nr}_attn" in p:
                _spatial_transformer(out, f"{P}input_blocks.{idx}.1",
                                     p[f"in_{level}_{nr}_attn"])
            idx += 1
        if level != len(mult) - 1:
            _leaf(out, f"{P}input_blocks.{idx}.0.op", p[f"down_{level}"]["conv"])
            idx += 1
    _res_block(out, f"{P}middle_block.0", p["mid_res1"])
    _spatial_transformer(out, f"{P}middle_block.1", p["mid_attn"])
    _res_block(out, f"{P}middle_block.2", p["mid_res2"])
    idx = 0
    for level in reversed(range(len(mult))):
        for nr in range(3):
            _res_block(out, f"{P}output_blocks.{idx}.0",
                       p[f"out_{level}_{nr}_res"])
            sub = 1
            if f"out_{level}_{nr}_attn" in p:
                _spatial_transformer(out, f"{P}output_blocks.{idx}.1",
                                     p[f"out_{level}_{nr}_attn"])
                sub = 2
            if f"up_{level}" in p and nr == 2:
                _leaf(out, f"{P}output_blocks.{idx}.{sub}.conv",
                      p[f"up_{level}"]["conv"])
            idx += 1


def _vae_block(out, p, d):
    for n in ("norm1", "conv1", "norm2", "conv2", "nin_shortcut", "norm",
              "q", "k", "v", "proj_out"):
        if n in d:
            _leaf(out, f"{p}.{n}", d[n])


def _vae_from_jax(out, p, spec):
    P = "first_stage_model."
    for side in ("encoder", "decoder"):
        d = p[side]
        for n in ("conv_in", "norm_out", "conv_out"):
            _leaf(out, f"{P}{side}.{n}", d[n])
        for n, port in (("mid_block_1", "mid.block_1"),
                        ("mid_attn_1", "mid.attn_1"),
                        ("mid_block_2", "mid.block_2")):
            _vae_block(out, f"{P}{side}.{port}", d[n])
    enc, dec = p["encoder"], p["decoder"]
    for level in range(len(spec.vae_mult)):
        for nr in range(spec.vae_res_blocks):
            _vae_block(out, f"{P}encoder.down.{level}.block.{nr}",
                       enc[f"down_{level}_block_{nr}"])
        if f"down_{level}_downsample" in enc:
            _leaf(out, f"{P}encoder.down.{level}.downsample.conv",
                  enc[f"down_{level}_downsample"])
        for nr in range(spec.vae_res_blocks + 1):
            _vae_block(out, f"{P}decoder.up.{level}.block.{nr}",
                       dec[f"up_{level}_block_{nr}"])
        if f"up_{level}_upsample" in dec:
            _leaf(out, f"{P}decoder.up.{level}.upsample.conv",
                  dec[f"up_{level}_upsample"])
    _leaf(out, f"{P}quant_conv", p["quant_conv"])
    _leaf(out, f"{P}post_quant_conv", p["post_quant_conv"])


def _clip_from_jax(out, p, layers: int,
                   P: str = "cond_stage_model.model.visual."):
    out[f"{P}conv1.weight"] = np.asarray(
        p["conv1"]["kernel"]).transpose(3, 2, 0, 1)
    for n in ("class_embedding", "positional_embedding", "proj"):
        out[P + n] = np.asarray(p[n])
    _leaf(out, f"{P}ln_pre", p["ln_pre"])
    _leaf(out, f"{P}ln_post", p["ln_post"])
    for i in range(layers):
        d, b = p[f"resblock_{i}"], f"{P}transformer.resblocks.{i}"
        _leaf(out, f"{b}.ln_1", d["ln_1"])
        _leaf(out, f"{b}.ln_2", d["ln_2"])
        a = d["attn"]
        # the q, k, v rows of the fused in_proj (convert_clip_visual splits
        # them the other way)
        out[f"{b}.attn.in_proj_weight"] = np.concatenate(
            [np.asarray(a[n]["kernel"]).T
             for n in ("q_proj", "k_proj", "v_proj")], 0)
        out[f"{b}.attn.in_proj_bias"] = np.concatenate(
            [np.asarray(a[n]["bias"]) for n in ("q_proj", "k_proj",
                                                "v_proj")], 0)
        _leaf(out, f"{b}.attn.out_proj", a["out_proj"])
        _leaf(out, f"{b}.mlp.c_fc", d["mlp_fc"])
        _leaf(out, f"{b}.mlp.c_proj", d["mlp_proj"])


def clip_visual_from_jax(params: dict, layers: int
                         ) -> dict[str, torch.Tensor]:
    """The JAX package's CLIP tower parameters (clip_vit's flax tree, as
    ImageEncoder.params holds it, numpy leaves) with `layers` residual
    blocks -> the port's CLIPVisionTransformer state dict (float32)."""
    out: dict = {}
    _clip_from_jax(out, params, layers, P="")
    return {k: _t(v) for k, v in out.items()}


def guidance_from_jax(g, spec) -> dict[str, torch.Tensor]:
    """The JAX package's Zero123Guidance (its unet_params, vae_params,
    clip_params, cc_w and cc_b, as numpy) -> the port's Zero123Guidance
    state dict under ldm's names (float32). `spec` is the port's
    Zero123Spec of the same architecture. The inverse of the JAX
    convert_unet, convert_vae and convert_clip_visual: NHWC conv kernels
    become NCHW ones, Dense kernels are transposed, CLIP's q, k, v become
    one in_proj_weight."""
    out: dict = {}
    _unet_from_jax(out, g.unet_params, spec)
    _vae_from_jax(out, g.vae_params, spec)
    if g.clip_params:
        _clip_from_jax(out, g.clip_params, spec.clip_layers)
    out["cc_projection.weight"] = np.asarray(g.cc_w).T
    out["cc_projection.bias"] = np.asarray(g.cc_b)
    return {k: _t(v) for k, v in out.items()}
