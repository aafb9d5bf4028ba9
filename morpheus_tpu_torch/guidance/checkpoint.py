"""Loading a Zero123 checkpoint (the counterpart of
morpheus_tpu/guidance/convert.py:225-323 for the port).

A real 105000.ckpt is a lightning dict whose 'state_dict' holds ldm's
LatentDiffusion names. The port's Zero123Guidance carries those names, so
loading is by name: the keys under model.diffusion_model.,
first_stage_model., cond_stage_model.model.visual. and cc_projection. load
as they are (as float32), LitEma's model_ema.* copies (dots stripped)
override the live UNet weights as the reference does
(zero123_utils.py:39-44), and every other key must be one the model does
not need (the DDPM schedule buffers, the CLIP text tower's leftovers, the
EMA's counters) or the load fails.
"""
from __future__ import annotations

import torch

from ..utils import resolve_device
from .zero123 import Zero123Guidance, Zero123Spec, cast_for_compute

PREFIXES = ("model.diffusion_model.", "first_stage_model.",
            "cond_stage_model.model.visual.", "cc_projection.")

# DDPM's schedule buffers (ddpm.py:145-165, :520): the schedule is
# recomputed from the spec
SCHEDULE_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "logvar", "scale_factor",
)
# FrozenCLIPImageEmbedder deletes only the text transformer
# (modules.py:355-357); these text-side weights stay in the checkpoint
CLIP_TEXT_LEFTOVERS = (
    "cond_stage_model.model.positional_embedding",
    "cond_stage_model.model.text_projection",
    "cond_stage_model.model.logit_scale",
    "cond_stage_model.model.token_embedding.weight",
    "cond_stage_model.model.ln_final.weight",
    "cond_stage_model.model.ln_final.bias",
)
EMA_COUNTERS = ("model_ema.decay", "model_ema.num_updates")


def ema_name(key: str) -> str:
    """LitEma's name of a live UNet key: 'model.diffusion_model.out.2.bias'
    -> 'model_ema.diffusion_modelout2bias'."""
    return "model_ema." + key[len("model."):].replace(".", "")


def guidance_state(sd: dict, strict: bool = True) -> dict:
    """The guidance's state dict out of an ldm state dict: the live weights
    under PREFIXES, the EMA copy where there is one. strict: every other
    key must be a known leftover (schedule buffer, CLIP text tower, EMA
    counter or an EMA copy that was used), else ValueError."""
    out, used = {}, set()
    for k, v in sd.items():
        if k.startswith(PREFIXES):
            src = k
            if k.startswith("model.diffusion_model.") and ema_name(k) in sd:
                src = ema_name(k)
                used.add(src)
            out[k] = sd[src]
    if strict:
        known = set(SCHEDULE_BUFFERS) | set(CLIP_TEXT_LEFTOVERS) \
            | set(EMA_COUNTERS) | used
        unknown = sorted(k for k in sd
                         if not k.startswith(PREFIXES) and k not in known)
        if unknown:
            raise ValueError(f"{len(unknown)} unknown checkpoint keys, e.g. "
                             f"{unknown[:8]}")
    return out


def from_state_dict(sd: dict, spec: Zero123Spec = Zero123Spec(),
                    device="cuda", strict: bool = True) -> Zero123Guidance:
    """A Zero123Guidance on `device` holding the weights of ldm state dict
    `sd` (values as float32), UNet cast to spec.compute_dtype. Under
    strict, a key the module does not have raises ValueError; missing or
    misshapen weights raise in load_state_dict."""
    state = {k: torch.as_tensor(v).to(torch.float32)
             for k, v in guidance_state(sd, strict).items()}
    with torch.device("meta"):
        g = Zero123Guidance(spec)
    unknown = sorted(set(state) - set(g.state_dict()))
    if strict and unknown:
        raise ValueError(f"{len(unknown)} unknown checkpoint keys, e.g. "
                         f"{unknown[:8]}")
    for k in unknown:
        del state[k]
    g.load_state_dict(state, strict=True, assign=True)
    g.alphas_cumprod = torch.as_tensor(spec.diffusion.alphas_cumprod,
                                       dtype=torch.float32)
    g = g.to(resolve_device(device)).requires_grad_(False)
    return cast_for_compute(g)


def load_zero123_checkpoint(path: str, spec: Zero123Spec = Zero123Spec(),
                            device="cuda", strict: bool = True
                            ) -> Zero123Guidance:
    """Load the reference's 105000.ckpt (torch.save of a lightning dict
    with 'state_dict'; zero123_utils.py:22-54) into a Zero123Guidance on
    `device` (the card unless told otherwise)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:
        raise ValueError(f"{path}: not a readable Zero123 checkpoint "
                         f"({type(e).__name__}: {e})") from e
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a Zero123 checkpoint (a "
                         f"{type(ckpt).__name__}, not a state dict)")
    sd = ckpt.get("state_dict", ckpt)
    return from_state_dict(sd, spec, device, strict)
