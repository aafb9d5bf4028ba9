"""Zero-1-to-3 score-distillation guidance (port of
morpheus_tpu/guidance/zero123.py; reference: models/guidance/
zero123_utils.py).

Zero123Guidance is one nn.Module laid out as ldm's LatentDiffusion state
dict: model.diffusion_model (UNet), first_stage_model (VAE),
cond_stage_model.model.visual (CLIP image tower) and cc_projection, so a
real checkpoint loads by name (checkpoint.py). The functions below are the
JAX module's, taking the guidance first. The UNet runs without gradient
(the reference wraps it in no_grad, zero123_utils.py:177): the SDS gradient
flows through the VAE encoder only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from .. import graphs, trace
from ..utils import resolve_device
from . import clip_vit, schedule, unet, vae
from .layers import ResBlock, SpatialTransformer
from .unet_graph import UNetGraphs


@dataclasses.dataclass(frozen=True)
class Zero123Spec:
    num_train_timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    scale_factor: float = 0.18215
    guidance_scale: float = 5.0
    image_size: int = 256
    # architecture (defaults: the real Zero123 sizes; tests shrink them)
    unet_channels: int = 320
    unet_mult: tuple = (1, 2, 4, 4)
    unet_heads: int = 8
    context_dim: int = 768
    clip_width: int = 1024
    clip_layers: int = 24
    clip_heads: int = 16
    clip_patch: int = 14
    vae_ch: int = 128
    vae_mult: tuple = (1, 2, 4, 4)
    vae_res_blocks: int = 2
    # the UNet's compute type (guidance.compute_dtype): 'bfloat16' casts
    # the UNet's weights once and runs its forward in bfloat16, GroupNorm
    # in float32 (the reference's fp16 autocast of the LDM forward); the
    # differentiable VAE and the render stay float32
    compute_dtype: str = "float32"

    @property
    def diffusion(self) -> schedule.DiffusionSchedule:
        return schedule.DiffusionSchedule(self.num_train_timesteps,
                                          self.linear_start, self.linear_end)

    @property
    def latent_size(self) -> int:
        return self.image_size // 2 ** (len(self.vae_mult) - 1)

    @staticmethod
    def from_ldm_config(path: str) -> "Zero123Spec":
        """The spec from the reference's OmegaConf model yaml
        (guidance.zero123_config; zero123_utils.py:68-81). Architecture
        fields fall back to the Zero123 defaults when absent."""
        import yaml
        with open(path, "r") as f:
            cfg = yaml.safe_load(f)
        p = cfg["model"]["params"]
        un = p.get("unet_config", {}).get("params", {})
        vae_dd = (p.get("first_stage_config", {}).get("params", {})
                  .get("ddconfig", {}))
        return Zero123Spec(
            num_train_timesteps=int(p.get("timesteps", 1000)),
            linear_start=float(p.get("linear_start", 0.00085)),
            linear_end=float(p.get("linear_end", 0.012)),
            scale_factor=float(p.get("scale_factor", 0.18215)),
            image_size=int(vae_dd.get("resolution", 256)),
            unet_channels=int(un.get("model_channels", 320)),
            unet_mult=tuple(un.get("channel_mult", (1, 2, 4, 4))),
            unet_heads=int(un.get("num_heads", 8)),
            context_dim=int(un.get("context_dim", 768)),
            vae_ch=int(vae_dd.get("ch", 128)))


# the "<random-tiny>" guidance of the CLI (morpheus.py:139-142): every layer
# type, small enough to train on the CPU in minutes
TINY_SPEC = Zero123Spec(image_size=64, unet_channels=32, unet_mult=(1, 2),
                        unet_heads=4, context_dim=32, clip_width=64,
                        clip_layers=2, clip_heads=4, clip_patch=14)


class _Holder(nn.Module):
    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            setattr(self, k, v)


class Zero123Guidance(nn.Module):
    """The frozen LatentDiffusion pieces, under ldm's state-dict names, and
    alphas_cumprod (float32, recomputed from the spec, not saved);
    unet_graphs, the CUDA graphs of the UNet's forward (apply_unet)."""

    def __init__(self, spec: Zero123Spec = Zero123Spec()):
        super().__init__()
        self.spec = spec
        cd = spec.context_dim
        self.model = _Holder(diffusion_model=unet.UNetModel(
            model_channels=spec.unet_channels, channel_mult=spec.unet_mult,
            num_heads=spec.unet_heads, context_dim=cd))
        self.first_stage_model = vae.AutoencoderKL(
            ch=spec.vae_ch, ch_mult=spec.vae_mult,
            num_res_blocks=spec.vae_res_blocks)
        self.cond_stage_model = _Holder(model=_Holder(
            visual=clip_vit.CLIPVisionTransformer(
                width=spec.clip_width, layers=spec.clip_layers,
                heads=spec.clip_heads, patch=spec.clip_patch,
                out_dim=cd)))
        self.cc_projection = nn.Linear(cd + 4, cd)
        self.register_buffer("alphas_cumprod", torch.as_tensor(
            spec.diffusion.alphas_cumprod, dtype=torch.float32),
            persistent=False)
        self.requires_grad_(False)
        self.unet_graphs = UNetGraphs(self.unet)

    @property
    def unet(self) -> unet.UNetModel:
        return self.model.diffusion_model

    @property
    def vae(self) -> vae.AutoencoderKL:
        return self.first_stage_model

    @property
    def clip(self) -> clip_vit.CLIPVisionTransformer:
        return self.cond_stage_model.model.visual

    @staticmethod
    def init_random(spec: Zero123Spec = Zero123Spec(), device="cuda",
                    seed: int = 0) -> "Zero123Guidance":
        """Random weights, initialised as the JAX package's init_random
        (flax's defaults): lecun-normal kernels, zero biases, unit norms,
        the CLIP embeddings and projection N(0, 0.02); zero weights where
        ldm starts at zero (each ResBlock's last conv, each
        SpatialTransformer's proj_out, the UNet's output conv); and
        cc_projection near the identity on its CLIP part
        (morpheus_tpu/guidance/zero123.py:122-125). On the meta device the
        weights hold no values and nothing is drawn. Built on the card
        unless `device` says otherwise (without CUDA, "cuda" raises)."""
        device = torch.device(device)
        if device.type != "meta":
            device = resolve_device(device)
        with torch.device(device):
            g = Zero123Guidance(spec)
        if device.type == "meta":
            return cast_for_compute(g)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        zero = {id(m.out_layers[3]) for m in g.modules()
                if isinstance(m, ResBlock)}
        zero |= {id(m.proj_out) for m in g.modules()
                 if isinstance(m, SpatialTransformer)}
        zero.add(id(g.unet.out[2]))
        with torch.no_grad():
            clip_vit.flax_default_init_(g, gen, zero)
            clip_vit.embeddings_init_(g.clip, gen)
            cd = spec.context_dim
            w = g.cc_projection.weight                      # (cd, cd + 4)
            w.normal_(0.0, 0.02, generator=gen)
            w[:, :cd] += torch.eye(cd, device=device)
            g.cc_projection.bias.zero_()
        return cast_for_compute(g)


def cast_for_compute(g: Zero123Guidance) -> Zero123Guidance:
    """One cast of the UNet's weights to spec.compute_dtype (bfloat16: the
    UNet forward then runs in bfloat16, its GroupNorms in float32)."""
    if g.spec.compute_dtype == "bfloat16":
        g.unet.to(torch.bfloat16)
    return g


# ---- model wrappers ----------------------------------------------------------

def clip_image_embed(g: Zero123Guidance, images01: torch.Tensor
                     ) -> torch.Tensor:
    """images (B, 3, H, W) in [0, 1] -> (B, 1, context_dim). The tower may
    sit on another device (the trainer keeps it on the host once the
    embeddings exist); the result comes back to the images' device."""
    dev = g.clip.proj.device
    emb = g.clip(clip_vit.preprocess(images01.to(dev)))
    return emb[:, None, :].to(images01.device)


def vae_encode_mode(g: Zero123Guidance, images01: torch.Tensor
                    ) -> torch.Tensor:
    """The unscaled latent mode of the concatenated condition
    (zero123_utils.py:96)."""
    return g.vae.encode_moments(images01 * 2.0 - 1.0)[0]


def vae_encode_sample(g: Zero123Guidance, images01: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
    """The scaled posterior sample of the SDS latents (encode_imgs,
    zero123_utils.py:285-290): mean + std * eps, times the scale factor.
    eps (B, 4, h, w) is drawn by the caller, so that a recomputation
    (remat) sees the same draw."""
    mean, logvar = g.vae.encode_moments(images01 * 2.0 - 1.0)
    return g.spec.scale_factor * (mean + torch.exp(0.5 * logvar) * eps)


def vae_decode(g: Zero123Guidance, latents: torch.Tensor) -> torch.Tensor:
    """latents -> images in [0, 1] (decode_latents,
    zero123_utils.py:277-283)."""
    img = g.vae.decode(latents / g.spec.scale_factor)
    return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)


@torch.no_grad()
def apply_unet(g: Zero123Guidance, x, t, context) -> torch.Tensor:
    """The epsilon prediction, without gradient, in float32; under
    compute_dtype bfloat16 the inputs go in as bfloat16. On a card, a
    replay of the CUDA graph of this key (g.unet_graphs; unet_graph.py),
    captured at the key's first call, which runs eagerly; inside the
    capture of a body that calls it (the trainer's SDS step), the body
    itself, whose kernels become that graph's; on the CPU, eagerly. Counts
    unet.calls, and the graphs unet.replays (trace.py): a replay of the
    enclosing graph replays the UNet's kernels and adds both again."""
    trace.count("unet.calls")
    if graphs.capturing():
        trace.count("unet.replays")
        return _unet_body(g, x, t, context)
    if x.is_cuda:
        return g.unet_graphs(lambda *a: _unet_body(g, *a), x, t, context,
                             g.spec.compute_dtype)
    return _unet_body(g, x, t, context)


def _unet_body(g: Zero123Guidance, x, t, context) -> torch.Tensor:
    dt = torch.bfloat16 if g.spec.compute_dtype == "bfloat16" \
        else torch.float32
    return g.unet(x.to(dt), t, context.to(dt)).float()


# ---- geometry helpers (zero123_utils.py:102-152) -----------------------------

def _sph2cart(r, theta, phi):
    return torch.stack([r * torch.sin(theta) * torch.cos(phi),
                        r * torch.sin(theta) * torch.sin(phi),
                        r * torch.cos(theta)], -1)


def angle_between(sph_v1: torch.Tensor, sph_v2: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise angles (radians) between spherical coordinates (r, theta,
    phi) given in radians; (N, M) (zero123_utils.py:102-120)."""
    v1 = _sph2cart(sph_v1[..., 0], sph_v1[..., 1], sph_v1[..., 2])
    v2 = _sph2cart(sph_v2[..., 0], sph_v2[..., 1], sph_v2[..., 2])
    v1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + 1e-12)
    v2 = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + 1e-12)
    return torch.arccos(torch.clamp(v1 @ v2.T, -1.0, 1.0))


def angle_grad_scale(polar, azimuth, radius, ref_polar, ref_azimuth,
                     ref_radius, grad_scale: float) -> torch.Tensor:
    """Angle-dependent SDS gradient scale (zero123_utils.py:147-152), one
    reference view: (exp(angle_deg / 180) - 1) * grad_scale."""
    v1 = torch.stack([radius + ref_radius,
                      torch.deg2rad(polar + ref_polar),
                      torch.deg2rad(azimuth + ref_azimuth)], -1).reshape(1, 3)
    v2 = torch.stack([ref_radius, torch.deg2rad(ref_polar),
                      torch.deg2rad(ref_azimuth)], -1).reshape(1, 3)
    ang_deg = torch.rad2deg(angle_between(v1, v2))[0, 0]
    return (torch.exp(ang_deg / 180.0) - 1.0) * grad_scale


def pose_token(polar, azimuth, radius) -> torch.Tensor:
    """The relative pose folded into the CLIP token: [d_polar, sin
    d_azimuth, cos d_azimuth, d_radius] (1, 1, 4) (zero123_utils.py:197);
    angles in degrees."""
    a = torch.deg2rad(azimuth)
    return torch.stack([torch.deg2rad(polar), torch.sin(a), torch.cos(a),
                        radius], -1).reshape(1, 1, 4)


def _cfg_inputs(g, latents_noisy, t, c_crossattn, c_concat, T):
    """The classifier-free-guidance batch [uncond, cond]: (x_in, t_in,
    context)."""
    clip_emb = g.cc_projection(torch.cat([c_crossattn, T], -1))
    context = torch.cat([torch.zeros_like(clip_emb), clip_emb], 0)
    concat = torch.cat([torch.zeros_like(c_concat), c_concat], 0)
    x_in = torch.cat([torch.cat([latents_noisy] * 2, 0), concat], 1)
    return x_in, torch.cat([t] * 2, 0), context


# ---- SDS (zero123_utils.py:138-236) ------------------------------------------

def sds_loss(g: Zero123Guidance, draws, pred_rgb_256: torch.Tensor,
             c_crossattn: torch.Tensor, c_concat: torch.Tensor,
             polar, azimuth, radius, min_step: int, max_step: int, *,
             guidance_scale: float = 5.0, grad_scale=1.0,
             remat: bool = True):
    """One SDS step. pred_rgb_256 (1, 3, S, S) in [0, 1], differentiable;
    c_crossattn (1, 1, context_dim) and c_concat (1, 4, h, w) of the
    reference view; polar, azimuth, radius: the view's offsets (degrees,
    degrees, units). Draws: 'sds_posterior' (the VAE posterior's noise),
    'sds_t' (the timestep in [min_step, max_step]) and 'sds_noise'.
    Returns (loss, diag); diag holds what the guidance panels need. remat
    recomputes the VAE encoder forward in the backward instead of keeping
    its activations (torch.utils.checkpoint; exact: the encoder draws
    nothing, so no generator's state is kept for it)."""
    shape = (pred_rgb_256.shape[0], 4, g.spec.latent_size,
             g.spec.latent_size)
    eps = draws.normal("sds_posterior", shape)
    with trace.span("guidance.vae_encode"):
        if remat:
            latents = torch.utils.checkpoint.checkpoint(
                vae_encode_sample, g, pred_rgb_256, eps, use_reentrant=False,
                preserve_rng_state=False)
        else:
            latents = vae_encode_sample(g, pred_rgb_256, eps)
    t = draws.randint("sds_t", (1,), min_step, max_step + 1)
    noise = draws.normal("sds_noise", shape)
    ac = g.alphas_cumprod
    latents_noisy = schedule.add_noise(ac, latents.detach(), noise, t)

    x_in, t_in, context = _cfg_inputs(
        g, latents_noisy, t, c_crossattn, c_concat,
        pose_token(polar, azimuth, radius))
    with trace.span("guidance.unet"):
        uncond, cond = apply_unet(g, x_in, t_in, context).chunk(2, 0)
    noise_pred = uncond + guidance_scale * (cond - uncond)

    w = 1.0 - ac.index_select(0, t)
    grad = (grad_scale * w).reshape(-1, 1, 1, 1) * (noise_pred - noise)
    grad = torch.nan_to_num(grad)
    targets = (latents - grad).detach()
    loss = 0.5 * ((latents - targets) ** 2).sum() / latents.shape[0]
    diag = {"latents": latents.detach(), "latents_noisy": latents_noisy,
            "noise_pred": noise_pred, "noise": noise, "t": t}
    return loss, diag


@torch.no_grad()
def guidance_panels(g: Zero123Guidance, pred_rgb: torch.Tensor,
                    diag: dict) -> torch.Tensor:
    """Render | noised | denoised | |grad| panel row in [0, 1], (1, 3, S,
    4S) (zero123_utils.py:215-231)."""
    noisier = vae_decode(g, diag["latents_noisy"])
    x0 = schedule.predict_start_from_noise(
        g.alphas_cumprod, diag["latents_noisy"], diag["t"],
        diag["noise_pred"])
    denoised = vae_decode(g, x0)
    grad_vis = torch.abs(vae_decode(g, diag["noise_pred"] - diag["noise"]))
    return torch.cat([pred_rgb, noisier, denoised, grad_vis], dim=3)


# ---- verification sampler (zero123_utils.py:240-275) -------------------------

@torch.no_grad()
def novel_view_sample(g: Zero123Guidance, draws, image01: torch.Tensor,
                      polar=0.0, azimuth=0.0, radius=0.0, *,
                      scale: float = 3.0, ddim_steps: int = 50,
                      ddim_eta: float = 1.0) -> torch.Tensor:
    """Full DDIM novel-view synthesis (Zero123.__call__); image01 (1, 3,
    S, S). Draws: 'nv_latents', then 'nv_step' once per DDIM step."""
    spec = g.spec
    c_crossattn = clip_image_embed(g, image01)
    c_concat = vae_encode_mode(g, image01)
    a = np.deg2rad(azimuth)
    T = torch.tensor([np.deg2rad(polar), np.sin(a), np.cos(a), radius],
                     dtype=torch.float32,
                     device=image01.device).reshape(1, 1, 4)
    h = image01.shape[-1] // 2 ** (len(spec.vae_mult) - 1)  # the latent
    latents = draws.normal("nv_latents", (1, 4, h, h))
    ts = schedule.ddim_timesteps(spec.num_train_timesteps, ddim_steps)
    for i, t in enumerate(ts):
        t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
        t_vec = torch.full((1,), int(t), dtype=torch.long,
                           device=image01.device)
        x_in, t_in, context = _cfg_inputs(g, latents, t_vec, c_crossattn,
                                          c_concat, T)
        uncond, cond = apply_unet(g, x_in, t_in, context).chunk(2, 0)
        noise_pred = uncond + scale * (cond - uncond)
        latents = schedule.ddim_step(
            g.alphas_cumprod, noise_pred, int(t), t_prev, latents,
            noise=draws.normal("nv_step", latents.shape), eta=ddim_eta)
    return vae_decode(g, latents)

