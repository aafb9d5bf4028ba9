"""Zero-1-to-3 as a configuration's SDS prior: guidance.model ["zero123"],
its widths in the configuration's "zero123_spec" (cvlab-columbia/zero123,
configs/sd-objaverse-finetune-c_concat-256.yaml).

The harness finds this file by the kind's name and takes from it what
inputs.load_prior lists.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference.guidance import clip_vit
from benchmark.reference.guidance import zero123 as z123
from benchmark.reference.guidance.layers import ResBlock, SpatialTransformer
from benchmark.reference.guidance.resize import resize

TINY_SPEC = z123.TINY_SPEC


def spec(fields: dict) -> z123.Zero123Spec:
    s = dict(fields)
    for k in ("unet_mult", "vae_mult"):
        s[k] = tuple(s[k])
    return z123.Zero123Spec(**s)


# ---- the weights ------------------------------------------------------------

def _init_plan(g) -> dict:
    """name -> ("normal", std) | ("const", value) for every weight of the
    guidance module `g` (on the meta device): lecun-normal kernels, zero
    biases, unit norms, N(0, 0.02) CLIP embeddings and cc_projection, and
    zero weights where ldm starts at zero (each ResBlock's last conv, each
    SpatialTransformer's proj_out, the UNet's output conv)."""
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


def state(spec: z123.Zero123Spec, seed: int, device) -> dict:
    """An ldm-named state dict of the Zero123 guidance (UNet, VAE, CLIP image
    tower, cc_projection) in float32 on `device`: each of the four parts'
    normal weights are views of one draw of a generator of `seed`, scaled
    per tensor; cc_projection starts near the identity on its CLIP part."""
    with torch.device("meta"):
        g = z123.Zero123Guidance(spec)
    plan = _init_plan(g)
    shapes = {n: p.shape for n, p in g.named_parameters()}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
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


# ---- the two sides' guidance -----------------------------------------------

def program(state: dict, fields: dict, device):
    """The port's Zero123Guidance from the ldm state dict
    (guidance.checkpoint.from_state_dict), its UNet cast to the spec's
    compute type."""
    from morpheus_tpu_torch.guidance.checkpoint import from_state_dict
    from morpheus_tpu_torch.guidance.zero123 import Zero123Spec
    return from_state_dict(state, Zero123Spec(**fields), device)


def reference(state: dict, spec: z123.Zero123Spec, device):
    """The reference's Zero123Guidance from the same ldm state dict, the
    UNet cast to the compute type that the configuration states."""
    with torch.device("meta"):
        g = z123.Zero123Guidance(spec)
    g.load_state_dict(state, strict=True, assign=True)
    g.alphas_cumprod = torch.as_tensor(spec.diffusion.alphas_cumprod,
                                       dtype=torch.float32, device=device)
    return z123.cast_for_compute(g.requires_grad_(False))


def release(g) -> None:
    """The CLIP image tower serves the conditioning alone: to the host."""
    g.clip.to("cpu")


# ---- the reference's SDS step -----------------------------------------------

@torch.no_grad()
def conditioning(ref) -> dict:
    """The keyframes' CLIP embeddings and VAE latent modes, each frame's
    nearest keyframe, and the keyframes' poses (the port's
    precompute_embeddings)."""
    import cv2
    ds, g = ref.dataset, ref.guidance
    kf = np.arange(0, ds.num_frames, ref.config["train"]["kf_every"])
    if (ds.num_frames - 1) not in kf:
        kf = np.concatenate([kf, [ds.num_frames - 1]])
    gsz = g.spec.image_size
    imgs = []
    for i in kf:
        m = (ds.masks[i] > 0.5).astype(np.float32)
        masked = ds.images[i] * m[..., None] + (1.0 - m[..., None])
        imgs.append(cv2.resize(masked, (gsz, gsz),
                               interpolation=cv2.INTER_AREA
                               ).astype(np.float32))
    imgs = torch.as_tensor(np.stack(imgs).transpose(0, 3, 1, 2).copy(),
                           device=ref.device)
    c_crossattn = torch.cat([z123.clip_image_embed(g, imgs[k:k + 1])
                             for k in range(len(kf))], 0)
    c_concat = torch.cat([z123.vae_encode_mode(g, imgs[k:k + 1])
                          for k in range(len(kf))], 0)
    nearest = np.argmin(np.abs(kf[None, :]
                               - np.arange(ds.num_frames)[:, None]), 1)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=ref.device)
    return {
        "kf": dev(kf, torch.long), "nearest_kf": dev(nearest, torch.long),
        "c_crossattn": c_crossattn, "c_concat": c_concat,
        "ref_polars": dev(np.asarray(ds.theta, np.float32)[kf]),
        "ref_azimuths": dev(np.asarray(ds.phi, np.float32)[kf]),
        "ref_radii": dev(np.asarray(ds.radius, np.float32)[kf]),
    }


def views(ref, epoch) -> dict:
    """One novel view a step."""
    return ref.sample_view(epoch)


def loss(ref, batch: dict, out: dict, epoch) -> torch.Tensor:
    """The SDS loss on the view's render: the keyframe pick (the nearest
    keyframe or the first), the view's pose relative to it, its angle's
    gradient scale, and sds_loss at the epoch's timestep bounds."""
    draws, g, emb = ref.draws, ref.guidance, ref.embeddings
    gd = ref.config["guidance"]
    H, W = ref.sampler.H, ref.sampler.W
    pred = torch.clamp(out["image"].reshape(1, H, W, 3), 0.0, 1.0)
    gsz = g.spec.image_size
    pred256 = resize(pred.permute(0, 3, 1, 2), (gsz, gsz), "bilinear")
    f = batch["frame_idx"].reshape(1).long()
    slot_near = emb["nearest_kf"].index_select(0, f)
    use_cur = draws.uniform("kf_pick", ()) > 0.5
    slot = torch.where(use_cur, slot_near, 0)

    def at(name, s):
        return emb[name].index_select(0, s)[0]

    def dev(x):
        return torch.as_tensor(x, device=ref.device).reshape(-1)[0]
    polar_t = dev(batch["polar"]) + at("ref_polars", slot_near)
    azim_t = dev(batch["azimuth"]) + at("ref_azimuths", slot_near)
    rad_t = dev(batch["radius"]) + at("ref_radii", slot_near)
    polar_k = polar_t - at("ref_polars", slot)
    azim_k = azim_t - at("ref_azimuths", slot)
    azim_k = torch.where(azim_k > 180.0, azim_k - 360.0, azim_k)
    rad_k = rad_t - at("ref_radii", slot)
    gs = z123.angle_grad_scale(
        polar_k, azim_k, rad_k, at("ref_polars", slot),
        at("ref_azimuths", slot), at("ref_radii", slot),
        gd["zero123_grad_weight"])
    min_step, max_step = ref.curr.sds_steps(epoch)
    loss_sds, _ = z123.sds_loss(
        g, draws, pred256, emb["c_crossattn"].index_select(0, slot),
        emb["c_concat"].index_select(0, slot), polar_k, azim_k, rad_k,
        min_step, max_step, guidance_scale=gd["zero123_guidance_scale"],
        grad_scale=gs, remat=False)
    return loss_sds
