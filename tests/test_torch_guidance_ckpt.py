"""The port's Zero123 weights: the full-size module's state dict against
the real 105000.ckpt layout (the inventory tests/test_zero123_ckpt_layout.py
builds, imported, at no memory cost on the meta device); a state dict
through the JAX package's convert_state_dict and back through
convert.guidance_from_jax unchanged; and the checkpoint loader's EMA
override, strict key handling and refusals on a tiny checkpoint written
here."""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_zero123_ckpt_layout as layout  # noqa: E402
import torch_parity as tp  # noqa: E402
from morpheus_tpu.guidance import convert as jconvert  # noqa: E402
from morpheus_tpu.guidance import zero123 as jz  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.guidance import checkpoint  # noqa: E402
from morpheus_tpu_torch.guidance.zero123 import (  # noqa: E402
    Zero123Guidance, Zero123Spec)

PREFIXES = checkpoint.PREFIXES


def test_full_size_state_dict_is_the_ldm_layout():
    """Every key and shape of Zero123Guidance(Zero123Spec()) under ldm's
    prefixes equals the real checkpoint's inventory, and nothing else is
    in the state dict (alphas_cumprod is not saved)."""
    g = Zero123Guidance.init_random(Zero123Spec(), "meta")
    got = {k: tuple(v.shape) for k, v in g.state_dict().items()}
    want = {}
    for part in (layout.unet_keys(), layout.vae_keys(), layout.clip_keys()):
        want.update({k: tuple(s) for k, s in part.items()
                     if k.startswith(PREFIXES)})
    want["cc_projection.weight"] = (layout.CTX, layout.CTX + 4)
    want["cc_projection.bias"] = (layout.CTX,)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]
    assert sum(np.prod(s) for s in got.values()) > 1.2e9


ROUND_TRIP_KW = dict(tp.SPEC_KW, vae_mult=(1, 2, 4, 4), vae_res_blocks=2,
                     image_size=32)


def test_state_dict_round_trip_through_jax_convert():
    """Port state dict -> the JAX convert_state_dict (strict) -> convert.
    guidance_from_jax: the same tensors, bit for bit. (The JAX converter
    reads the real VAE depth, so the VAE here is (1,2,4,4) x 2 at width
    32.)"""
    spec = Zero123Spec(**ROUND_TRIP_KW)
    g = Zero123Guidance.init_random(spec, "cpu", seed=4)
    with torch.no_grad():
        for p in g.parameters():            # no zero and no unit weights
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    sd = {k: v.numpy() for k, v in g.state_dict().items()}
    unet, vae, clip, cc_w, cc_b = jconvert.convert_state_dict(
        sd, jz.Zero123Spec(**ROUND_TRIP_KW), strict=True)
    back = convert.guidance_from_jax(SimpleNamespace(
        unet_params=unet, vae_params=vae, clip_params=clip, cc_w=cc_w,
        cc_b=cc_b), spec)
    assert set(back) == set(sd)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), sd[k]), k


def _tiny_ckpt(tmp_path, extra=None, drop=None):
    """A tiny ldm-style lightning checkpoint: the guidance's weights, the
    schedule buffers, the CLIP text leftovers and LitEma copies of the UNet
    (one of which differs from its live weight)."""
    spec = Zero123Spec(**tp.SPEC_KW)
    g = Zero123Guidance.init_random(spec, "cpu", seed=2)
    sd = dict(g.state_dict())
    for k in checkpoint.SCHEDULE_BUFFERS:
        sd[k] = torch.zeros(()) if k == "scale_factor" else torch.zeros(1000)
    for k in checkpoint.CLIP_TEXT_LEFTOVERS:
        sd[k] = torch.zeros(3)
    for k in list(sd):
        if k.startswith("model.diffusion_model."):
            sd[checkpoint.ema_name(k)] = sd[k].clone()
    live = "model.diffusion_model.out.2.bias"
    sd[checkpoint.ema_name(live)] = torch.full_like(sd[live], 7.0)
    sd["model_ema.decay"] = torch.tensor(0.9999)
    sd["model_ema.num_updates"] = torch.tensor(105000)
    sd = {k: v.half() if v.is_floating_point() else v for k, v in sd.items()}
    sd.update(extra or {})
    for k in drop or ():
        del sd[k]
    path = str(tmp_path / "zero123.ckpt")
    torch.save({"state_dict": sd, "global_step": 105000}, path)
    return spec, g, path


def test_loader_takes_ema_weights_and_is_strict(tmp_path):
    """The LitEma copy overrides the live UNet weight; every other weight
    loads as the checkpoint's float16 value in float32; an unknown key, a
    missing weight and an unreadable file are refused."""
    spec, g, path = _tiny_ckpt(tmp_path)
    loaded = checkpoint.load_zero123_checkpoint(path, spec, "cpu")
    got = loaded.state_dict()
    assert torch.equal(got["model.diffusion_model.out.2.bias"],
                       torch.full((4,), 7.0))
    for k, v in g.state_dict().items():
        if k != "model.diffusion_model.out.2.bias":
            assert torch.equal(got[k], v.half().float()), k
    assert torch.equal(loaded.alphas_cumprod, g.alphas_cumprod)
    assert not any(p.requires_grad for p in loaded.parameters())

    _, _, bad = _tiny_ckpt(tmp_path, extra={
        "model.diffusion_model.totally_new_block.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unknown checkpoint keys"):
        checkpoint.load_zero123_checkpoint(bad, spec, "cpu")
    _, _, short = _tiny_ckpt(tmp_path, drop=["cc_projection.bias"])
    with pytest.raises(RuntimeError, match="cc_projection.bias"):
        checkpoint.load_zero123_checkpoint(short, spec, "cpu")
    empty = tmp_path / "empty.ckpt"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="not a readable Zero123"):
        checkpoint.load_zero123_checkpoint(str(empty), spec,
                                             "cpu")


def test_guidance_defaults_to_the_card(tmp_path):
    """Like the trainer, the guidance is built or loaded on CUDA unless told
    otherwise; without a card that raises rather than falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec, _, path = _tiny_ckpt(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Zero123Guidance.init_random(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load_zero123_checkpoint(path, spec)


def test_bfloat16_compute_dtype_casts_the_unet_only(tmp_path):
    """compute_dtype bfloat16: the UNet's weights are bfloat16, the VAE,
    CLIP and cc_projection stay float32 (loaded and random alike)."""
    spec, _, path = _tiny_ckpt(tmp_path)
    for g in (checkpoint.load_zero123_checkpoint(
            path, Zero123Spec(**dict(tp.SPEC_KW, compute_dtype="bfloat16")),
            "cpu"),
              Zero123Guidance.init_random(Zero123Spec(**dict(
                  tp.SPEC_KW, compute_dtype="bfloat16")), "cpu")):
        assert {p.dtype for p in g.unet.parameters()} == {torch.bfloat16}
        for m in (g.vae, g.clip, g.cc_projection):
            assert {p.dtype for p in m.parameters()} == {torch.float32}
