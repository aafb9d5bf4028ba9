"""CLIP image-similarity scorer for the novel-view evaluation (port of
morpheus_tpu/eval/clip_eval.py; reference: models/clip_encoders.py
ImageEncoder, the ViT-B/32 cosine similarity that render_test_video reports,
morpheus.py:1339-1374).

The tower is guidance/clip_vit.vit_b32() on an explicit device, with
open_clip's `visual.*` names, so an OpenAI CLIP state dict loads by name.
"""
from __future__ import annotations

import numpy as np
import torch

from ..guidance import clip_vit
from ..utils import resolve_device

PREFIX = "visual."


class ImageEncoder:
    """ViT-B/32 image-embedding similarity on `device` (the card unless
    told otherwise; without CUDA, "cuda" raises). Without a checkpoint the
    weights are random, drawn from `seed` as flax's defaults are: scores are
    then only self-consistent, not semantically meaningful (the real
    weights come from an OpenAI CLIP state dict). `model` replaces the
    ViT-B/32 tower by another CLIPVisionTransformer, its weights kept."""

    def __init__(self, model: clip_vit.CLIPVisionTransformer | None = None,
                 device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        if model is None:
            model = clip_vit.vit_b32()
            gen = torch.Generator().manual_seed(int(seed))
            with torch.no_grad():
                clip_vit.flax_default_init_(model, gen)
                clip_vit.embeddings_init_(model, gen)
        self.model = model.to(self.device).eval().requires_grad_(False)

    @staticmethod
    def from_clip_checkpoint(path: str, device="cuda") -> "ImageEncoder":
        """Load from an OpenAI CLIP ViT-B/32 torch state dict (its
        `visual.*` entries; torch tensors or numpy arrays)."""
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        model = clip_vit.vit_b32()
        model.load_state_dict({k[len(PREFIX):]: torch.as_tensor(v).float()
                               for k, v in sd.items()
                               if k.startswith(PREFIX)})
        return ImageEncoder(model, device)

    def save_checkpoint(self, path: str) -> str:
        """Write the tower as an OpenAI-layout `visual.*` state dict, a file
        that from_clip_checkpoint (and the JAX package's) reads."""
        torch.save({PREFIX + k: v.detach().cpu()
                    for k, v in self.model.state_dict().items()}, path)
        return path

    @staticmethod
    def export_checkpoint_from_transformers(out_path: str,
                                            pretrained: str | None =
                                            "openai/clip-vit-base-patch32"):
        """Write an OpenAI-layout ViT-B/32 checkpoint usable as exp.clip_ckpt.

        With network access, `pretrained` pulls the real OpenAI weights via
        transformers (the documented acquisition path:
        `python -c "from morpheus_tpu_torch.eval.clip_eval import
        ImageEncoder; ImageEncoder.export_checkpoint_from_transformers(
        'clip_b32.pt')"`). pretrained=None builds a random-weight model of
        the same layout. transformers is imported here only: nothing else
        of the port needs it."""
        from transformers import (CLIPVisionConfig,
                                  CLIPVisionModelWithProjection)
        if pretrained:
            tm = CLIPVisionModelWithProjection.from_pretrained(pretrained)
        else:
            cfg = CLIPVisionConfig(hidden_size=768, intermediate_size=3072,
                                   num_hidden_layers=12,
                                   num_attention_heads=12, image_size=224,
                                   patch_size=32, hidden_act="quick_gelu",
                                   projection_dim=512)
            tm = CLIPVisionModelWithProjection(cfg)
        sd = {k: v.detach().float().numpy() for k, v in tm.state_dict().items()}
        torch.save(hf_visual_to_openai(sd, layers=12), out_path)
        return out_path

    def embed(self, images01) -> torch.Tensor:
        """images (B, H, W, 3) in [0,1] (numpy or a tensor) ->
        L2-normalized embeddings (B, out_dim) on the device."""
        x = torch.as_tensor(images01, dtype=torch.float32,
                            device=self.device).permute(0, 3, 1, 2)
        with torch.no_grad():
            e = self.model(clip_vit.preprocess(x))
        return e / torch.linalg.norm(e, dim=-1, keepdim=True)

    def get_similarity_from_image(self, pred01, gt01) -> float:
        """Cosine similarity (clip_encoders.py:46-50)."""
        a = self.embed(pred01)
        b = self.embed(gt01)
        return float((a * b).sum(-1).mean())


def hf_visual_to_openai(sd: dict, layers: int) -> dict:
    """transformers CLIPVisionModelWithProjection state dict (numpy values) →
    OpenAI CLIP 'visual.*' layout (the layout torch hub / openai-clip
    checkpoints use and from_clip_checkpoint reads). q/k/v projections fuse
    into in_proj; visual_projection transposes to (width, out_dim)."""
    V = "vision_model."
    out = {
        "visual.conv1.weight": sd[f"{V}embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd[f"{V}embeddings.class_embedding"],
        "visual.positional_embedding":
            sd[f"{V}embeddings.position_embedding.weight"],
        "visual.ln_pre.weight": sd[f"{V}pre_layrnorm.weight"],
        "visual.ln_pre.bias": sd[f"{V}pre_layrnorm.bias"],
        "visual.ln_post.weight": sd[f"{V}post_layernorm.weight"],
        "visual.ln_post.bias": sd[f"{V}post_layernorm.bias"],
        "visual.proj": np.ascontiguousarray(sd["visual_projection.weight"].T),
    }
    for i in range(layers):
        b = f"{V}encoder.layers.{i}"
        o = f"visual.transformer.resblocks.{i}"
        out[f"{o}.attn.in_proj_weight"] = np.concatenate(
            [sd[f"{b}.self_attn.q_proj.weight"],
             sd[f"{b}.self_attn.k_proj.weight"],
             sd[f"{b}.self_attn.v_proj.weight"]], 0)
        out[f"{o}.attn.in_proj_bias"] = np.concatenate(
            [sd[f"{b}.self_attn.q_proj.bias"],
             sd[f"{b}.self_attn.k_proj.bias"],
             sd[f"{b}.self_attn.v_proj.bias"]], 0)
        out[f"{o}.attn.out_proj.weight"] = sd[f"{b}.self_attn.out_proj.weight"]
        out[f"{o}.attn.out_proj.bias"] = sd[f"{b}.self_attn.out_proj.bias"]
        for ours, theirs in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2")):
            out[f"{o}.{ours}.weight"] = sd[f"{b}.{theirs}.weight"]
            out[f"{o}.{ours}.bias"] = sd[f"{b}.{theirs}.bias"]
        for ours, theirs in (("mlp.c_fc", "mlp.fc1"),
                             ("mlp.c_proj", "mlp.fc2")):
            out[f"{o}.{ours}.weight"] = sd[f"{b}.{theirs}.weight"]
            out[f"{o}.{ours}.bias"] = sd[f"{b}.{theirs}.bias"]
    return out
