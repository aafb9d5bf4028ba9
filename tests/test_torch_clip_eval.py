"""The port's CLIP eval (morpheus_tpu_torch/eval/clip_eval.py) against the
JAX package's: a narrow ViT (width 64, 2 layers, 2 heads, patch 32) in both
packages, the JAX params carried across by convert.clip_visual_from_jax:
embeddings within 1e-5 relative to their largest entry, similarity within
1e-5; hf_visual_to_openai equal to the JAX copy key for key; a full
ViT-B/32 `visual.*` file written with torch.save loads through
from_clip_checkpoint in both packages with the same scores; self-similarity
is 1 within 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from morpheus_tpu.eval import clip_eval as jclip_eval  # noqa: E402
from morpheus_tpu.guidance import clip_vit as jclip_vit  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.eval import clip_eval  # noqa: E402
from morpheus_tpu_torch.guidance import clip_vit  # noqa: E402

NARROW = {"width": 64, "layers": 2, "heads": 2, "patch": 32, "out_dim": 32}


def _images(seed, n=2, size=(60, 80)):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n,) + size + (3,)).astype(np.float32)


@pytest.fixture(scope="module")
def narrow_pair():
    """The narrow tower in both packages, the port's weights converted from
    the JAX params."""
    jm = jclip_vit.CLIPVisionTransformer(**NARROW)
    params = jm.init(jax.random.PRNGKey(1),
                     jnp.zeros((1, 224, 224, 3)))["params"]
    jenc = jclip_eval.ImageEncoder(params=params)
    jenc.model = jm                   # its jitted embed reads self.model
    tm = clip_vit.CLIPVisionTransformer(**NARROW)
    tm.load_state_dict(convert.clip_visual_from_jax(
        jax.tree_util.tree_map(np.asarray, params), NARROW["layers"]))
    return jenc, clip_eval.ImageEncoder(tm, device="cpu")


def test_embeddings_and_similarity_match_jax(narrow_pair):
    jenc, tenc = narrow_pair
    a, b = _images(0), _images(1)
    want = np.asarray(jenc.embed(a))
    got = tenc.embed(a).numpy()
    assert got.shape == want.shape == (2, NARROW["out_dim"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    s_j = jenc.get_similarity_from_image(a, b)
    s_t = tenc.get_similarity_from_image(a, b)
    assert abs(s_t - s_j) <= 1e-5
    assert abs(tenc.get_similarity_from_image(a, a) - 1.0) <= 1e-4


def _hf_layout(layers, width=8, out_dim=6, rng=None):
    """A synthetic transformers CLIPVisionModelWithProjection state dict."""
    rng = rng or np.random.default_rng(2)
    V = "vision_model."

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {f"{V}embeddings.patch_embedding.weight": r(width, 3, 4, 4),
          f"{V}embeddings.class_embedding": r(width),
          f"{V}embeddings.position_embedding.weight": r(5, width),
          f"{V}pre_layrnorm.weight": r(width), f"{V}pre_layrnorm.bias": r(width),
          f"{V}post_layernorm.weight": r(width),
          f"{V}post_layernorm.bias": r(width),
          "visual_projection.weight": r(out_dim, width)}
    for i in range(layers):
        b = f"{V}encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{b}.self_attn.{n}.weight"] = r(width, width)
            sd[f"{b}.self_attn.{n}.bias"] = r(width)
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{n}.weight"] = r(width)
            sd[f"{b}.{n}.bias"] = r(width)
        sd[f"{b}.mlp.fc1.weight"] = r(4 * width, width)
        sd[f"{b}.mlp.fc1.bias"] = r(4 * width)
        sd[f"{b}.mlp.fc2.weight"] = r(width, 4 * width)
        sd[f"{b}.mlp.fc2.bias"] = r(width)
    return sd


def test_hf_visual_to_openai_matches_jax():
    sd = _hf_layout(layers=3)
    got = clip_eval.hf_visual_to_openai(sd, layers=3)
    want = jclip_eval.hf_visual_to_openai(sd, layers=3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # every key names a parameter of the port's tower
    tower = clip_vit.CLIPVisionTransformer(width=8, layers=3, heads=2,
                                           patch=4, out_dim=6, image_size=8)
    assert sorted(k[len("visual."):] for k in got) == sorted(
        tower.state_dict())


def test_full_vit_b32_checkpoint_loads_in_both_packages(tmp_path):
    """A random ViT-B/32 the port writes in the OpenAI `visual.*` layout
    (with one text-tower entry, which is skipped) loads through each
    package's from_clip_checkpoint; both score the same images alike."""
    enc = clip_eval.ImageEncoder(device="cpu", seed=3)
    path = enc.save_checkpoint(str(tmp_path / "clip_b32.pt"))
    sd = torch.load(path, weights_only=True)
    assert len(sd) == 4 + 4 + 12 * 12
    sd["token_embedding.weight"] = torch.zeros(4, 8)
    torch.save(sd, path)
    port = clip_eval.ImageEncoder.from_clip_checkpoint(path, device="cpu")
    for k, v in enc.model.state_dict().items():
        assert torch.equal(port.model.state_dict()[k], v), k
    jax_enc = jclip_eval.ImageEncoder.from_clip_checkpoint(path)
    a, b = _images(4, n=1, size=(96, 64)), _images(5, n=1, size=(96, 64))
    s_t = port.get_similarity_from_image(a, b)
    s_j = jax_enc.get_similarity_from_image(a, b)
    assert np.isfinite(s_t) and abs(s_t - s_j) <= 1e-4
    assert abs(port.get_similarity_from_image(a, a) - 1.0) <= 1e-4


def test_encoder_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clip_eval.ImageEncoder(clip_vit.CLIPVisionTransformer(**NARROW))
