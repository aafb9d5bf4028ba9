"""The port's Zero123 guidance stack (morpheus_tpu_torch/guidance/) against
the JAX package's (morpheus_tpu/guidance/) on the CPU: the schedule, the
timestep embedding, each layer, the UNet, the VAE, the CLIP tower and its
preprocess, and the resize, with every weight random and non-zero (the
ldm zero-initialised layers would make any output comparison pass), the
same weights on both sides through convert.guidance_from_jax. Float32
throughout; tolerances are stated per test (round-off of convolutions and
matmuls taken in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.guidance import clip_vit as jclip  # noqa: E402
from morpheus_tpu.guidance import layers as jlayers  # noqa: E402
from morpheus_tpu.guidance import schedule as jsched  # noqa: E402
from morpheus_tpu.guidance import zero123 as jz  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.guidance import clip_vit, layers  # noqa: E402
from morpheus_tpu_torch.guidance import schedule as tsched  # noqa: E402
from morpheus_tpu_torch.guidance import zero123 as tz  # noqa: E402
from morpheus_tpu_torch.guidance.resize import resize  # noqa: E402
from torch_parity import guidance_pair, randomize  # noqa: E402

def nchw(a):
    return torch.as_tensor(np.asarray(a).transpose(0, 3, 1, 2).copy())


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_schedule_matches_jax():
    """Exact: the same float64 arithmetic, cast to float32 once."""
    js, ts = jsched.DiffusionSchedule(), tsched.DiffusionSchedule()
    np.testing.assert_array_equal(js.alphas_cumprod, ts.alphas_cumprod)
    np.testing.assert_array_equal(jsched.ddim_timesteps(1000, 50),
                                  tsched.ddim_timesteps(1000, 50))
    rng = np.random.default_rng(0)
    ac = js.alphas_cumprod.astype(np.float32)
    x0, eps = (rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
               for _ in range(2))
    t = np.array([17, 903])
    jx = jsched.add_noise(jnp.asarray(ac), jnp.asarray(x0), jnp.asarray(eps),
                          jnp.asarray(t))
    tx = tsched.add_noise(torch.as_tensor(ac), torch.as_tensor(x0),
                          torch.as_tensor(eps), torch.as_tensor(t))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    j0 = jsched.predict_start_from_noise(jnp.asarray(ac), jx, jnp.asarray(t),
                                         jnp.asarray(eps))
    t0 = tsched.predict_start_from_noise(torch.as_tensor(ac), tx,
                                         torch.as_tensor(t),
                                         torch.as_tensor(eps))
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=1e-5,
                               atol=1e-5)
    noise = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    for t_prev in (480, -1):
        jd = jsched.ddim_step(jnp.asarray(ac), jnp.asarray(eps), 500, t_prev,
                              jnp.asarray(x0), eta=0.0)
        td = tsched.ddim_step(torch.as_tensor(ac), torch.as_tensor(eps), 500,
                              t_prev, torch.as_tensor(x0), eta=0.0)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)
    # eta > 0 adds sigma * noise; JAX draws it from its key
    key = jax.random.PRNGKey(3)
    jd = jsched.ddim_step(jnp.asarray(ac), jnp.asarray(eps), 500, 480,
                          jnp.asarray(x0), key=key, eta=1.0)
    td = tsched.ddim_step(torch.as_tensor(ac), torch.as_tensor(eps), 500,
                          480, torch.as_tensor(x0), eta=1.0,
                          noise=torch.as_tensor(np.array(
                              jax.random.normal(key, x0.shape))))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_timestep_embedding_matches_jax():
    """[cos | sin] of t * freqs. XLA's and torch's float32 exp of the
    frequencies may differ in the last bit, which t up to 999 turns into an
    argument difference of up to ~1e-4: atol 2e-6 at t <= 1, 2e-4 beyond."""
    t = np.array([0, 1, 17, 500, 999])
    for dim in (32, 320):
        j = np.asarray(jlayers.timestep_embedding(jnp.asarray(t), dim))
        got = layers.timestep_embedding(torch.as_tensor(t), dim).numpy()
        assert got.shape == j.shape == (5, dim)
        np.testing.assert_allclose(got[:2], j[:2], rtol=0, atol=2e-6)
        np.testing.assert_allclose(got[2:], j[2:], rtol=0, atol=2e-4)


def _flax_apply(module, x, *args, seed=0):
    params = module.init(jax.random.PRNGKey(0), x, *args)["params"]
    params = randomize(params, seed)
    return params, np.asarray(module.apply({"params": params}, x, *args))


def _port_from(prefix_fn, params):
    out = {}
    prefix_fn(out, params)
    return {k: torch.as_tensor(np.ascontiguousarray(v))
            for k, v in out.items()}


LAYER_CASES = ["groupnorm", "resblock", "resblock_skip", "crossattn",
               "geglu", "feedforward", "transformer_block", "spatial",
               "downsample", "upsample"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_matches_jax(case):
    """Each layer with random weights on random NHWC/NCHW inputs: rtol
    1e-4, atol 1e-5."""
    rng = np.random.default_rng(1)
    B, H, W, C, E, D = 2, 6, 6, 32, 16, 8
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    ctx = rng.standard_normal((B, 3, D)).astype(np.float32)
    seq = rng.standard_normal((B, 5, C)).astype(np.float32)
    wrap = lambda f: (lambda out, p: f(out, "m", p))  # noqa: E731
    if case == "groupnorm":
        p, want = _flax_apply(jlayers.GroupNorm32(), jnp.asarray(x))
        m = layers.GroupNorm32(C)
        sd = _port_from(wrap(convert._leaf), p)
        m.load_state_dict({k[2:]: v for k, v in sd.items()})
        got = nhwc(m(nchw(x)))
    elif case in ("resblock", "resblock_skip"):
        co = C if case == "resblock" else 64
        p, want = _flax_apply(jlayers.ResBlock(co), jnp.asarray(x),
                              jnp.asarray(emb))
        m = layers.ResBlock(C, co, E)
        m.load_state_dict({k[2:]: v for k, v in _port_from(
            wrap(convert._res_block), p).items()})
        got = nhwc(m(nchw(x), torch.as_tensor(emb)))
    elif case == "crossattn":
        p, want = _flax_apply(jlayers.CrossAttention(4, 8), jnp.asarray(seq),
                              jnp.asarray(ctx))
        m = layers.CrossAttention(C, 4, 8, D)
        sd = {}
        for n in ("to_q", "to_k", "to_v"):
            convert._leaf(sd, n, p[n])
        convert._leaf(sd, "to_out.0", p["to_out"])
        m.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()})
        got = m(torch.as_tensor(seq), torch.as_tensor(ctx)).detach().numpy()
    elif case in ("geglu", "feedforward"):
        mod = (jlayers.GEGLU(C * 4) if case == "geglu"
               else jlayers.FeedForward())
        p, want = _flax_apply(mod, jnp.asarray(seq))
        sd = {}
        if case == "geglu":
            m = layers.GEGLU(C, C * 4)
            convert._leaf(sd, "proj", p["proj"])
        else:
            m = layers.FeedForward(C)
            convert._leaf(sd, "net.0.proj", p["geglu"]["proj"])
            convert._leaf(sd, "net.2", p["out"])
        m.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()})
        got = m(torch.as_tensor(seq)).detach().numpy()
    elif case in ("transformer_block", "spatial"):
        if case == "spatial":
            p, want = _flax_apply(jlayers.SpatialTransformer(4),
                                  jnp.asarray(x), jnp.asarray(ctx))
            m = layers.SpatialTransformer(C, 4, D)
            inp = nchw(x)
        else:
            p, want = _flax_apply(jlayers.BasicTransformerBlock(4, 8),
                                  jnp.asarray(seq), jnp.asarray(ctx))
            p = {"norm": {"norm": {"scale": np.ones(C), "bias": np.zeros(C)}},
                 "proj_in": {"kernel": np.zeros((1, 1, C, C))},
                 "proj_out": {"kernel": np.zeros((1, 1, C, C))},
                 "block_0": p}
            m = layers.SpatialTransformer(C, 4, D).transformer_blocks[0]
            inp = torch.as_tensor(seq)
        sd = _port_from(wrap(convert._spatial_transformer), p)
        if case == "transformer_block":
            sd = {k[len("m.transformer_blocks.0."):]: v for k, v in sd.items()
                  if k.startswith("m.transformer_blocks.0.")}
        else:
            sd = {k[2:]: v for k, v in sd.items()}
        m.load_state_dict(sd)
        out = m(inp, torch.as_tensor(ctx))
        got = nhwc(out) if case == "spatial" else out.detach().numpy()
    else:
        mod = jlayers.Downsample() if case == "downsample" \
            else jlayers.Upsample()
        p, want = _flax_apply(mod, jnp.asarray(x))
        m = layers.Downsample(C) if case == "downsample" \
            else layers.Upsample(C)
        sd = {}
        convert._leaf(sd, "op" if case == "downsample" else "conv",
                      p["conv"])
        m.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()})
        got = nhwc(m(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_unet_matches_jax():
    """The UNet forward (two levels, every block type): rtol 1e-4, atol
    1e-4 on outputs of magnitude ~1-10."""
    jspec, jg, tspec, tg = guidance_pair(0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    t = np.array([20, 480])
    ctx = rng.standard_normal((2, 1, 16)).astype(np.float32)
    want = np.asarray(jax.jit(lambda g, *a: jz.apply_unet(g, *a, jspec))(
        jg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    got = nhwc(tz.apply_unet(tg, nchw(x), torch.as_tensor(t),
                             torch.as_tensor(ctx)))
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_vae_matches_jax():
    """encode_moments (mean and clipped logvar), the posterior sample with
    JAX's draw, and decode: rtol 1e-4, atol 1e-4 x the output scale."""
    jspec, jg, tspec, tg = guidance_pair(1)
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jvae = jspec.vae_module()
    jm, jl = jvae.apply({"params": jg.vae_params},
                        jnp.asarray(img) * 2.0 - 1.0,
                        method=jvae.encode_moments)
    tm, tl = tg.vae.encode_moments(nchw(img) * 2.0 - 1.0)
    for a, b in ((tm, jm), (tl, jl)):
        s = np.abs(np.asarray(b)).max()
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * s)
    js = jz.vae_encode_sample(jg, key, jnp.asarray(img), jspec)
    eps = nchw(jax.random.normal(key, jm.shape))
    ts = tz.vae_encode_sample(tg, nchw(img), eps)
    np.testing.assert_allclose(nhwc(ts), np.asarray(js), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(js)).max())
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    jd = np.asarray(jz.vae_decode(jg, jnp.asarray(z), jspec))
    td = nhwc(tz.vae_decode(tg, nchw(z)))
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
    jraw = np.asarray(jvae.apply({"params": jg.vae_params},
                                 jnp.asarray(z), method=jvae.decode))
    traw = nhwc(tg.vae.decode(nchw(z)))
    np.testing.assert_allclose(traw, jraw, rtol=1e-4,
                               atol=1e-4 * np.abs(jraw).max())


def test_clip_tower_matches_jax():
    """preprocess (bicubic 48 -> 224 and 300 -> 224 with JAX's Keys kernel
    and antialias, then normalise): atol 1e-5 before the division by CLIP's
    std (>= 0.26), so 5e-5 after it; the tower and the
    (B, 1, context) embedding: rtol 1e-4, atol 1e-4 x the scale."""
    jspec, jg, tspec, tg = guidance_pair(2)
    rng = np.random.default_rng(4)
    for size in (48, 300):
        img = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
        jp = np.asarray(jclip.preprocess(jnp.asarray(img)))
        tp = nhwc(clip_vit.preprocess(nchw(img)))
        np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-5)
    want = np.asarray(jz.clip_image_embed(jg, jnp.asarray(img), jspec))
    got = tz.clip_image_embed(tg, nchw(img)).detach().numpy()
    assert got.shape == want.shape == (2, 1, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size,new", [((72, 72), (256, 256)),
                                      ((180, 180), (256, 256)),
                                      ((72, 72), (64, 64)),
                                      ((256, 256), (224, 224)),
                                      ((13, 17), (40, 9))])
def test_resize_matches_jax_image_resize(method, size, new):
    """Up and down (antialiased), bilinear and bicubic, and the gradient
    through it: atol 1e-5 on unit-scale values."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3) + size).astype(np.float32)
    g = rng.standard_normal((2, 3) + new).astype(np.float32)

    def jf(a):
        return jax.image.resize(a, (2, 3) + new, method)

    want, vjp = jax.vjp(jf, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    got = resize(xt, new, method)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (gx,) = torch.autograd.grad(got, xt, torch.as_tensor(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=0, atol=1e-4)


def test_nearest_upsample_matches_jax():
    """F.interpolate nearest 2x, as the UNet's and the VAE's Upsample use
    it, equals jax.image.resize 'nearest': exact."""
    x = np.random.default_rng(6).standard_normal((1, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 10, 14, 3),
                                       "nearest"))
    got = nhwc(torch.nn.functional.interpolate(nchw(x), scale_factor=2.0,
                                               mode="nearest"))
    np.testing.assert_array_equal(got, want)

