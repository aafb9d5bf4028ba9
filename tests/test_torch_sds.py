"""The port's Zero123 SDS pieces against the JAX package's on the CPU:
sds_loss and its gradient with respect to the rendered image (float32 and
the bfloat16 UNet), the angle gradient scale, the virtual camera and
VirtualViewSampler.sample, the keyframe embeddings, and the virtual-view
loss with its parameter gradients. Same weights (tests/torch_parity.py
guidance_pair, make_sds_pair), the JAX key trees replayed into the port's
named draws. Tolerances are stated per test."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from morpheus_tpu import cameras as jcam  # noqa: E402
from morpheus_tpu.data import dataset as jdata  # noqa: E402
from morpheus_tpu.guidance import zero123 as jz  # noqa: E402
from morpheus_tpu_torch import cameras as tcam  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.guidance import zero123 as tz  # noqa: E402

torch.set_num_threads(1)


def nchw(a):
    return torch.as_tensor(np.asarray(a).transpose(0, 3, 1, 2).copy())


def _sds_inputs(jspec, seed=7):
    rng = np.random.default_rng(seed)
    # the latent side: image_size / 2^(len(vae_mult) - 1)
    S, lat, cd = jspec.image_size, tz.Zero123Spec(**tp.SPEC_KW).latent_size, \
        jspec.context_dim
    pred = rng.uniform(size=(1, S, S, 3)).astype(np.float32)
    c_cross = rng.standard_normal((1, 1, cd)).astype(np.float32)
    c_concat = rng.standard_normal((1, lat, lat, 4)).astype(np.float32)
    angles = np.float32(20.0), np.float32(-135.0), np.float32(0.1)
    return pred, c_cross, c_concat, angles


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sds_loss_and_grad_match_jax(dtype):
    """The loss and d loss / d pred_rgb_256 with JAX's posterior draw,
    timestep and noise. float32: rtol 1e-4, atol 1e-4 x the gradient's
    scale. bfloat16 UNet (both sides cast their UNet and its inputs to
    bfloat16, GroupNorm in float32): the two libraries' bfloat16 matmuls
    and convolutions round differently, so the epsilon prediction agrees to
    a few bfloat16 ulps: rtol 5e-2, atol 5e-2 x the gradient's scale."""
    jspec, jg, tspec, tg = tp.guidance_pair(3, compute_dtype=dtype)
    pred, c_cross, c_concat, (polar, azim, rad) = _sds_inputs(jspec)
    key = jax.random.PRNGKey(9)
    gs = np.float32(0.37)
    lo, hi = 20, 500

    def jloss(p):
        loss, t, noise, diag = jz.sds_loss(
            jg, key, p, jnp.asarray(c_cross), jnp.asarray(c_concat),
            polar, azim, rad, lo, hi, guidance_scale=5.0, grad_scale=gs,
            spec=jspec)
        return loss, diag["t"]

    (j_loss, j_t), j_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(pred))
    draws = tp.ReplayDraws(tp.sds_draws(key, tspec.latent_size, lo, hi))
    p = nchw(pred).requires_grad_()
    t_loss, diag = tz.sds_loss(
        tg, draws, p, torch.as_tensor(c_cross), nchw(c_concat),
        torch.tensor(polar), torch.tensor(azim), torch.tensor(rad), lo, hi,
        guidance_scale=5.0, grad_scale=torch.tensor(gs), remat=True)
    (t_grad,) = torch.autograd.grad(t_loss, p)
    assert int(diag["t"][0]) == int(j_t[0])
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=tol)
    want = np.asarray(j_grad).transpose(0, 3, 1, 2)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(t_grad.numpy(), want, rtol=tol,
                               atol=tol * scale)


def test_sds_remat_is_exact():
    """The VAE encoder's recomputation (torch.utils.checkpoint) gives the
    same loss and gradient bit for bit."""
    jspec, jg, tspec, tg = tp.guidance_pair(4)
    pred, c_cross, c_concat, (polar, azim, rad) = _sds_inputs(jspec)
    arrays = tp.sds_draws(jax.random.PRNGKey(2), tspec.latent_size, 20, 500)
    out = []
    for remat in (False, True):
        p = nchw(pred).requires_grad_()
        loss, _ = tz.sds_loss(
            tg, tp.ReplayDraws(arrays), p, torch.as_tensor(c_cross),
            nchw(c_concat), torch.tensor(polar), torch.tensor(azim),
            torch.tensor(rad), 20, 500, grad_scale=0.5, remat=remat)
        out.append((loss, torch.autograd.grad(loss, p)[0]))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_angle_grad_scale_matches_jax():
    """Float32 trigonometry: rtol 1e-5, atol 1e-7."""
    rng = np.random.default_rng(1)
    for _ in range(5):
        a = rng.uniform(-180, 180, size=6).astype(np.float32)
        a[2] = abs(a[2]) / 100 + 0.5
        a[5] = abs(a[5]) / 100 + 1.0
        want = jz.angle_grad_scale(*(jnp.float32(x) for x in a), 0.01)
        got = tz.angle_grad_scale(*(torch.tensor(x) for x in a), 0.01)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_virtual_camera_and_sampler_match_jax(rate):
    """sample_virtual_camera under both branches, and VirtualViewSampler
    .sample's rays and offsets (a random frame, the radius_scale and
    theta/phi range overrides too): rtol 1e-5, atol 1e-5 (degrees: 1e-4)."""
    jcfg, tcfg = tp.config_pair("float32")
    for cfg in (jcfg, tcfg):
        cfg["data"]["uniform_sphere_rate"] = rate
    key = jax.random.PRNGKey(5)
    radius = np.float32(1.7)
    jc2w, jth, jph = jcam.sample_virtual_camera(key, jnp.float32(radius),
                                                (45, 105), (-180, 180), rate)
    arrays = tp.camera_draws(jax.random.split(jax.random.PRNGKey(0), 2)[0], 4)
    k1, k2, k3 = jax.random.split(key, 3)
    arrays.update({"cam_theta": jax.random.uniform(k1, (1,)),
                   "cam_phi": jax.random.uniform(k2, (1,)),
                   "cam_sphere": jax.random.normal(k3, (1, 3)),
                   "cam_sphere_pick": jax.random.uniform(
                       jax.random.fold_in(key, 7), ())})
    c2w, th, ph = tcam.sample_virtual_camera(
        tp.ReplayDraws(arrays), torch.tensor(radius), (45, 105), (-180, 180),
        rate)
    np.testing.assert_allclose(c2w.numpy(), np.asarray(jc2w), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), atol=1e-4)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), atol=1e-4)

    from morpheus_tpu.data.synthetic import make_synthetic_scene
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.data.dataset import VirtualViewSampler
    jds = jdata.DeformDataset(jcfg, make_synthetic_scene(num_frames=4, H=32,
                                                         W=32))
    tds = load_synthetic(tcfg)
    js = jdata.VirtualViewSampler(jds, jcfg, 0.375)
    ts = VirtualViewSampler(tds, tcfg, 0.375, torch.device("cpu"))
    for kw in ({}, {"radius_scale": 1.3, "theta_range": (60.0, 80.0),
                    "phi_range": (-30.0, 40.0)}):
        k_v = jax.random.PRNGKey(8)
        jb = js.sample(k_v, **kw)
        tb = ts.sample(draws=tp.ReplayDraws(tp.camera_draws(k_v, 4)), **kw)
        assert int(tb["frame_idx"]) == int(jb["frame_idx"])
        for k in ("rays_o", "rays_d", "rays_t", "radius"):
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("polar", "azimuth"):
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       atol=1e-4, err_msg=k)
        assert np.array_equal(tb["rays_id"].numpy(), np.asarray(jb["rays_id"]))


@pytest.fixture(scope="module")
def sds_pair():
    return tp.make_sds_pair(0)


def test_precompute_embeddings_match_jax(sds_pair):
    """Keyframes, nearest keyframe of each frame, reference angles exactly;
    the CLIP embeddings and VAE latents of the masked frames: rtol 1e-4,
    atol 1e-4 x their scale. The CLIP tower then sits on the host."""
    jcfg, jtr, ttr = sds_pair
    je, te = jtr._embeddings, ttr.embeddings
    for k in ("kf", "nearest_kf", "ref_polars", "ref_azimuths",
              "ref_radii"):
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]),
                                      err_msg=k)
    for k, got in (("c_crossattn", te["c_crossattn"].numpy()),
                   ("c_concat", te["c_concat"].numpy().transpose(0, 2, 3,
                                                                 1))):
        want = np.asarray(je[k])
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    assert ttr.guidance.clip.proj.device.type == "cpu"


def test_virtual_loss_and_grads_match_jax(sds_pair):
    """Trainer.virtual_loss_from_batch and its parameter gradients on one
    fixed virtual view and occupancy grid, with the JAX draws (shading,
    ambient, background net pick, render, keyframe pick, SDS): the loss at
    rtol 1e-4, every gradient at rtol 1e-3, atol 1e-6 + 1e-4 x the largest
    gradient of its tensor (float32 sums of the render and the VAE backward
    in another order)."""
    jcfg, jtr, ttr = sds_pair
    epoch = 6
    jtr.epoch = ttr.epoch = epoch
    al = jtr._active_levels()
    ttr._set_levels(al)
    spec = jtr._spec_for_levels(al)
    max_level = float(jtr.curr.max_level(epoch))
    j_occ, t_occ = tp.fixed_occupancy(jcfg)
    key = jax.random.PRNGKey(21)
    k_v, k_rest = jax.random.split(key)
    js = jdata.VirtualViewSampler(jtr.dataset, jcfg, tp.SDS_VIEW / 32)
    batch = js.sample(k_v)
    H = W = tp.SDS_VIEW
    lo, hi = ttr.curr.sds_steps(epoch)

    def jloss(p):
        return jtr.virtual_loss_from_batch(p, j_occ, k_rest, epoch,
                                           max_level, batch, H, W,
                                           spec=spec)[0]

    j_l, j_g = jax.jit(jax.value_and_grad(jloss))(jtr.state.params)
    sampler = ttr.virtual_sampler(tp.SDS_VIEW / 32)
    tb = sampler.sample(draws=tp.ReplayDraws(tp.camera_draws(k_v, 4)))
    draws = tp.ReplayDraws(tp.view_draws(
        k_rest, jcfg, H * W, ttr.guidance.spec.latent_size, lo, hi))
    t_l, out = ttr.virtual_loss_from_batch(t_occ, draws, epoch, max_level,
                                           tb, H, W)
    t_g = ttr._grads(t_l)
    np.testing.assert_allclose(t_l.item(), float(j_l), rtol=1e-4)
    got = convert.params_to_jax(
        {n: g for (n, _), g in zip(ttr.field.named_parameters(), t_g)})
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, j_g)))
    moved = 0
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = flat_want[path]
        moved += bool(np.abs(w).max() > 0)
        np.testing.assert_allclose(
            g, w, rtol=1e-3, atol=1e-6 + 1e-4 * np.abs(w).max(),
            err_msg=jax.tree_util.keystr(path))
    assert moved >= 5
    assert "sds_diag" in out


def test_get_view_direction_matches_jax():
    """The discrete view bins on a grid of angles: exact."""
    th, ph = np.meshgrid(np.linspace(0, np.pi, 37, dtype=np.float32),
                         np.linspace(-2 * np.pi, 2 * np.pi, 73,
                                     dtype=np.float32))
    th, ph = th.reshape(-1), ph.reshape(-1)
    ov, fr = np.deg2rad(30.0), np.deg2rad(60.0)
    want = np.asarray(jcam.get_view_direction(jnp.asarray(th),
                                              jnp.asarray(ph), ov, fr))
    got = tcam.get_view_direction(torch.as_tensor(th), torch.as_tensor(ph),
                                  ov, fr).numpy()
    np.testing.assert_array_equal(got, want)


class _SequenceDraws(tp.ReplayDraws):
    """Replays a list of arrays for a name drawn more than once."""

    def _get(self, name, shape):
        a = self.arrays[name]
        a = np.asarray(a.pop(0) if isinstance(a, list) else a)
        assert a.shape == tuple(shape), (name, a.shape, shape)
        return torch.as_tensor(np.array(a))


def test_novel_view_sample_matches_jax():
    """Three DDIM steps with eta 1 (the JAX key tree's latents and per-step
    noise replayed): atol 2e-3 on the decoded image in [0, 1]. Three
    CFG-scaled UNet passes (scale 3), each x0 divided by sqrt(ac_t), and a
    four-level decoder, all with random weights, grow float32 round-off to
    ~6e-4 here.
    The JAX sampler takes the latent as 1/8 of the image, so the VAE here
    has the real depth (1, 2, 4, 4)."""
    jspec, jg, tspec, tg = tp.guidance_pair(5, vae_mult=(1, 2, 4, 4))
    img = np.random.default_rng(3).uniform(size=(1, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jz.novel_view_sample(
        jg, key, jnp.asarray(img), 10.0, 30.0, 0.1, ddim_steps=3,
        spec=jspec))
    key, k0 = jax.random.split(key)
    h = 16 // 8
    arrays = {"nv_latents": nchw(jax.random.normal(k0, (1, h, h, 4))),
              "nv_step": []}
    for _ in range(3):
        key, k = jax.random.split(key)
        arrays["nv_step"].append(nchw(jax.random.normal(k, (1, h, h, 4))))
    got = tz.novel_view_sample(tg, _SequenceDraws(arrays), nchw(img), 10.0,
                               30.0, 0.1, ddim_steps=3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=2e-3)
