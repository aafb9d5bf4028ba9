"""Shared pieces of the trainer parity tests (tests/test_torch_trainer.py,
tests/test_torch_trainer_modes.py, tests/test_torch_train_steps.py,
tests/test_torch_sds*.py, tests/test_torch_*mode* files): a tiny synthetic
config with per-section overrides, a JAX/port trainer pair with the same
parameters (and the same random Zero123 guidance), spec-level options set
on both (set_spec), the replay of the JAX steps' key trees into the port's
named draw sites, and the real-loss parity check."""
import dataclasses

import numpy as np
import torch
import jax
import jax.numpy as jnp

from morpheus_tpu.config import merge_defaults as jax_merge_defaults
from morpheus_tpu.data import dataset as jax_dataset
from morpheus_tpu.data.synthetic import make_synthetic_scene as jax_scene
from morpheus_tpu.guidance import zero123 as jz
from morpheus_tpu.train import trainer as jax_trainer
from morpheus_tpu_torch import convert
from morpheus_tpu_torch.config import merge_defaults
from morpheus_tpu_torch.data.dataset import load_synthetic
from morpheus_tpu_torch.guidance import zero123 as tz
from morpheus_tpu_torch.ops import hashgrid, occupancy
from morpheus_tpu_torch.train.trainer import Trainer
from morpheus_tpu_torch.utils import Draws

GRIDS = ("sdf_grid", "color_grid")

TINY = {
    "data": {"data_dir": "<synthetic>", "synthetic_frames": 4,
             "synthetic_res": 32},
    "exp": {"seed": 3},
    "train": {"n_epochs": 8, "n_iters": 1, "real_freq": 3, "virtual_freq": 0,
              "real_ray_num": 64, "warm_up_end": 4},
    "model": {"bg_radius": 0.0, "grid_num_levels": 4,
              "grid_log2_hashmap_size": 10, "grid_base_resolution": 8,
              "grid_desired_resolution": 32},
    "tpu": {"max_samples_per_ray": 16, "march_steps": 64,
            "occ_resolution": 16, "sample_budget": 8, "band_budget": 2,
            "smooth_budget": 2, "occ_warmup_steps": 2, "occ_update_every": 2,
            "chain_steps": False, "donate_state": False},
}


# configs/ab_exact.yaml's departures from the shipped arm, on TINY: no
# sample, smooth or band budget, the exact surface-band ladder, linear
# occupancy queries refreshing a quarter of the cells
AB_EXACT = {"tpu": {"sample_budget": 0, "band_budget": 0, "smooth_budget": 0,
                    "band_reuse": False, "occ_query_interp": "linear",
                    "occ_sample_fraction": 0.25}}

# topo_none off with every dormant smoothness term on
TOPO = {"train": {"topo_none": False, "normal_dir": True,
                  "normal_smooth_3d_t": 0.1, "deform_smooth": 0.1,
                  "deform_smooth_t": 0.1, "topo_smooth_t": 0.1}}


def config_pair(payload, vjp_mode="hist_rows", overrides=None):
    """(JAX config, port config) of TINY with the gradient payload, the
    vjp_mode and {section: {key: value}} overrides."""
    tiny = {k: dict(v) for k, v in TINY.items()}
    tiny["tpu"]["grad_payload"] = payload
    tiny["tpu"]["vjp_mode"] = vjp_mode
    for section, kv in (overrides or {}).items():
        tiny[section].update(kv)
    return jax_merge_defaults(tiny), merge_defaults(tiny)


def set_spec(jtr, ttr, grid=None, **field):
    """Spec-level options that no config key reaches (normal_mode, the
    grid's interpolation, gridtype, align_corners), set on both trainers as
    their constructors would have: the port's through Trainer.set_spec, the
    JAX trainer's here, its occupancy spec keeping the field's
    interpolation under occ_query_interp 'linear'."""
    ttr.set_spec(grid, **field)
    jtr.spec = dataclasses.replace(
        jtr.spec, grid=dataclasses.replace(jtr.spec.grid, **(grid or {})),
        **field)
    occ = jtr.occ_spec.grid.interpolation
    if jtr.config["tpu"].get("occ_query_interp", "nearest") == "linear":
        occ = jtr.spec.grid.interpolation
    jtr.occ_spec = dataclasses.replace(jtr.spec, grid=dataclasses.replace(
        jtr.spec.grid, interpolation=occ))


class ReplayDraws:
    """A draw source that hands out pre-drawn arrays by name."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def _get(self, name, shape):
        a = np.asarray(self.arrays[name])
        assert a.shape == tuple(shape), (name, a.shape, shape)
        return torch.as_tensor(np.array(a))

    def uniform(self, name, shape):
        return self._get(name, shape).float()

    def normal(self, name, shape):
        return self._get(name, shape).float()

    def randint(self, name, shape, low, high):
        return self._get(name, shape).long()


def _budget(per_ray, N, total):
    """Sites a budget of per_ray a ray keeps out of `total` (all when 0)."""
    return per_ray * N if per_ray and per_ray * N < total else total


def render_draws(k_r, cfg, N):
    """The draws of renderer.render_rays under key k_r (renderer.py:154,
    occupancy.py:179, renderer.py:125-337 and the two band forms,
    :393-457): the samples' march, the light, the smoothness subset and
    perturbation (isotropic, or the ortho phase under normal_dir), the time
    jitters of the dormant terms (fold_in 1 and 2), and the surface band's
    draws: the reuse form's subset score and phase (k1, k2 of k_smooth) or
    the exact ladder's jitter, phase and subset score (k1, k2, k3)."""
    tpu, tr = cfg["tpu"], cfg["train"]
    K = tpu["max_samples_per_ray"]
    B = _budget(tpu["sample_budget"], N, N * K)
    Bs = _budget(tpu["smooth_budget"], N, B)
    k_march, k_light, k_perturb, k_smooth = jax.random.split(k_r, 4)
    k1, k2 = jax.random.split(k_smooth)
    out = {
        "march": jax.random.uniform(k_march, (N, 1)),
        "light": jax.random.normal(k_light, (3,)),
        "smooth_sel": jax.random.uniform(jax.random.fold_in(k_perturb, 7),
                                         (B,)),
        "perturb": jax.random.normal(k_perturb, (Bs, 3)),
        "perturb_phase": jax.random.uniform(k_perturb, (Bs, 1)),
        "t_perturb_3d": jax.random.uniform(jax.random.fold_in(k_perturb, 1),
                                           (Bs, 1)),
        "t_perturb": jax.random.uniform(jax.random.fold_in(k_perturb, 2),
                                        (B, 1)),
    }
    if tpu.get("band_reuse", True) and tpu["band_budget"]:
        Bb = _budget(tpu["band_budget"], N, B)
        out["band_sel"] = jax.random.uniform(k1, (B,))
        out["band_phase"] = jax.random.uniform(k2, (Bb, 1))
    else:
        P = int(tr["trunc"] * 100 + 1)
        k1, k2, k3 = jax.random.split(k_smooth, 3)
        out["ladder_jitter"] = jax.random.uniform(k1, (P,))
        out["ladder_sel"] = jax.random.uniform(k3, (P * N,))
        out["ladder_phase"] = jax.random.uniform(
            k2, (_budget(tpu["band_budget"], N, P * N), 1))
    return out


def step_draws(key, cfg, num_frames, n_pix, step):
    """The draws of Trainer._real_step_body under step key `key`
    (trainer.py:403-405,213-227, occupancy.py:57-64,104-115,
    dataset.py:155-158)."""
    tpu, N = cfg["tpu"], cfg["train"]["real_ray_num"]
    k_occ, k_loss, k_t = jax.random.split(key, 3)
    out = {"t_occ": jax.random.uniform(k_t)}
    k_jit, k_sel = jax.random.split(k_occ)
    n_cells = tpu["occ_resolution"] ** 3
    if step < tpu["occ_warmup_steps"]:
        out["occ_jitter"] = jax.random.uniform(k_jit, (n_cells, 3))
        out["occ_sel"] = jax.random.randint(k_sel, (int(n_cells * 0.25),), 0,
                                            n_cells)
    else:
        n = max(1, int(n_cells * tpu["occ_sample_fraction"]))
        out["occ_jitter"] = jax.random.uniform(k_jit, (n, 3))
    k_s, k_bg, k_r = jax.random.split(k_loss, 3)
    k_f, k_p = jax.random.split(k_s)
    out["frame"] = jax.random.randint(k_f, (), 0, num_frames)
    out["pix"] = jax.random.randint(k_p, (N,), 0, n_pix)
    out["bg"] = jax.random.uniform(k_bg, (N, 3))
    out.update(render_draws(k_r, cfg, N))
    return out


def _perturb(params):
    """Move off the geometric init, whose sdf reads only xyz through a ReLU
    MLP: its normals are piecewise constant, so the perturbed-normal L1
    term would compare equal normals and differentiate round-off signs."""
    params = dict(params)
    rng = np.random.default_rng(0)
    params["sdf_grid"] = params["sdf_grid"] * 100.0
    params["color_grid"] = params["color_grid"] * 100.0
    w0 = params["sdf_net"]["w"][0]
    params["sdf_net"] = {"w": [w0 + 0.05 * rng.standard_normal(
        w0.shape).astype(np.float32)] + list(params["sdf_net"]["w"][1:]),
        "b": params["sdf_net"]["b"]}
    return jax.tree.map(jnp.asarray, params)


def make_pair(payload, vjp_mode="hist_rows", overrides=None, spec=None):
    """A JAX trainer and a port trainer of config_pair(...) with the same
    (perturbed) parameters; spec: set_spec's keyword arguments."""
    jcfg, tcfg = config_pair(payload, vjp_mode, overrides)
    scene = jax_scene(num_frames=4, H=32, W=32)
    jtr = jax_trainer.Trainer(jcfg, jax_dataset.DeformDataset(jcfg, scene))
    ttr = Trainer(tcfg, load_synthetic(tcfg), device="cpu")
    if spec:
        set_spec(jtr, ttr, **spec)
    params = _perturb(jtr.state.params)
    jtr.state = jtr.state._replace(params=params)
    ttr.load_params(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, jtr, ttr


# ---- Zero123 SDS ---------------------------------------------------------------

# the smallest guidance spec with every layer type (tests/test_smoke_fast.py:
# 95-98), with two UNet levels so Downsample and Upsample are in it
SPEC_KW = dict(image_size=16, unet_channels=32, unet_mult=(1, 2),
               unet_heads=2, context_dim=16, clip_width=32, clip_layers=1,
               clip_heads=2, clip_patch=14, vae_ch=32, vae_mult=(1, 2),
               vae_res_blocks=1)


def randomize(tree, seed, scale=0.2):
    """Every leaf replaced by seeded normal values (float32)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(
        np.shape(a))).astype(np.float32), tree)


def jax_guidance(jspec, seed):
    """A JAX Zero123Guidance of `jspec` with every leaf random and non-zero
    (init_random zero-initialises the UNet's output convs, so its epsilon
    would be 0 and pass any comparison): the parameter shapes come from
    jax.eval_shape of each module's init (no compilation), the values from
    numpy."""
    lat = jspec.image_size // 8
    cd = jspec.context_dim
    k = jax.random.PRNGKey(0)
    shapes = [jax.eval_shape(m.init, k, *args)["params"] for m, args in (
        (jspec.unet_module(), (jnp.zeros((1, lat, lat, 8)),
                               jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 1, cd)))),
        (jspec.vae_module(), (jnp.zeros((1, jspec.image_size,
                                         jspec.image_size, 3)),)),
        (jspec.clip_module(), (jnp.zeros((1, 224, 224, 3)),)))]
    unet_p, vae_p, clip_p = (randomize(t, seed + i)
                             for i, t in enumerate(shapes))
    return jz.Zero123Guidance(
        unet_params=unet_p, vae_params=vae_p, clip_params=clip_p,
        cc_w=randomize(np.zeros((cd + 4, cd)), seed + 3),
        cc_b=randomize(np.zeros((cd,)), seed + 4),
        alphas_cumprod=jnp.asarray(jspec.diffusion.alphas_cumprod,
                                   jnp.float32))


def guidance_pair(seed=0, **kw):
    """A JAX Zero123Guidance with random non-zero weights and the port's
    with the same weights (convert.guidance_from_jax)."""
    spec_kw = dict(SPEC_KW, **kw)
    jspec = jz.Zero123Spec(**spec_kw)
    jg = jax_guidance(jspec, seed)
    tspec = tz.Zero123Spec(**spec_kw)
    tg = tz.Zero123Guidance(tspec)
    tg.load_state_dict(convert.guidance_from_jax(
        jax.tree.map(np.asarray, jg), tspec))
    tz.cast_for_compute(tg)
    if tspec.compute_dtype == "bfloat16":
        jg = jz.cast_for_compute(jg, jspec)
    return jspec, jg, tspec, tg


# a virtual view of 12x12 rays (novel_view_scale 0.375 of the 32x32 scene),
# resized up to the guidance's 16x16; the background net on; epoch 6 of 8
# is past the albedo phase, so the shading is drawn
SDS_TRAIN = {"virtual_freq": 1, "real_freq": 1, "warm_up_steps": 0,
             "freeze_epoch": 4}
SDS_VIEW = 12


def make_sds_pair(seed=0, payload="float32", **train):
    """A JAX/port trainer pair with the same field parameters (as
    make_pair) and the same random Zero123 guidance; each side computes its
    own keyframe embeddings."""
    tiny = {k: dict(v) for k, v in TINY.items()}
    tiny["train"].update(SDS_TRAIN, **train)
    tiny["model"]["bg_radius"] = 1.4
    tiny["data"]["novel_view_scale"] = SDS_VIEW / 32
    tiny["tpu"].update(grad_payload=payload, remat_virtual=False)
    jcfg, tcfg = jax_merge_defaults(tiny), merge_defaults(tiny)
    jspec, jg, tspec, tg = guidance_pair(seed)
    scene = jax_scene(num_frames=4, H=32, W=32)
    jtr = jax_trainer.Trainer(jcfg, jax_dataset.DeformDataset(jcfg, scene),
                              guidance=jg, guidance_spec=jspec)
    ttr = Trainer(tcfg, load_synthetic(tcfg), device="cpu", guidance=tg)
    params = _perturb(jtr.state.params)
    jtr.state = jtr.state._replace(params=params)
    ttr.load_params(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, jtr, ttr


def fixed_occupancy(cfg, seed=11):
    """The same partly occupied occupancy grid for both sides."""
    R = cfg["tpu"]["occ_resolution"]
    occs = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                         (R ** 3,))) * 0.02
    j_occ = jax_trainer.occupancy.OccupancyState(
        occs=jnp.asarray(occs),
        binaries=jnp.asarray(occs > 0.01).reshape(R, R, R))
    t_occ = occupancy.OccupancyState(
        occs=torch.as_tensor(occs),
        binaries=torch.as_tensor(occs > 0.01).reshape(R, R, R))
    return j_occ, t_occ


def sds_draws(k_sds, latent, min_step, max_step):
    """The draws of guidance.zero123.sds_loss under key k_sds
    (zero123.py:266-271), the latents' noise in NCHW."""
    k_enc, k_t, k_noise = jax.random.split(k_sds, 3)
    shape = (1, latent, latent, 4)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return {"sds_posterior": nchw(jax.random.normal(k_enc, shape)),
            "sds_t": jax.random.randint(k_t, (1,), min_step, max_step + 1),
            "sds_noise": nchw(jax.random.normal(k_noise, shape))}


def camera_draws(k_v, num_frames):
    """The draws of data.dataset.VirtualViewSampler.sample and
    cameras.sample_virtual_camera under key k_v (dataset.py:226-238,
    cameras.py:129-144)."""
    k_f, k_cam = jax.random.split(k_v)
    k1, k2, k3 = jax.random.split(k_cam, 3)
    return {"vframe": jax.random.randint(k_f, (), 0, num_frames),
            "cam_theta": jax.random.uniform(k1, (1,)),
            "cam_phi": jax.random.uniform(k2, (1,)),
            "cam_sphere": jax.random.normal(k3, (1, 3)),
            "cam_sphere_pick": jax.random.uniform(jax.random.fold_in(k_cam,
                                                                     7), ())}


def view_draws(k_rest, cfg, N, latent, min_step, max_step):
    """The draws of Trainer.virtual_loss_from_batch under key k_rest
    (trainer.py:516-601)."""
    k_shade, k_amb, k_bg, k_bgsel, k_r, k_sds, k_pick = jax.random.split(
        k_rest, 7)
    out = {"shade": jax.random.uniform(k_shade),
           "ambient": jax.random.uniform(k_amb),
           "bg_virtual": jax.random.uniform(k_bg, (3,)),
           "bg_select": jax.random.uniform(k_bgsel),
           "kf_pick": jax.random.uniform(k_pick)}
    out.update(render_draws(k_r, cfg, N))
    out.update(sds_draws(k_sds, latent, min_step, max_step))
    return out


def virtual_step_draws(key, cfg, num_frames, latent, steps):
    """The draws of one JAX virtual step under step key `key`
    (trainer.py:625-641) at a global step that refreshes no occupancy."""
    k_occ, k_loss, k_t = jax.random.split(key, 3)
    k_v, k_rest = jax.random.split(k_loss)
    out = {"t_occ": jax.random.uniform(k_t)}
    out.update(camera_draws(k_v, num_frames))
    out.update(view_draws(k_rest, cfg, SDS_VIEW ** 2, latent, *steps))
    return out


def assert_trees_close(got: dict, want: dict, rtol, atol, what=""):
    """Port state-dict-named arrays against a JAX parameter tree."""
    got_tree = convert.params_to_jax({k: torch.as_tensor(v)
                                      for k, v in got.items()})
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want)))
    flat_got = jax.tree_util.tree_leaves_with_path(got_tree)
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(
            g, flat_want[path], rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _abs_hist_grads(monkeypatch, loss_fn, field):
    """Grid gradients of loss_fn() with every accumulated payload
    (histogram or sorted segment sum) replaced by its absolute value: per
    table slot, the sum of |cotangent| into it."""
    hist_fn, segsum_fn = hashgrid.level_histogram, hashgrid.segment_sum_sorted
    with monkeypatch.context() as m:
        m.setattr(hashgrid, "level_histogram", lambda idx, vals, starts, n,
                  **kw: hist_fn(idx, vals.abs(), starts, n, **kw))
        m.setattr(hashgrid, "segment_sum_sorted", lambda keys, vals, size,
                  **kw: segsum_fn(keys, vals.abs(), size, **kw))
        grads = torch.autograd.grad(loss_fn(), [getattr(field, g)
                                                for g in GRIDS])
    return {g: h.numpy() for g, h in zip(GRIDS, grads)}


def _fixed_batch(jcfg, jtr):
    """One fixed ray batch of 64 rays, a fixed partly occupied occupancy
    grid, a background and the render key, for both sides: (k_r, JAX
    batch, JAX occupancy, JAX background, port batch, port occupancy,
    port background)."""
    key = jax.random.PRNGKey(11)
    k_b, k_occ, k_bg, k_r = jax.random.split(key, 4)
    batch = jax_dataset.sample_real_view_rays(k_b, jtr.data, 4, 64)
    R = jcfg["tpu"]["occ_resolution"]
    occs = np.asarray(jax.random.uniform(k_occ, (R ** 3,))) * 0.02
    j_occ = jax_trainer.occupancy.OccupancyState(
        occs=jnp.asarray(occs), binaries=jnp.asarray(occs > 0.01).reshape(
            R, R, R))
    bg = jax.random.uniform(k_bg, (64, 3))
    t_batch = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    t_batch["rays_id"] = t_batch["rays_id"].long()
    t_occ = occupancy.OccupancyState(
        occs=torch.as_tensor(occs),
        binaries=torch.as_tensor(occs > 0.01).reshape(R, R, R))
    return k_r, batch, j_occ, bg, t_batch, t_occ, torch.as_tensor(
        np.array(bg))


def _at_epoch(jtr, ttr, epoch):
    """Both trainers at `epoch` with its active levels: (JAX spec,
    max_level)."""
    ttr.epoch = jtr.epoch = epoch
    al = jtr._active_levels()
    assert ttr._active_levels() == al
    ttr._set_levels(al)
    return jtr._spec_for_levels(al), float(jtr.curr.max_level(epoch))


def check_real_loss_matches_jax(payload, vjp_mode, monkeypatch,
                                overrides=None, spec=None, leaf_atol=0.0):
    """Trainer.real_loss_from_batch and its parameter gradients against the
    JAX trainer's on one fixed batch and occupancy grid (tolerances:
    tests/test_torch_trainer.py). leaf_atol widens each gradient's
    tolerance by that share of its leaf's largest |gradient| (the callers
    state why)."""
    jcfg, jtr, ttr = make_pair(payload, vjp_mode, overrides, spec)
    epoch = 6
    spec, max_level = _at_epoch(jtr, ttr, epoch)
    assert spec.grid.vjp_mode == ttr.step_field.spec.grid.vjp_mode == vjp_mode
    k_r, batch, j_occ, bg, t_batch, t_occ, t_bg = _fixed_batch(jcfg, jtr)

    def jloss(p):
        return jtr.real_loss_from_batch(p, j_occ, k_r, epoch, max_level,
                                        batch, bg, spec=spec)[0]

    j_l, j_g = jax.jit(jax.value_and_grad(jloss))(jtr.state.params)

    def t_loss():
        return ttr.real_loss_from_batch(
            t_occ, ReplayDraws(render_draws(k_r, jcfg, 64)), epoch,
            max_level, t_batch, t_bg)[0]

    t_l = t_loss()
    t_g = torch.autograd.grad(t_l, ttr.params)
    np.testing.assert_allclose(t_l.item(), float(j_l), rtol=1e-4)
    got = convert.params_to_jax(
        {n: g for (n, _), g in zip(ttr.field.named_parameters(), t_g)})
    want = jax.tree.map(np.asarray, j_g)
    bound = (_abs_hist_grads(monkeypatch, t_loss, ttr.field)
             if payload == "bfloat16" else {})
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        name = path[0].key
        w = flat_want[path]
        atol = (1e-6 + (2.0 ** -7 * bound[name] if name in bound else 0.0)
                + leaf_atol * np.abs(w).max())
        bad = np.abs(g - w) > atol + 1e-3 * np.abs(w)
        assert not bad.any(), (jax.tree_util.keystr(path), g[bad], w[bad])


def check_trains_and_loss_matches_jax(overrides):
    """A mode's port trainer trains - three real steps of its own draws from
    step 0, finite losses, every parameter group moved - and its real-view
    loss on a fixed batch and occupancy grid matches the JAX trainer's
    (forward only, rtol 1e-4) from the same parameters and draws."""
    jcfg, jtr, ttr = make_pair("float32", "hist_rows", overrides)
    epoch = 6
    spec, max_level = _at_epoch(jtr, ttr, epoch)
    k_r, batch, j_occ, bg, t_batch, t_occ, t_bg = _fixed_batch(jcfg, jtr)
    j_l = jax.jit(lambda p: jtr.real_loss_from_batch(
        p, j_occ, k_r, epoch, max_level, batch, bg, spec=spec)[0])(
            jtr.state.params)
    t_l = ttr.real_loss_from_batch(
        t_occ, ReplayDraws(render_draws(k_r, jcfg, 64)), epoch, max_level,
        t_batch, t_bg)[0]
    np.testing.assert_allclose(t_l.item(), float(j_l), rtol=1e-4)
    ttr.draws = Draws("cpu", 5)
    before = [p.detach().clone() for p in ttr.params]
    losses = [ttr.real_step(epoch).item() for _ in range(3)]
    assert np.isfinite(losses).all(), losses
    moved = {name.split(".")[0] for name, a, b in zip(
        ttr.optim.names, before, ttr.params) if not torch.equal(a, b)}
    assert moved == {name.split(".")[0] for name in ttr.optim.names}
    return ttr


def check_steps_match_jax(payload="float32", vjp_mode="hist_rows",
                          overrides=None, spec=None, occ_rtol=1e-5):
    """Three real training steps of the port against three of the JAX
    trainer from the same parameters and replayed draws
    (tests/test_torch_train_steps.py: the first step with the warmup
    occupancy update, the third with a sampled one). Losses at rtol 1e-4,
    occupancy values at occ_rtol, the parameters within 2*n*lr after n
    steps (an optimizer step normalised by the gradient's own scale moves a
    weight whose gradient is at round-off level by up to a full lr either
    way)."""
    jcfg, jtr, ttr = make_pair(payload, vjp_mode, overrides, spec)
    epoch = 3
    jtr.epoch = ttr.epoch = epoch
    al = jtr._active_levels()
    ttr._set_levels(al)
    j_step = jtr._make_real_step(al)
    nf, n_pix, n = 4, 32 * 32, 3
    for step in range(n):
        jtr.key, k = jax.random.split(jtr.key)
        ttr.draws = ReplayDraws(step_draws(k, jcfg, nf, n_pix, step))
        jtr.state, j_loss = j_step(jtr.state, k, jnp.float32(epoch))
        t_loss = ttr.real_step(epoch)
        np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(ttr.occ.occs.numpy(),
                                   np.asarray(jtr.state.occ.occs),
                                   rtol=occ_rtol, atol=1e-7,
                                   err_msg=f"occs step {step}")
    assert ttr.global_step == n
    assert_trees_close(dict(ttr.field.state_dict()), jtr.state.params,
                       rtol=0, atol=2 * n * float(jtr.curr.learning_rate(
                           epoch)), what="params")
    return jtr, ttr
