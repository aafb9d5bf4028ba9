"""The port's eval render (vis/video.py eval_render, renderer.render_rays'
eval path) against the JAX package's on one frame of the tiny synthetic
config (tests/torch_parity.py), same parameters, same occupancy grid, and
the march draws of the JAX eval's PRNGKey(0) replayed into every chunk.
Cases: the real view with the learned pose correction, the canonical field
with a background net (bg_radius > 0), and a fixed-angle virtual view.
Image, depth and opacity at rtol 1e-4, atol 1e-5 (the same float32 math in
another summation order). Also: the test videos render the EMA weights."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu import renderer as jrenderer  # noqa: E402
from morpheus_tpu.data import dataset as jdata  # noqa: E402
from morpheus_tpu.data.synthetic import make_synthetic_scene  # noqa: E402
from morpheus_tpu.model import field as jfield  # noqa: E402
from morpheus_tpu.train import trainer as jtrainer  # noqa: E402
from morpheus_tpu.vis import video as jvideo  # noqa: E402
from morpheus_tpu_torch import convert, renderer  # noqa: E402
from morpheus_tpu_torch.data import dataset as data  # noqa: E402
from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.model.field import Field, FieldSpec  # noqa: E402
from morpheus_tpu_torch.ops import occupancy  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402
from morpheus_tpu_torch.vis import video  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
CHUNK = 400         # 1024 rays of a 32x32 frame: 3 chunks of 342, padded


def _make(bg_radius):
    jcfg, tcfg = tp.config_pair("float32")
    jcfg["model"]["bg_radius"] = tcfg["model"]["bg_radius"] = bg_radius
    jtr = jtrainer.Trainer(jcfg, jdata.DeformDataset(
        jcfg, make_synthetic_scene(num_frames=4, H=32, W=32)))
    ttr = Trainer(tcfg, load_synthetic(tcfg), device="cpu")
    params = dict(jtr.state.params)
    rng = np.random.default_rng(2)
    params["sdf_grid"] = params["sdf_grid"] * 100.0
    params["color_grid"] = params["color_grid"] * 100.0
    # translations only: the rotation's sin and cos differ by an ulp between
    # the two frameworks, which can move a sample across an occupancy cell
    # (test_pose_correction_matches_jax holds the rotation)
    pose = 0.05 * rng.standard_normal(params["pose"].shape)
    pose[:, :3] = 0.0
    params["pose"] = jnp.asarray(pose.astype(np.float32))
    ttr.load_params(convert.params_from_jax(jax.tree.map(np.asarray,
                                                         params)))
    R = jcfg["tpu"]["occ_resolution"]
    occs = np.asarray(jax.random.uniform(jax.random.PRNGKey(8),
                                         (R ** 3,))) * 0.02
    j_occ = jtrainer.occupancy.OccupancyState(
        occs=jnp.asarray(occs),
        binaries=jnp.asarray(occs > 0.005).reshape(R, R, R))
    t_occ = occupancy.OccupancyState(
        occs=torch.as_tensor(occs),
        binaries=torch.as_tensor(occs > 0.005).reshape(R, R, R))
    return jcfg, jtr, params, j_occ, ttr, t_occ


@pytest.fixture(scope="module")
def plain():
    return _make(0.0)


@pytest.fixture(scope="module")
def with_bg():
    return _make(1.4)


def _draws(jcfg, n):
    return lambda: tp.ReplayDraws(tp.render_draws(jax.random.PRNGKey(0),
                                                  jcfg, n))


def _rays(kind, jcfg, jtr, ttr):
    if kind == "real":
        return (jdata.full_frame_rays(jtr.data, 4, 1),
                data.full_frame_rays(ttr.data, 4, 1))
    js = jdata.VirtualViewSampler(jtr.dataset, jcfg, 1.0)
    ts = data.VirtualViewSampler(ttr.dataset, ttr.config, 1.0, "cpu")
    kw = {"frame_idx": 2, "theta_deg": 80.0, "phi_deg": 120.0}
    return js.sample(jax.random.PRNGKey(0), **kw), ts.sample(**kw)


def _check(got, want):
    for g, w, name in zip(got, want, ("image", "depth", "opacity")):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind,cano,pose,setup", [
    ("real", False, True, "plain"),
    ("virtual", True, False, "with_bg"),
    ("virtual", False, False, "plain"),
], ids=["real_view_pose", "cano_bg_net", "fixed_angle_virtual"])
def test_eval_render_matches_jax(kind, cano, pose, setup, request):
    jcfg, jtr, params, j_occ, ttr, t_occ = request.getfixturevalue(setup)
    jrays, trays = _rays(kind, jcfg, jtr, ttr)
    want = jvideo.eval_render(params, jtr.spec, j_occ, jtr.rcfg, jrays,
                              cano=cano, optimize_pose=pose, max_chunk=CHUNK)
    got = video.eval_render(ttr.field, t_occ, ttr.rcfg, trays, cano=cano,
                            optimize_pose=pose, max_chunk=CHUNK,
                            draws=_draws(jcfg, 342))
    _check(got, want)
    assert (want[2] > 0.01).any()          # the frame sees the object


def test_background_net_matches_jax(with_bg):
    """bg_color None renders the background net behind a canonical virtual
    view (renderer.py:231-236)."""
    jcfg, jtr, params, j_occ, ttr, t_occ = with_bg
    jrays, trays = _rays("virtual", jcfg, jtr, ttr)
    n = 256

    @functools.partial(jax.jit, static_argnames=("spec", "cfg"))
    def jrender(params, occ, key, o, d, t, i, spec, cfg):
        return jrenderer.render_rays(params, spec, occ, key, o, d, t, i, cfg,
                                     bg_color=None, cano=True,
                                     real_view=False, train=False)

    jout = jrender(
        params, j_occ, jax.random.PRNGKey(0),
        *(jrays[k][:n] for k in ("rays_o", "rays_d", "rays_t", "rays_id")),
        spec=jtr.spec, cfg=jrenderer.RenderConfig(**{
            **jtr.rcfg.__dict__, "compute_normals": False}))
    tcfg = dataclasses.replace(ttr.rcfg, compute_normals=False)
    tout = renderer.render_rays(
        ttr.field, t_occ, _draws(jcfg, n)(),
        *(trays[k][:n] for k in ("rays_o", "rays_d", "rays_t", "rays_id")),
        tcfg, bg_color=None, cano=True, real_view=False, train=False)
    _check([tout[k].detach().numpy() for k in ("image", "depth", "opacity")],
           [jout[k] for k in ("image", "depth", "opacity")])
    white = renderer.render_rays(
        ttr.field, t_occ, _draws(jcfg, n)(),
        *(trays[k][:n] for k in ("rays_o", "rays_d", "rays_t", "rays_id")),
        tcfg, bg_color=None, cano=True, real_view=True, train=False)
    # the real view keeps the white background: the net changed the image
    assert not torch.allclose(tout["image"], white["image"])


def test_pose_correction_matches_jax():
    """The learned 6-DoF correction of the real-view rays (rotation and
    translation) at atol 1e-6."""
    rng = np.random.default_rng(4)
    pose = (0.2 * rng.standard_normal((4, 6))).astype(np.float32)
    o = rng.standard_normal((50, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    ids = rng.integers(0, 4, 50)
    want = jfield.pose_optimisation({"pose": jnp.asarray(pose)},
                                    jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(ids, jnp.int32))
    f = Field(FieldSpec(num_frames=4), "cpu")
    with torch.no_grad():
        f.pose.copy_(torch.as_tensor(pose))
    got = f.pose_optimisation(torch.as_tensor(o), torch.as_tensor(d),
                              torch.as_tensor(ids))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_test_video_renders_the_ema_weights(plain, tmp_path):
    """render_test_video draws trainer.ema_field (the EMA weights), not the
    live field."""
    jcfg, jtr, params, j_occ, ttr, t_occ = plain
    ttr.occ = t_occ
    ttr.epoch = 3
    with torch.no_grad():
        for p in ttr.params:                  # live weights drift away
            p.add_(0.5)
    rgb, _ = video.render_test_video(ttr, str(tmp_path), "test_real",
                                     real_view=True)
    img, _, _ = video.eval_render(ttr.ema_field, t_occ, ttr.rcfg,
                                  data.full_frame_rays(ttr.data, 4, 0),
                                  optimize_pose=True)
    want = (np.clip(img.reshape(32, 32, 3), 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(rgb[0], want)
    assert (tmp_path / "test_real_ep0003_rgb.mp4").exists()
    assert (tmp_path / "test_real_ep0003_depth.mp4").exists()
