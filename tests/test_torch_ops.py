"""The port's leaf modules against the JAX package, on the CPU: encodings,
density, codes, MLP, cameras, the synthetic scene, volume rendering, losses,
occupancy marching and sample compaction, the optimizer, the curriculum and
the parameter bridge.

Tolerance: rtol 1e-6 and atol 1e-6 unless a test says otherwise (the same
float32 formulas, evaluated by two libraries); the synthetic scene's
images, depths and masks are compared exactly, its camera poses to one
float32 ulp (XLA may fuse the look-at cross products).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu import cameras as jcam  # noqa: E402
from morpheus_tpu import utils as jutils  # noqa: E402
from morpheus_tpu.config import DEFAULTS as JAX_DEFAULTS  # noqa: E402
from morpheus_tpu.data.synthetic import make_synthetic_scene as jscene  # noqa: E402
from morpheus_tpu.model import field as jfield  # noqa: E402
from morpheus_tpu.ops import codes as jcodes  # noqa: E402
from morpheus_tpu.ops import density as jdensity  # noqa: E402
from morpheus_tpu.ops import encodings as jenc  # noqa: E402
from morpheus_tpu.ops import occupancy as jocc  # noqa: E402
from morpheus_tpu.ops import mlp as jmlp  # noqa: E402
from morpheus_tpu.ops import volrender as jvol  # noqa: E402
from morpheus_tpu.train import losses as jlosses  # noqa: E402
from morpheus_tpu.train import optim as joptim  # noqa: E402
from morpheus_tpu.train.schedule import Curriculum as JCurriculum  # noqa: E402
from morpheus_tpu.config import merge_defaults as jax_merge_defaults  # noqa: E402
from morpheus_tpu_torch import cameras, convert, utils  # noqa: E402
from morpheus_tpu_torch.config import DEFAULTS, merge_defaults  # noqa: E402
from morpheus_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from morpheus_tpu_torch.model.field import Field, FieldSpec  # noqa: E402
from morpheus_tpu_torch.ops import codes, density, encodings, occupancy  # noqa: E402
from morpheus_tpu_torch.ops import volrender  # noqa: E402
from morpheus_tpu_torch.ops.hashgrid import HashGridSpec  # noqa: E402
from morpheus_tpu_torch.ops.mlp import MLP  # noqa: E402
from morpheus_tpu_torch.train import losses, optim  # noqa: E402
from morpheus_tpu_torch.train.schedule import Curriculum  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def close(got, want, rtol=1e-6, atol=1e-6):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_config_defaults_match():
    assert DEFAULTS == JAX_DEFAULTS


@pytest.mark.parametrize("max_level", [None, 0.5, 0.6875, 0.875, 1.0])
def test_freq_encode(max_level):
    x = RNG.uniform(-1, 1, (33, 3)).astype(np.float32)
    ml = None if max_level is None else jnp.float32(max_level)
    want = jax.jit(lambda a, m: jenc.freq_encode(a, 6, m))(x, ml)
    close(encodings.freq_encode(torch.as_tensor(x), 6, max_level), want)


def test_laplace_density_and_beta():
    sdf = RNG.normal(size=(100,)).astype(np.float32) * 0.2
    for beta in (0.1, -0.05, 0.0):
        b = np.float32(beta)
        close(density.laplace_density(torch.as_tensor(sdf), torch.tensor(b)),
              jdensity.laplace_density(sdf, b), rtol=1e-5)
        close(density.laplace_beta(torch.tensor(b)), jdensity.laplace_beta(b))


def test_sample_multicode():
    vols = [RNG.normal(size=(s, 16)).astype(np.float32) for s in (1, 2, 8)]
    t = np.concatenate([RNG.uniform(0, 1, (20, 1)), [[0.0], [1.0], [-0.1],
                                                     [1.2]]]).astype(np.float32)
    close(codes.sample_multicode([torch.as_tensor(v) for v in vols],
                                 torch.as_tensor(t)),
          jcodes.sample_multicode([jnp.asarray(v) for v in vols], t))


@pytest.mark.parametrize("geo", [False, True])
def test_mlp_matches_apply_mlp(geo):
    p = jmlp.init_mlp(jax.random.PRNGKey(1), 49, 33, 64, 3, geo_init=geo,
                      geo_bias=0.4)
    m = MLP(49, 33, 64, 3)
    m.load_state_dict({k.split(".", 1)[1]: v for k, v in
                       convert.params_from_jax({"m": p}).items()})
    x = RNG.normal(size=(50, 49)).astype(np.float32)
    close(m(torch.as_tensor(x)), jmlp.apply_mlp(p, x), rtol=1e-5, atol=1e-5)


def test_mlp_init_distributions():
    g = torch.Generator().manual_seed(0)
    m = MLP(49, 33, 64, 3).reset(g, geo_init=True, geo_bias=0.4)
    w0 = m.layers[0].weight
    assert torch.all(w0[:, 3:] == 0) and torch.all(m.layers[0].bias == 0)
    assert torch.all(m.layers[-1].bias == -0.4)
    mean = np.sqrt(np.pi) / np.sqrt(64)
    assert abs(float(m.layers[-1].weight.detach().mean()) - mean) < 1e-4
    m2 = MLP(10, 3, 16, 2).reset(g)
    assert float(m2.layers[0].weight.abs().max()) <= 1 / np.sqrt(10)


def test_cameras():
    close(cameras.get_camera_rays(12, 16, 20.0),
          jcam.get_camera_rays(12, 16, 20.0), rtol=0, atol=0)
    K = np.array([[50.0, 0, 16], [0, 50.0, 12], [0, 0, 1]])
    close(cameras.scale_intrinsics(K, 0.5),
          jcam.scale_intrinsics(jnp.asarray(K, jnp.float32), 0.5), rtol=0,
          atol=0)
    r = np.array([2.5, 2.0], np.float32)
    th = np.array([90.0, 60.0], np.float32)
    ph = np.array([0.0, 37.5], np.float32)
    close(cameras.c2w_from_polar(r, th, ph), jcam.c2w_from_polar(r, th, ph))
    e = RNG.normal(size=(7, 3)).astype(np.float32)
    close(cameras.euler_to_rotation(torch.as_tensor(e)),
          jcam.euler_to_rotation(e))
    v = RNG.normal(size=(9, 3)).astype(np.float32)
    close(utils.safe_normalize(torch.as_tensor(v)), jutils.safe_normalize(v))


def test_synthetic_scene_exact():
    got, want = make_synthetic_scene(5, 24, 20), jscene(5, 24, 20)
    assert set(got) == set(want)
    for k in got:
        if k == "poses":
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_params_bridge_round_trip():
    spec = jfield.FieldSpec(num_frames=8, bg_radius=1.4, use_app=True)
    params = jax.tree.map(np.asarray,
                          jfield.init_field(jax.random.PRNGKey(0), spec))
    f = Field(FieldSpec(num_frames=8, bg_radius=1.4, use_app=True), "cpu")
    f.load_state_dict(convert.params_from_jax(params))     # names and shapes
    back = convert.params_to_jax(f)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(flat)
    for path, a in got:
        np.testing.assert_array_equal(a, flat[path])


def _stream(N=9, K=6, seed=1):
    """A ray-sorted stream with empty rays and rays of up to K samples."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, N)
    counts[2] = 0
    ray_id = np.repeat(np.arange(N), counts).astype(np.int32)
    B = ray_id.shape[0]
    t0 = np.sort(rng.uniform(0, 3, B)).astype(np.float32)
    t1 = (t0 + 0.01).astype(np.float32)
    sig = rng.uniform(0, 50, B).astype(np.float32)
    valid = rng.uniform(size=B) > 0.2
    vals = rng.normal(size=(B, 3)).astype(np.float32)
    return N, K, ray_id, t0, t1, sig, valid, vals


def test_flat_volume_rendering():
    N, K, ray_id, t0, t1, sig, valid, vals = _stream()
    starts_j = jvol.segment_starts(jnp.asarray(ray_id), N)
    w_j, tr_j, a_j = jvol.flat_render_weights(t0, t1, sig, valid, ray_id)
    rid = torch.as_tensor(ray_id).long()
    starts = volrender.segment_starts(rid, N)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_j))
    seg = volrender.Segments(rid, starts, K)
    w, trans, a = volrender.flat_render_weights(
        torch.as_tensor(t0), torch.as_tensor(t1), torch.as_tensor(sig),
        torch.as_tensor(valid), seg)
    for g, j in ((w, w_j), (trans, tr_j), (a, a_j)):
        close(g, j, rtol=1e-5)
    close(volrender.flat_accumulate(w, torch.as_tensor(vals), seg),
          jvol.flat_accumulate(w_j, vals, ray_id, starts_j), rtol=1e-5)
    close(volrender.flat_accumulate(w, None, seg),
          jvol.flat_accumulate(w_j, None, ray_id, starts_j), rtol=1e-5)
    x = torch.as_tensor(vals[:, 0])
    close(volrender.seg_cumsum(x, seg),
          jvol.seg_cumsum(vals[:, 0], jnp.concatenate(
              [jnp.ones(1, bool), ray_id[1:] != ray_id[:-1]])), rtol=1e-5)


class _Fixed:
    """A draw source that returns one fixed array."""

    def __init__(self, a):
        self.a = a

    def uniform(self, name, shape):
        assert tuple(shape) == self.a.shape, (name, shape)
        return torch.as_tensor(self.a)


@pytest.mark.parametrize("grid", ["fresh", "random"])
def test_march_and_compaction_match_jax(grid):
    """march_rays + compact_samples on fed-in jitter: ray ids, validity,
    sample starts and ends and segment starts are equal, the march scores
    within rtol 1e-6. A fresh grid (all
    cells occupied, scores equal across rays) exercises the tie rule: the
    lower flat index wins in both."""
    rng = np.random.default_rng(5)
    N, R, M, K, B, bound = 40, 8, 48, 12, 150, 1.0
    o = rng.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    d = (rng.uniform(-0.3, 0.3, (N, 3)) - o / 2.5).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    occs = (np.zeros(R ** 3, np.float32) if grid == "fresh" else
            (rng.uniform(0, 1, R ** 3) ** 4 * 0.05).astype(np.float32))
    binaries = np.ones((R,) * 3, bool)
    js = jocc.OccupancyState(jnp.asarray(occs), jnp.asarray(binaries))
    ts = occupancy.OccupancyState(torch.as_tensor(occs),
                                  torch.as_tensor(binaries))
    # the key only feeds the jitter: hand JAX's draw to the port
    key = jax.random.PRNGKey(2)
    jit = np.asarray(jax.random.uniform(key, (N, 1)))
    want = jocc.march_rays(key, js, jnp.asarray(o), jnp.asarray(d), bound,
                           0.05, M, K, return_score=True, occ_threshold=0.01)
    got = occupancy.march_rays(_Fixed(jit), ts, torch.as_tensor(o),
                               torch.as_tensor(d), bound, 0.05, M, K,
                               occ_threshold=0.01)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the scores go through exp/expm1 of two libraries
    close(got[3], want[3], rtol=1e-6, atol=0)
    assert int(got[2].sum()) > B and (grid == "fresh" or
                                      int(got[2].sum()) < N * K)
    cw = jocc.compact_samples(*want, B)
    cg = occupancy.compact_samples(*got, B)
    for k in ("ray_id", "valid", "t_starts", "t_ends", "starts"):
        np.testing.assert_array_equal(cg[k].numpy(), np.asarray(cw[k]),
                                      err_msg=k)


def test_losses():
    N, K, ray_id, t0, t1, sig, valid, vals = _stream(seed=2)
    rng = np.random.default_rng(3)
    tm = (0.5 * (t0 + t1)).astype(np.float32)
    depth = rng.uniform(-0.5, 3, N).astype(np.float32)
    depth[1] = 0.0
    sdf = rng.normal(size=tm.shape).astype(np.float32) * 0.1
    rmask = (rng.uniform(size=N) > 0.3).astype(np.float32)
    rid = torch.as_tensor(ray_id).long()
    seg = volrender.Segments(rid, volrender.segment_starts(rid, N), K)
    got = losses.sdf_losses_flat(torch.as_tensor(tm), torch.as_tensor(depth),
                                 torch.as_tensor(sdf), 0.1,
                                 torch.as_tensor(valid), seg,
                                 ray_mask=torch.as_tensor(rmask))
    want = jlosses.sdf_losses_flat(tm, depth, sdf, 0.1, valid, ray_id,
                                   jvol.segment_starts(jnp.asarray(ray_id), N),
                                   ray_mask=rmask)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5)
    n = rng.normal(size=(ray_id.shape[0], 3)).astype(np.float32)
    d = rng.normal(size=(ray_id.shape[0], 3)).astype(np.float32)
    w8 = rng.uniform(size=ray_id.shape[0]).astype(np.float32)
    T = torch.as_tensor
    close(losses.orientation_loss_flat(T(w8), T(n), T(d), T(valid), N),
          jlosses.orientation_loss_flat(w8, n, d, valid, N), rtol=1e-5)
    close(losses.normal_perturb_loss(T(n), T(d), T(valid)),
          jlosses.normal_perturb_loss(n, d, valid), rtol=1e-5)
    close(losses.eikonal_loss(T(n), T(valid)),
          jlosses.eikonal_loss(n, valid), rtol=1e-5)
    op = rng.uniform(size=N).astype(np.float32)
    close(losses.mask_loss(T(op), T(rmask)), jlosses.mask_loss(op, rmask),
          rtol=1e-5)
    ro = rng.normal(size=(N, 3)).astype(np.float32) * 0.3
    rd = rng.normal(size=(N, 3)).astype(np.float32) * 0.3
    close(losses.depth_loss(T(op), T(depth), T(ro), T(rd), T(rmask)),
          jlosses.depth_loss(op, depth, ro, rd, rmask), rtol=1e-5)
    c = [rng.normal(size=(1, 48)).astype(np.float32) for _ in range(3)]
    close(losses.code_smoothness(*map(T, c)), jlosses.code_smoothness(*c),
          rtol=1e-5)


def test_adam_matches_adam_update_and_skips_non_finite():
    params = {"sdf_grid": RNG.normal(size=(50, 2)).astype(np.float32),
              "beta": np.float32(0.1),
              "pose": RNG.normal(size=(4, 6)).astype(np.float32)}
    names = list(params)
    tp = [torch.nn.Parameter(torch.as_tensor(np.array(params[k])))
          for k in names]
    opt = optim.Adam(list(zip(names, tp)))
    jstate = joptim.adam_init(params)
    jp = jax.tree.map(jnp.asarray, params)
    for step in range(3):
        g = {k: RNG.normal(size=np.shape(v)).astype(np.float32)
             for k, v in params.items()}
        lr = np.float32(5e-4 * (step + 1))
        jstate, jp = joptim.adam_update(jstate, g, jp, lr, 0.0)
        opt.update([torch.as_tensor(g[k]) for k in names], lr)
        for k, p in zip(names, tp):
            close(p, jp[k], rtol=1e-6, atol=1e-7)
    # a non-finite gradient leaves the parameters and the moments unchanged
    before = [p.detach().clone() for p in tp]
    mu = [m.clone() for m in opt.mu]
    bad = [torch.full_like(p, float("nan")) for p in tp]
    assert not bool(opt.update(bad, 1e-3))
    assert all(torch.equal(a, b) for a, b in zip(before, tp))
    assert all(torch.equal(a, b) for a, b in zip(mu, opt.mu))
    assert float(opt.step) == 3.0


def test_ema_update():
    e = [torch.ones(3)]
    optim.ema_update(e, [torch.zeros(3)], 0.95)
    close(e[0], joptim.ema_update([jnp.ones(3)], [jnp.zeros(3)], 0.95)[0])


def test_curriculum_matches_jax():
    cfg = {"train": {"n_epochs": 400, "warm_up_end": 100, "lr": 5e-4}}
    jc = JCurriculum.from_config(jax_merge_defaults(cfg))
    tc = Curriculum.from_config(merge_defaults(cfg))
    for epoch in (0, 1, 50, 99, 100, 150, 300, 301, 399, 400):
        assert tc.learning_rate(epoch) == np.float32(jc.learning_rate(epoch))
        assert tc.max_level(epoch) == np.float32(jc.max_level(epoch))
        assert tuple(np.float32(w) for w in tc.loss_weights(epoch)) == tuple(
            np.float32(w) for w in jc.loss_weights(epoch))


def test_hash_spec_rejects_other_vjp_modes():
    """The seven JAX vjp_mode names are taken (JAX hashgrid.py:385-404);
    an unknown name raises ValueError."""
    for mode in ("hist_rows", "mxu_rows", "sort_pallas_rows", "sort_pallas",
                 "sort", "level_scatter", "scatter"):
        assert HashGridSpec(vjp_mode=mode).vjp_mode == mode
    with pytest.raises(ValueError, match="vjp_mode"):
        HashGridSpec(vjp_mode="one_hot")


@pytest.mark.parametrize("interpolation", ["smoothstep", "cubic"])
def test_hash_spec_rejects_other_interpolations(interpolation):
    """The JAX package's interpolations are taken - smoothstep's weights
    match JAX on the lattice's fractions (the encode itself:
    tests/test_torch_grid_modes.py) - and a name it does not define
    raises ValueError."""
    if interpolation == "cubic":
        with pytest.raises(ValueError, match="interpolation"):
            HashGridSpec(interpolation=interpolation)
        return
    from morpheus_tpu_torch.ops import hashgrid
    spec = HashGridSpec(interpolation=interpolation)
    assert spec.interpolation == "smoothstep"
    f = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    lv = hashgrid._levels(spec, 0, 1, 8, torch.device("cpu"))
    pos = torch.as_tensor(np.stack([f, f * 0.5, 1 - f], -1))[None]
    w = hashgrid._corner_weights(pos, torch.zeros_like(pos), lv,
                                 smoothstep=True)
    s = f * f * (3.0 - 2.0 * f)
    want = [(s if c & 1 else 1 - s)
            * (s2 if c & 2 else 1 - s2) * (s3 if c & 4 else 1 - s3)
            for c in range(8)
            for s2, s3 in [((f * 0.5) ** 2 * (3 - f), (1 - f) ** 2
                            * (3 - 2 * (1 - f)))]]
    close(w[0], np.stack(want), rtol=1e-6, atol=1e-7)
