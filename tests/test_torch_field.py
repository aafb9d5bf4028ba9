"""The port's field (model/field.py) against the JAX field: forward values
with extra normal sites, and the parameter gradients of a loss built on the
normals (the second-order path through the hash grid and the MLPs).

Tolerance: rtol 1e-4, and atol 1e-6 times the largest magnitude of the
compared array - the same float32 math in another summation order (matmul
blocking, histogram order), whose cancellation leaves absolute errors at the
scale of the summed terms. With bfloat16 payloads the grid gradients may
differ further by one bf16 rounding of each update summed into a slot, on
each side (2^-7 of the histogram of |cotangent|): each side rounds its own
float32 cotangent once, an error of at most 2^-8 of it, and cotangents that
differ at round-off can round apart by a whole bf16 ulp."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.model import field as jfield  # noqa: E402
from morpheus_tpu.ops import hashgrid as jhash  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.model.field import Field, FieldSpec  # noqa: E402
from morpheus_tpu_torch.ops import hashgrid  # noqa: E402
from morpheus_tpu_torch.ops.hashgrid import HashGridSpec  # noqa: E402

torch.set_num_threads(1)

GRID = dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
            log2_hashmap_size=10, desired_resolution=32)
FIELD = dict(num_frames=4, bound=1.01, bg_radius=0.0)


def _close(got, want, rtol=1e-4, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _specs(payload):
    jspec = jfield.FieldSpec(grid=jhash.HashGridSpec(**GRID,
                                                     grad_payload=payload),
                             **FIELD)
    tspec = FieldSpec(grid=HashGridSpec(**GRID, grad_payload=payload),
                      **FIELD)
    return jspec, tspec


def _inputs(seed=0, B=96, E=40):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.8, 0.8, (B, 3)).astype(np.float32)
    t = np.full((B, 1), 0.25, np.float32)
    light = rng.normal(size=(B, 3)).astype(np.float32)
    xe = rng.uniform(-0.8, 0.8, (E, 3)).astype(np.float32)
    wn = rng.normal(size=(B, 3)).astype(np.float32)
    we = rng.normal(size=(E, 3)).astype(np.float32)
    return x, t, light, xe, wn, we


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_field_forward_and_normal_grads_match_jax(payload, monkeypatch):
    jspec, tspec = _specs(payload)
    params = jfield.init_field(jax.random.PRNGKey(4), jspec)
    # O(1) grid values and a first layer that reads the grid, so the hash
    # grid's second-order path carries weight
    params["sdf_grid"] = params["sdf_grid"] * 1e3
    params["color_grid"] = params["color_grid"] * 1e3
    w0 = params["sdf_net"]["w"][0]
    params["sdf_net"]["w"][0] = w0 + 0.1 * jax.random.normal(
        jax.random.PRNGKey(5), w0.shape)
    x, t, light, xe, wn, we = _inputs()
    ml = 0.875

    def jloss(p):
        out = jfield.forward(p, jspec, jnp.asarray(x), jnp.asarray(t),
                             light_d=jnp.asarray(light), ratio=0.3,
                             shading_id=jfield.SHADING_LAMBERTIAN,
                             max_level=ml, extra_normal_x=jnp.asarray(xe))
        sdf, sigma, color, n, deform, n_raw, n_e = out
        loss = (jnp.sum(sdf ** 2) + jnp.sum(color) + jnp.sum(n * wn)
                + jnp.sum(n_e * we) + jnp.sum(n_raw ** 2) * 1e-2)
        return loss, out

    (j_l, j_out), j_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    f = Field(tspec, "cpu")
    f.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    named = list(f.named_parameters())

    def tforward():
        out = f(torch.as_tensor(x), torch.as_tensor(t),
                light_d=torch.as_tensor(light), ratio=0.3, shading_id=1,
                max_level=ml, extra_normal_x=torch.as_tensor(xe))
        sdf, sigma, color, n, deform, n_raw, n_e = out
        loss = ((sdf ** 2).sum() + color.sum()
                + (n * torch.as_tensor(wn)).sum()
                + (n_e * torch.as_tensor(we)).sum() + (n_raw ** 2).sum() * 1e-2)
        return loss, out

    def tgrads(loss):
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        return convert.params_to_jax(
            {k: (torch.zeros_like(p) if g is None else g)
             for (k, p), g in zip(named, grads)})

    t_l, out = tforward()
    for a, b in zip(out, j_out):
        _close(a.detach().numpy(), b)
    np.testing.assert_allclose(t_l.item(), float(j_l), rtol=1e-5)

    got = tgrads(t_l)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, j_g)))
    habs = {}
    if payload == "bfloat16":
        # the same gradients with each histogram summing |cotangent|
        orig = hashgrid.level_histogram
        with monkeypatch.context() as m:
            m.setattr(hashgrid, "level_histogram", lambda idx, vals, st, n,
                      **kw: orig(idx, vals.abs(), st, n, **kw))
            habs = tgrads(tforward()[0])
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        key = path[0].key
        if key in ("sdf_grid", "color_grid") and habs:
            w = want[path]
            err = np.abs(g - w)
            bound = (2.0 ** -7 * habs[key] + 1e-4 * np.abs(w)
                     + 1e-6 * max(1.0, np.abs(w).max()))
            assert (err <= bound).all(), (key, float(err.max()))
        else:
            _close(g, want[path], msg=jax.tree_util.keystr(path))

def test_query_density_and_with_spec_view():
    jspec, tspec = _specs("float32")
    params = jfield.init_field(jax.random.PRNGKey(1), jspec)
    f = Field(tspec, "cpu")
    f.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    x, *_ = _inputs(1)
    # nearest interpolation + static truncation, as the occupancy queries use
    jn = dataclasses.replace(jspec, active_levels=2, grid=dataclasses.replace(
        jspec.grid, interpolation="nearest"))
    tn = dataclasses.replace(tspec, active_levels=2, grid=dataclasses.replace(
        tspec.grid, interpolation="nearest"))
    want = jfield.query_density(params, jn, jnp.asarray(x), t=0.5,
                                return_color=False)["sigma"]
    got = f.with_spec(tn).query_density(torch.as_tensor(x),
                                        t=torch.tensor(0.5),
                                        return_color=False)["sigma"]
    _close(got.detach().numpy(), want, rtol=1e-5)
    assert f.spec is tspec          # the view left the field's spec alone
