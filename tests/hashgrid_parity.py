"""The hash-grid encode parity check shared by tests/test_torch_hashgrid.py
and tests/test_torch_grid_modes.py: the port's encode against the JAX
package's under the same spec, values, gradients and the second-order
embedding gradient (tolerances: the docstrings of those two files)."""
import dataclasses

import numpy as np
import torch
import jax
import jax.numpy as jnp

from morpheus_tpu.ops import hashgrid as jhash
from morpheus_tpu_torch.ops import hashgrid

# tests/test_hashgrid.py:148-150 (all hashed), and a grid with a packed
# dense prefix (8^3 <= 1024 rows) followed by a hashed tail
GRIDS = {
    "jax_golden": dict(input_dim=3, num_levels=4, level_dim=2,
                       base_resolution=4, log2_hashmap_size=6,
                       desired_resolution=16),
    "packed_and_hashed": dict(input_dim=3, num_levels=4, level_dim=2,
                              base_resolution=8, log2_hashmap_size=10,
                              desired_resolution=32),
}


def _emb_and_points(kw, seed=3, n=257):
    key = jax.random.PRNGKey(seed)
    emb = np.asarray(jhash.init_embeddings(key, jhash.HashGridSpec(**kw))
                     * 1e4)
    x = np.asarray(jax.random.uniform(key, (n, 3), minval=-0.9, maxval=0.9))
    # exact lattice borders, where clamped +1 corners carry zero weight
    x = np.concatenate([x, [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                            [1.0, -1.0, 0.0]]]).astype(np.float32)
    return np.array(emb), x


def _abs_hist_grad(monkeypatch, fn, e):
    """Gradient of fn() in e with every accumulated payload (histogram or
    sorted segment sum) replaced by its absolute value: per table slot, the
    sum of |cotangent| into it."""
    hist_fn, segsum_fn = hashgrid.level_histogram, hashgrid.segment_sum_sorted
    with monkeypatch.context() as m:
        m.setattr(hashgrid, "level_histogram", lambda idx, vals, starts, n,
                  **kw: hist_fn(idx, vals.abs(), starts, n, **kw))
        m.setattr(hashgrid, "segment_sum_sorted", lambda keys, vals, size,
                  **kw: segsum_fn(keys, vals.abs(), size, **kw))
        return torch.autograd.grad(fn(), e)[0].numpy()


def _check_encode(kw, payload, monkeypatch, gx_scaled=False, bf16=False,
                  **mode):
    """encode's values, embedding and input gradients, and the second-order
    embedding gradient of sum((d encode / dx)^2), against JAX under the same
    spec; `mode` sets vjp_mode, interpolation, gridtype or align_corners on
    both; bf16 gathers from the bfloat16 table (compute_dtype). gx_scaled
    takes the input gradient's atol relative to its largest magnitude, as
    for the second-order gradient: each entry sums per-corner terms of that
    size that cancel, and the port sums them in another order than JAX."""
    jspec = dataclasses.replace(jhash.HashGridSpec(**kw, grad_payload=payload),
                                **mode)
    tspec = dataclasses.replace(
        hashgrid.HashGridSpec(**kw, grad_payload=payload), **mode)
    emb, x = _emb_and_points(kw)
    # JAX's cumsum-based 'sort' route sums long runs with more round-off
    # (its own golden test's tolerance, tests/test_hashgrid.py:164)
    rtol, atol = ((1e-3, 1e-5) if tspec.vjp_mode == "sort"
                  else (2e-5, 1e-6))
    # the payload is rounded only where a route accumulates through a kernel
    rounded = (payload == "bfloat16"
               and tspec.vjp_mode in ("hist_rows", "mxu_rows",
                                      "sort_pallas_rows"))
    # a bf16 table's cotangent is bf16 except under mxu_rows (f32 gather)
    bf16_ct = bf16 and tspec.vjp_mode != "mxu_rows"
    rounded = rounded or bf16_ct
    ulps = 2.0 ** -8 if bf16_ct else 2.0 ** -7
    jdt = jnp.bfloat16 if bf16 else None
    tdt = torch.bfloat16 if bf16 else None

    def jenc(xx, e):
        return jhash.encode(xx, e, jspec, bound=1.0, compute_dtype=jdt)

    def tenc(xx, e):
        return hashgrid.encode(xx, e, tspec, bound=1.0, compute_dtype=tdt)

    def jf(e, xx):
        return jnp.sum(jnp.sin(jenc(xx, e)) ** 2)

    def jg2(e):
        n = jax.grad(lambda xx: jnp.sum(jenc(xx, e)))(x)
        return jnp.sum(n ** 2)

    j_out = jenc(jnp.asarray(x), jnp.asarray(emb))
    j_ge, j_gx = jax.grad(jf, argnums=(0, 1))(jnp.asarray(emb),
                                             jnp.asarray(x))
    j_h = jax.grad(jg2)(jnp.asarray(emb))

    e = torch.tensor(emb, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tenc(xt, e)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=2e-5, atol=1e-6)

    def tf():
        return (torch.sin(tenc(xt, e)) ** 2).sum()

    ge, gx = torch.autograd.grad(tf(), (e, xt), materialize_grads=True)
    np.testing.assert_allclose(
        gx.numpy(), np.asarray(j_gx), rtol=rtol,
        atol=atol * max(1.0, np.abs(np.asarray(j_gx)).max()) if gx_scaled
        else atol)
    # 'nearest' rounds x to a corner: no input gradient, no second order
    second_order = tspec.interpolation != "nearest"

    def tg2():
        n = torch.autograd.grad(tenc(xt, e).sum(), xt, create_graph=True)[0]
        return (n ** 2).sum()

    h = torch.autograd.grad(tg2(), e)[0] if second_order else None
    if not rounded:
        np.testing.assert_allclose(ge.numpy(), np.asarray(j_ge), rtol=rtol,
                                   atol=atol)
        # second order: terms of the largest gradient's size cancel, so
        # round-off is absolute at that scale (in float64 the JAX and the
        # port results both sit ~1.5e-6 of max|h| from the exact value)
        if second_order:
            np.testing.assert_allclose(
                h.numpy(), np.asarray(j_h), rtol=rtol,
                atol=atol * np.abs(np.asarray(j_h)).max())
    else:
        checks = ((ge, j_ge, tf), (h, j_h, tg2))[:1 + second_order]
        for got, want, fn in checks:
            if bf16_ct:
                # rounded to bf16 where JAX rounds it, and only there: the
                # f32 table's gradient holds bf16 values
                assert torch.equal(got, got.bfloat16().float())
            bound = ulps * _abs_hist_grad(monkeypatch, fn, e) + 1e-6
            err = np.abs(got.numpy() - np.asarray(want))
            assert (err <= bound + 2e-5 * np.abs(np.asarray(want))).all()
