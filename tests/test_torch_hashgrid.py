"""The port's hash grid (ops/hashgrid.py) and level histogram (ops/hist.py)
against the JAX package, on the CPU.

Tolerances, stated per test:
- level_histogram_reference vs hist_pallas.level_histogram (interpret mode):
  rtol 1e-5, atol 1e-6 plus 1e-6 of the slot's sum of |values| - float32
  sums in another order (one slot may take every update of its level);
- corner indices: bit-equal;
- encode with float32 payloads: rtol 2e-5, atol 1e-6, as the JAX package's
  own vjp-mode goldens (tests/test_hashgrid.py:164); the second-order
  embedding gradient at atol 1e-6 of its largest magnitude;
- encode with bfloat16 payloads: embedding gradients within one bf16 ulp of
  each update summed into a slot, on each side (2^-7 of the histogram of
  |cotangent|) - each side rounds its own float32 cotangent once, an error
  of at most 2^-8 of it (bf16 keeps 8 significant bits);
- encode under the other vjp_modes: the same, against JAX under the same
  mode, except that the input gradient's atol is 1e-6 of its largest
  magnitude (its per-corner terms of that size cancel) and the 'sort' mode
  takes its JAX golden's rtol 1e-3, atol 1e-5 (JAX sums by cumsum);
  (tests/hashgrid_parity.py holds the encode check).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.ops import hashgrid as jhash  # noqa: E402
from morpheus_tpu.ops import hist_pallas  # noqa: E402
from morpheus_tpu_torch import trace  # noqa: E402
from morpheus_tpu_torch.ops import hashgrid, hist  # noqa: E402
from hashgrid_parity import (GRIDS, _check_encode,  # noqa: E402
                             _emb_and_points)

torch.set_num_threads(1)


def launches(kernel: str) -> float:
    """The kernel's launches so far: its wrapper's host counter
    (trace.py's "<kernel>.launches")."""
    return trace.counts().get(kernel + ".launches", 0.0)


def _clustered(rng, L, Np, size):
    """Runs of one row, of random length 1-64, each run's row uniform random
    (as a ray's neighbouring samples in one cell of a coarse level)."""
    out = []
    for _ in range(L):
        ends = np.cumsum(rng.integers(1, 65, Np))
        run = np.searchsorted(ends, np.arange(Np), side="right")
        out.append(rng.integers(0, size, Np)[run])
    return np.stack(out).astype(np.int32)


# C=2 and 4 (hashed levels), 16 and 32 (the packed dense prefix) are the
# kernel's vector widths; 8 takes its generic path
@pytest.mark.parametrize("C", [2, 4, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float32_round"])
@pytest.mark.parametrize("stream", ["random", "one_slot", "clustered"])
def test_level_histogram_matches_pallas(C, dtype, stream):
    """float32_round: an f32 payload with round_bf16, against JAX on the
    bf16-rounded payload."""
    rng = np.random.default_rng(C)
    L, Np, t_pad = 3, 1500, 256
    if stream == "one_slot":
        idx = np.full((L, Np), 7, np.int32)
    elif stream == "clustered":
        idx = _clustered(rng, L, Np, t_pad)
    else:
        idx = rng.integers(0, t_pad, (L, Np)).astype(np.int32)
    vals = rng.standard_normal((L * Np, C)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = hist_pallas.level_histogram(
        jnp.asarray(idx), tuple(jnp.asarray(vals[:, c].reshape(L, Np), jd)
                                for c in range(C)), t_pad, interpret=True)
    rnd = dtype == "float32_round"
    tv = torch.as_tensor(vals).to(torch.bfloat16 if dtype == "bfloat16"
                                  else torch.float32)
    before = launches("level_histogram")
    got = hist.level_histogram(torch.as_tensor(idx), tv,
                               [l * t_pad for l in range(L)], L * t_pad,
                               round_bf16=rnd)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launches("level_histogram") == before
    habs = hist.level_histogram_reference(
        torch.as_tensor(idx), tv.abs(), [l * t_pad for l in range(L)],
        L * t_pad, round_bf16=rnd)
    to_jax = lambda t: t.reshape(L, t_pad, C).permute(2, 0, 1).numpy()
    err = np.abs(to_jax(got) - np.asarray(want))
    assert (err <= 1e-5 * np.abs(np.asarray(want)) + 1e-6
            + 1e-6 * to_jax(habs)).all(), err.max()


def test_level_histogram_checks_its_inputs():
    idx = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        hist.level_histogram(idx, torch.zeros((9, 2)), [0, 8], 16)
    with pytest.raises(ValueError):
        hist.level_histogram(idx.long(), torch.zeros((10, 2)), [0, 8], 16)
    with pytest.raises(ValueError):
        hist.level_histogram(idx.to("meta"), torch.zeros((10, 2),
                                                         device="meta"),
                             [0, 8], 16)


def test_spec_matches_jax_at_bench_width():
    kw = dict(input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
              log2_hashmap_size=15, desired_resolution=128)
    assert hashgrid.HashGridSpec(**kw).offsets == jhash.HashGridSpec(
        **kw).offsets
    assert hashgrid.HashGridSpec(**kw).resolutions == jhash.HashGridSpec(
        **kw).resolutions


def test_corner_index_bit_equal_on_hashed_levels():
    spec = jhash.HashGridSpec(num_levels=16, base_resolution=16,
                              log2_hashmap_size=15, desired_resolution=4096)
    tspec = hashgrid.HashGridSpec(num_levels=16, base_resolution=16,
                                  log2_hashmap_size=15,
                                  desired_resolution=4096)
    rng = np.random.default_rng(0)
    # coordinates up to 4095: coord * 3674653429 overflows 32 bits
    pos = rng.integers(0, 4096, (5000, 3)).astype(np.uint32)
    for res in (33, 129, 4096):
        want = jhash._corner_index(spec, jnp.asarray(pos), res, 32768)
        got = hashgrid.corner_index(tspec, torch.as_tensor(
            pos.astype(np.int64)), res, 32768)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_encode_matches_jax(grid, payload, monkeypatch):
    _check_encode(GRIDS[grid], payload, monkeypatch)


@pytest.mark.parametrize("mode", ["mxu_rows", "sort_pallas_rows",
                                  "sort_pallas", "sort", "level_scatter",
                                  "scatter"])
@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_encode_matches_jax_under_vjp_mode(mode, payload, monkeypatch):
    _check_encode(GRIDS["jax_golden"], payload, monkeypatch, gx_scaled=True,
                  vjp_mode=mode)


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_nearest_under_mxu_rows_matches_jax(payload, monkeypatch):
    """The occupancy queries' 'nearest' encode under mxu_rows, whose
    forward reads through the bf16 split."""
    _check_encode(GRIDS["packed_and_hashed"], payload, monkeypatch,
                  gx_scaled=True, vjp_mode="mxu_rows",
                  interpolation="nearest")


def _check_transpose_of_transpose(kw, seed, n, **mode):
    jspec = dataclasses.replace(jhash.HashGridSpec(**kw), **mode)
    tspec = dataclasses.replace(hashgrid.HashGridSpec(**kw), **mode)
    emb, x = _emb_and_points(kw, seed=seed, n=n)
    u = np.random.default_rng(1).standard_normal(emb.shape).astype(np.float32)

    def jf(e, xx):
        return jnp.sum(jnp.sin(jhash.encode(xx, e, jspec, bound=1.0)))

    want = jax.grad(lambda xx: jnp.sum(jax.grad(jf)(jnp.asarray(emb), xx)
                                       * u))(jnp.asarray(x))
    e = torch.tensor(emb, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    ge = torch.autograd.grad(torch.sin(hashgrid.encode(xt, e, tspec, 1.0))
                             .sum(), e, create_graph=True)[0]
    got = torch.autograd.grad((ge * torch.as_tensor(u)).sum(), xt)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


def test_hist_backward_is_the_gather():
    """Differentiating the embedding gradient (AccumulateRows) goes through
    GatherRows: d/dx of <grad_e, u> matches JAX's transpose of the
    transpose, on the packed prefix and the hashed tail."""
    _check_transpose_of_transpose(GRIDS["packed_and_hashed"], seed=5, n=61)


@pytest.mark.parametrize("mode,payload", [
    ("mxu_rows", "float32"), ("mxu_rows", "bfloat16"),
    ("sort_pallas_rows", "bfloat16")])
def test_accumulate_backward_is_the_route_gather(mode, payload):
    """The transpose of each route's accumulate is its gather again: under
    mxu_rows the bf16-split level_gather of the cotangent table (one plane
    under a bf16 payload), under sort_pallas_rows the row gather."""
    _check_transpose_of_transpose(GRIDS["jax_golden"], seed=6, n=61,
                                  vjp_mode=mode, grad_payload=payload)


def test_max_level_and_static_truncation_match_jax():
    kw = dict(input_dim=3, num_levels=8, level_dim=2, base_resolution=4,
              log2_hashmap_size=8, desired_resolution=64)
    jspec, tspec = jhash.HashGridSpec(**kw), hashgrid.HashGridSpec(**kw)
    emb, x = _emb_and_points(kw, seed=2, n=97)
    for ml, al in ((0.3, None), (0.5, 4), (0.875, 8), (0.875, None)):
        want = jhash.encode(jnp.asarray(x), jnp.asarray(emb), jspec, 1.0,
                            max_level=jnp.float32(ml), active_levels=al)
        got = hashgrid.encode(torch.tensor(x), torch.tensor(emb), tspec, 1.0,
                              max_level=ml, active_levels=al)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6)


def test_nearest_interpolation_matches_jax():
    kw = GRIDS["packed_and_hashed"]
    jspec = dataclasses.replace(jhash.HashGridSpec(**kw),
                                interpolation="nearest")
    tspec = dataclasses.replace(hashgrid.HashGridSpec(**kw),
                                interpolation="nearest")
    emb, x = _emb_and_points(kw, seed=4)
    want = jhash.encode(jnp.asarray(x), jnp.asarray(emb), jspec, 1.0)
    got = hashgrid.encode(torch.as_tensor(x), torch.as_tensor(emb), tspec,
                          1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
