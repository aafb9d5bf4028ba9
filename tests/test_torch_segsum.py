"""The port's sorted segment sum (ops/segsum.py) against the JAX package's
segsum_pallas, run in interpret mode on the CPU.

Tolerance per table slot: 1e-5 of the slot's sum of |values| plus 1e-6 -
float32 sums of the same (already rounded) values in another order; one
slot may take a whole stream. The route form (the payload read through the
sort's order, rounded to bf16 in the load) is held against the TPU kernel on
the stream that numpy sorted, permuted and rounded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.ops import segsum_pallas  # noqa: E402
from morpheus_tpu_torch import trace  # noqa: E402
from morpheus_tpu_torch.ops import hashgrid, segsum  # noqa: E402

torch.set_num_threads(1)


def launches(kernel: str) -> float:
    """The kernel's launches so far: its wrapper's host counter
    (trace.py's "<kernel>.launches")."""
    return trace.counts().get(kernel + ".launches", 0.0)

N, SIZE = 5000, 300      # N not a multiple of the TPU block (2048), SIZE
                         # not a multiple of its 256-slot window span


def _stream(kind, rng):
    if kind == "random":
        return np.sort(rng.integers(0, SIZE, N))
    if kind == "one_slot":
        return np.full(N, 7)
    if kind == "seam_runs":
        # runs over the 2048 and 4096 block seams (1900-2199, 4000-4399)
        keys = np.sort(rng.choice(SIZE, 5, replace=False))
        return np.repeat(keys, [1900, 300, 1800, 400, N - 4400])
    # "last_slot": the TPU kernel's padding slot is the last one
    idx = np.sort(rng.integers(0, SIZE, N))
    idx[-100:] = SIZE - 1
    return idx


def _check_slots(got, want, habs):
    err = np.abs(got - want)
    assert (err <= 1e-5 * habs + 1e-6).all(), err.max()


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stream", ["random", "one_slot", "seam_runs",
                                    "last_slot"])
def test_segment_sum_sorted_matches_pallas(C, dtype, stream):
    rng = np.random.default_rng(C)
    idx = _stream(stream, rng).astype(np.int32)
    vals = rng.standard_normal((N, C)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = segsum_pallas.segment_sum_sorted(
        jnp.asarray(idx), tuple(jnp.asarray(vals[:, c], jd) for c in range(C)),
        SIZE, interpret=True)
    tv = torch.as_tensor(vals).to(getattr(torch, dtype))
    before = launches("segment_sum_sorted")
    got = segsum.segment_sum_sorted(torch.as_tensor(idx), tv, SIZE)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launches("segment_sum_sorted") == before
    assert got.shape == (SIZE, C) and got.dtype == torch.float32
    habs = segsum.segment_sum_sorted_reference(torch.as_tensor(idx),
                                               tv.abs(), SIZE)
    _check_slots(got.numpy().T, np.asarray(want), habs.numpy().T)


@pytest.mark.parametrize("C", [2, 4])
def test_segment_sum_unsorted_matches_pallas(C):
    rng = np.random.default_rng(10 + C)
    idx = rng.integers(0, SIZE, N).astype(np.int32)
    vals = rng.standard_normal((N, C)).astype(np.float32)
    want = segsum_pallas.segment_sum_unsorted(
        jnp.asarray(idx), tuple(jnp.asarray(vals[:, c]) for c in range(C)),
        SIZE, interpret=True)
    got = segsum.segment_sum_unsorted(torch.as_tensor(idx),
                                      torch.as_tensor(vals), SIZE)
    habs = segsum.segment_sum_sorted_reference(
        torch.as_tensor(idx), torch.as_tensor(np.abs(vals)), SIZE)
    _check_slots(got.numpy().T, np.asarray(want), habs.numpy().T)


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "float32_round", "bfloat16"])
@pytest.mark.parametrize("stream", ["random", "one_slot", "seam_runs",
                                    "last_slot"])
def test_segment_sum_sorted_order_matches_pallas(C, dtype, stream):
    """The route form: keys and order from numpy's stable sort of the
    stream in a shuffled order; the payload in that unsorted order, f32
    (rounded to bf16 by the port under float32_round) or bf16."""
    rng = np.random.default_rng(20 + C)
    rows = rng.permutation(_stream(stream, rng)).astype(np.int32)
    order = np.argsort(rows, kind="stable")
    keys = rows[order]
    vals = rng.standard_normal((N, C)).astype(np.float32)
    rnd = dtype == "float32_round"
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = segsum_pallas.segment_sum_sorted(
        jnp.asarray(keys),
        tuple(jnp.asarray(vals[order, c], jd) for c in range(C)), SIZE,
        interpret=True)
    tv = torch.as_tensor(vals).to(torch.bfloat16 if dtype == "bfloat16"
                                  else torch.float32)
    kw = {"order": torch.as_tensor(order), "round_bf16": rnd}
    got = segsum.segment_sum_sorted(torch.as_tensor(keys), tv, SIZE, **kw)
    assert got.shape == (SIZE, C) and got.dtype == torch.float32
    habs = segsum.segment_sum_sorted_reference(torch.as_tensor(keys),
                                               tv.abs(), SIZE, **kw)
    _check_slots(got.numpy().T, np.asarray(want), habs.numpy().T)


@pytest.mark.parametrize("routed", [False, True])
def test_segment_sum_sorted_drops_keys_outside_the_table(routed):
    """Keys below 0 and at or past `size` add nothing; the rest match the
    TPU kernel on the in-range part of the stream."""
    rng = np.random.default_rng(30)
    rows = rng.integers(-40, SIZE + 40, N).astype(np.int32)
    order = np.argsort(rows, kind="stable")
    keys = rows[order]
    vals = rng.standard_normal((N, 2)).astype(np.float32)
    inside = (keys >= 0) & (keys < SIZE)
    assert 0 < inside.sum() < N
    want = segsum_pallas.segment_sum_sorted(
        jnp.asarray(keys[inside]),
        tuple(jnp.asarray(vals[order][inside, c]) for c in range(2)), SIZE,
        interpret=True)
    if routed:
        got = segsum.segment_sum_sorted(torch.as_tensor(keys),
                                        torch.as_tensor(vals), SIZE,
                                        order=torch.as_tensor(order))
    else:
        got = segsum.segment_sum_sorted(torch.as_tensor(keys),
                                        torch.as_tensor(vals[order]), SIZE)
    habs = segsum.segment_sum_sorted_reference(
        torch.as_tensor(keys[inside]),
        torch.as_tensor(np.abs(vals[order][inside])), SIZE)
    _check_slots(got.numpy().T, np.asarray(want), habs.numpy().T)


def test_segment_sum_unsorted_reads_through_the_order(monkeypatch):
    """segment_sum_unsorted hands the kernel the sort's keys and order and
    the f32 payload as it came, not a permuted copy."""
    rng = np.random.default_rng(40)
    idx = torch.as_tensor(rng.integers(0, SIZE, N).astype(np.int32))
    vals = torch.as_tensor(rng.standard_normal((N, 4)).astype(np.float32))
    seen = []
    real = segsum.segment_sum_sorted
    monkeypatch.setattr(segsum, "segment_sum_sorted",
                        lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw))
    segsum.segment_sum_unsorted(idx, vals, SIZE)
    (keys, payload, size), kw = seen[0]
    want_keys, want_order = torch.sort(idx, stable=True)
    assert size == SIZE and payload is vals
    assert torch.equal(keys, want_keys)
    assert torch.equal(kw["order"], want_order)


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sort_pallas_rows", "sort_pallas"])
def test_sorted_route_passes_the_cotangent_and_its_order(monkeypatch, mode,
                                                         payload):
    """The sort routes of the hash grid hand the kernel the unrounded f32
    cotangent and the sort's order, with round_bf16 where the payload is
    bf16 (sort_pallas keeps f32 payloads): no cast, no permuted copy."""
    spec = hashgrid.HashGridSpec(num_levels=3, log2_hashmap_size=8,
                                 base_resolution=4, vjp_mode=mode,
                                 grad_payload=payload)
    g = torch.Generator().manual_seed(0)
    emb = hashgrid.init_embeddings(g, spec, "cpu").requires_grad_()
    x = torch.rand((64, 3), generator=g) * 1.8 - 0.9
    seen = []
    real = hashgrid.segment_sum_sorted
    monkeypatch.setattr(hashgrid, "segment_sum_sorted",
                        lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw))
    torch.autograd.grad(hashgrid.encode(x, emb, spec).sum(), emb)
    (keys, ct, size), kw = seen[0]
    assert ct.dtype == torch.float32 and ct.shape == (keys.shape[0], 2)
    assert size == spec.table_size
    assert kw["round_bf16"] == (payload == "bfloat16"
                                and mode == "sort_pallas_rows")
    order = kw["order"]
    assert order.dtype == torch.int64
    assert torch.equal(torch.sort(order).values, torch.arange(len(order)))


def test_segment_sum_sorted_checks_its_inputs():
    idx = torch.zeros((5,), dtype=torch.int32)
    with pytest.raises(ValueError):
        segsum.segment_sum_sorted(idx, torch.zeros((4, 2)), 8)
    with pytest.raises(ValueError):
        segsum.segment_sum_sorted(idx.long(), torch.zeros((5, 2)), 8)
    with pytest.raises(ValueError):
        segsum.segment_sum_sorted(idx, torch.zeros((5, 2), dtype=torch.int32),
                                  8)
    with pytest.raises(ValueError):
        segsum.segment_sum_sorted(idx.to("meta"),
                                  torch.zeros((5, 2), device="meta"), 8)
    vals = torch.zeros((5, 2))
    for order in (torch.arange(5, dtype=torch.int32),        # dtype
                  torch.arange(4),                            # length
                  torch.arange(5, device="meta")):            # device
        with pytest.raises(ValueError):
            segsum.segment_sum_sorted(idx, vals, 8, order=order)
