"""The port's sorted segment sum (ops/segsum.py) against the JAX package's
segsum_pallas, run in interpret mode on the CPU.

Tolerance per table slot: 1e-5 of the slot's sum of |values| plus 1e-6 -
float32 sums of the same (already rounded) values in another order; one
slot may take a whole stream.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.ops import segsum_pallas  # noqa: E402
from morpheus_tpu_torch.ops import segsum  # noqa: E402

torch.set_num_threads(1)

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
    before = segsum.segment_sum_sorted.launches
    got = segsum.segment_sum_sorted(torch.as_tensor(idx), tv, SIZE)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert segsum.segment_sum_sorted.launches == before
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
