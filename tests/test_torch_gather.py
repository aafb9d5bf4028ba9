"""The port's per-level split gather (ops/gather.py) against the JAX
package's gather_pallas.level_gather over pack_level_table, run in interpret
mode on the CPU.

Tolerance: bit for bit. Each output is one table value's bf16 planes summed
in a fixed order in f32 ((t1 + t2) + t3), and the TPU kernel's one-hot
selection adds only exact zeros to it, so both sides round the same values
the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.ops import gather_pallas  # noqa: E402
from morpheus_tpu.ops.hashgrid import HashGridSpec  # noqa: E402
from morpheus_tpu_torch import trace  # noqa: E402
from morpheus_tpu_torch.ops import gather  # noqa: E402

torch.set_num_threads(1)


def launches(kernel: str) -> float:
    """The kernel's launches so far: its wrapper's host counter
    (trace.py's "<kernel>.launches")."""
    return trace.counts().get(kernel + ".launches", 0.0)

# tests/test_hashgrid.py:225-230: uneven level sizes (64 up to 512 rows),
# an active subset of 5 levels, Np not a multiple of the TPU block
SPEC = HashGridSpec(input_dim=3, num_levels=6, level_dim=4, base_resolution=4,
                    log2_hashmap_size=9, desired_resolution=64)
L, NP = 5, 777


def _inputs(C, seed, stream="random"):
    """Table and index stream: uniform random rows of each level; 'one_row'
    (every index on row 0 of its level); 'clustered' (runs of one row, of
    random length 1-64, as a ray's neighbouring samples in one cell)."""
    rng = np.random.default_rng(seed)
    offs = SPEC.offsets
    emb = rng.standard_normal((SPEC.table_size, C)).astype(np.float32)
    sizes = [offs[l + 1] - offs[l] for l in range(L)]
    idx = np.stack([rng.integers(0, s, NP) for s in sizes]).astype(np.int32)
    if stream == "one_row":
        idx = np.zeros_like(idx)
    elif stream == "clustered":
        for l in range(L):
            ends = np.cumsum(rng.integers(1, 65, NP))
            idx[l] = idx[l][np.searchsorted(ends, np.arange(NP), side="right")]
    return emb, idx, list(offs[:L])


@pytest.mark.parametrize("stream", ["random", "one_row", "clustered"])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("C", [2, 4])
def test_level_gather_matches_pallas_bitwise(S, C, stream):
    emb, idx, starts = _inputs(C, seed=S * 10 + C, stream=stream)
    offs = SPEC.offsets
    t_pad = max(offs[l + 1] - offs[l] for l in range(L))
    tabs = gather_pallas.pack_level_table(jnp.asarray(emb), offs, L, t_pad, S)
    want = np.asarray(gather_pallas.level_gather(
        jnp.asarray(idx), tabs, n_chan=C, interpret=True)).T
    before = launches("level_gather")
    got = gather.level_gather(torch.as_tensor(idx), torch.as_tensor(emb),
                              starts, S)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launches("level_gather") == before
    assert got.shape == (L * NP, C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the packer alone is a literal port too
    for a, b in zip(gather.pack_level_table(torch.as_tensor(emb), offs, L,
                                            t_pad, S), tabs):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("S", [1, 3])
def test_level_gather_splits_as_stated(S):
    """S=1 gives the bf16-rounded value; S=3 the f32 value to one ulp."""
    emb, idx, starts = _inputs(4, seed=7)
    got = gather.level_gather(torch.as_tensor(idx), torch.as_tensor(emb),
                              starts, S).numpy()
    rows = (idx.astype(np.int64) + np.asarray(starts)[:, None]).reshape(-1)
    exact = torch.as_tensor(emb[rows])
    if S == 1:
        np.testing.assert_array_equal(got, exact.to(torch.bfloat16).float())
    else:
        ulp = np.spacing(np.abs(exact.numpy()))
        assert (np.abs(got - exact.numpy()) <= ulp).all()


def test_level_gather_checks_its_inputs():
    idx = torch.zeros((2, 5), dtype=torch.int32)
    emb = torch.zeros((16, 2))
    with pytest.raises(ValueError):
        gather.level_gather(idx.long(), emb, [0, 8], 1)
    with pytest.raises(ValueError):
        gather.level_gather(idx, emb.double(), [0, 8], 1)
    with pytest.raises(ValueError):
        gather.level_gather(idx, emb, [0, 8], 2)
    with pytest.raises(ValueError):
        gather.level_gather(idx, emb, [0], 1)
    with pytest.raises(ValueError):
        gather.level_gather(idx.to("meta"), emb.to("meta"), [0, 8], 1)
