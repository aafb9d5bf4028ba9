"""The port's row gather (ops/rows.py): the hash-grid encode's forward under
the row-gather routes.

On the CPU the wrapper's contract is held against index_select on the flat
global rows. The tests marked `card` hold the CUDA kernel
(kernels/row_gather.cu) against index_select on a card, and skip without
one; run them there with

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_row_gather.py

(this file imports no JAX; --noconftest keeps out tests/conftest.py, which
does). Tolerance everywhere: bit for bit, as the gather is a copy. The
encode's gradients are compared bit for bit too: its positions lie on 32nds
of the cube and its cotangent on quarters, so every product and sum that
the histogram's float atomics add, in any order, is exact.
"""
import pytest

torch = pytest.importorskip("torch")

from morpheus_tpu_torch.ops import hashgrid, rows  # noqa: E402

torch.set_num_threads(1)

# uneven level sizes (64 up to 512 rows), as tests/test_torch_gather.py
SPEC = hashgrid.HashGridSpec(input_dim=3, num_levels=16, level_dim=4,
                             base_resolution=4, log2_hashmap_size=9,
                             desired_resolution=64)


def _inputs(C, L, Np, dtype, seed, device="cpu"):
    """A (T, C) table and a (L, Np) int32 stream of uniform random rows of
    each level; level 0's last Np // 8 entries, and the last level's, all
    on the level's last row (the last level's is the table's last row)."""
    g = torch.Generator().manual_seed(seed)
    offs = SPEC.offsets
    T = offs[L]
    emb = torch.randn((T, C), generator=g).to(dtype)
    sizes = [offs[l + 1] - offs[l] for l in range(L)]
    idx = torch.stack([torch.randint(0, s, (Np,), generator=g)
                       for s in sizes]).to(torch.int32)
    idx[0, Np - Np // 8:] = sizes[0] - 1
    idx[L - 1] = sizes[L - 1] - 1
    return emb.to(device), idx.to(device), list(offs[:L])


def _flat(idx, starts):
    st = torch.as_tensor(starts, device=idx.device).reshape(-1, 1)
    return (idx.long() + st).reshape(-1)


@pytest.mark.parametrize("L", [1, 16])
@pytest.mark.parametrize("C", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_contract(dtype, C, L):
    emb, idx, starts = _inputs(C, L, 777, dtype, seed=C + L)
    want = emb.index_select(0, _flat(idx, starts))
    before = rows.row_gather.launches
    got = rows.row_gather(idx, emb, starts)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert rows.row_gather.launches == before
    assert got.shape == (L * 777, C) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got[-1], emb[-1])


def test_row_gather_checks_its_inputs():
    idx = torch.zeros((2, 5), dtype=torch.int32)
    emb = torch.zeros((16, 4))
    with pytest.raises(ValueError):
        rows.row_gather(idx.long(), emb, [0, 8])
    with pytest.raises(ValueError):
        rows.row_gather(idx, emb.to("meta"), [0, 8])
    with pytest.raises(ValueError):
        rows.row_gather(torch.zeros((65, 5), dtype=torch.int32), emb,
                        [0] * 65)
    with pytest.raises(ValueError):
        rows.row_gather(idx, emb.double(), [0, 8])
    with pytest.raises(ValueError):
        rows.row_gather(idx, emb, [0])
    with pytest.raises(ValueError):
        rows.row_gather(idx, emb, [0, 17])
    with pytest.raises(IndexError):      # the plain version's index_select
        rows.row_gather(idx + 9, emb, [0, 8])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


# the main path's row widths: 8 B (bf16, C=4), 16 B (f32, C=4), 64 B (bf16,
# C=32, the packed prefix), 128 B (f32, C=32); then the kernel's other
# paths: an odd Np (8-byte rows unpaired), 8-byte f32 rows (C=2, the
# sdf-only tail) and 4-byte rows (bf16, C=2)
WIDTHS = [(torch.bfloat16, 4, 8 * 4096), (torch.float32, 4, 8 * 4096),
          (torch.bfloat16, 32, 4096), (torch.float32, 32, 4096),
          (torch.bfloat16, 4, 777), (torch.float32, 2, 4096),
          (torch.bfloat16, 2, 4096)]


@pytest.mark.card
@pytest.mark.parametrize("dtype,C,Np", WIDTHS)
def test_row_gather_kernel_bitwise(cuda, dtype, C, Np):
    emb, idx, starts = _inputs(C, 16, Np, dtype, seed=C + Np, device=cuda)
    before = rows.row_gather.launches
    got = rows.row_gather(idx, emb, starts)
    torch.cuda.synchronize()
    assert rows.row_gather.launches == before + 1
    assert got.dtype == dtype and got.shape == (16 * Np, C)
    assert torch.equal(got, emb.index_select(0, _flat(idx, starts)))


@pytest.mark.card
def test_row_gather_kernel_on_an_unaligned_table(cuda):
    """A table view 4 bytes past a 16-byte boundary: 8-byte bf16 rows that
    cannot be loaded 8 bytes at a time."""
    emb, idx, starts = _inputs(4, 16, 4096, torch.bfloat16, seed=3,
                               device=cuda)
    flat = torch.zeros(emb.numel() + 2, dtype=emb.dtype, device=cuda)
    view = flat[2:].view(emb.shape)
    view.copy_(emb)
    assert view.data_ptr() % 8 == 4
    got = rows.row_gather(idx, view, starts)
    assert torch.equal(got, emb.index_select(0, _flat(idx, starts)))


@pytest.mark.card
@pytest.mark.parametrize("dtype,C", [(torch.float32, 3), (torch.bfloat16, 1),
                                     (torch.float32, 6)])
def test_row_gather_kernel_refuses_other_widths(cuda, dtype, C):
    """Rows of 12, 2 and 24 bytes: no caller sends them, and the kernel
    refuses them rather than guess; nothing is counted."""
    emb, idx, starts = _inputs(C, 16, 1024, dtype, seed=C, device=cuda)
    before = rows.row_gather.launches
    with pytest.raises(RuntimeError, match="row_gather"):
        rows.row_gather(idx, emb, starts)
    assert rows.row_gather.launches == before


@pytest.mark.card
@pytest.mark.parametrize("dtype,C", [(torch.float32, 4),
                                     (torch.bfloat16, 4),
                                     (torch.float32, 32)])
def test_row_gather_kernel_replayed_in_a_graph(cuda, dtype, C):
    """Captured once in a CUDA graph, replayed twice on new indices written
    in place; a replay launches nothing from the host, so the counter moves
    at the capture alone."""
    emb, idx, starts = _inputs(C, 16, 8 * 1024, dtype, seed=11, device=cuda)
    rows.row_gather(idx, emb, starts)            # load the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = rows.row_gather.launches
    with torch.cuda.graph(graph):
        out = rows.row_gather(idx, emb, starts)
    assert rows.row_gather.launches == before + 1
    for seed in (12, 13):
        _, fresh, _ = _inputs(C, 16, 8 * 1024, dtype, seed=seed, device=cuda)
        idx.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, emb.index_select(0, _flat(fresh, starts)))


def _index_select_rows(emb, r, payload_dtype):
    return emb.index_select(0, r.rows)


@pytest.mark.card
@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_hist_rows_encode_and_gradients_match_index_select(cuda, payload,
                                                          monkeypatch):
    """A hist_rows encode (the packed dense prefix and the hashed tail), its
    first gradients and the input gradient of <grad_e, v> (the double
    backward's gather), through row_gather against the same encode through
    index_select: equal bit for bit."""
    spec = hashgrid.HashGridSpec(input_dim=3, num_levels=16, level_dim=4,
                                 base_resolution=16, log2_hashmap_size=15,
                                 desired_resolution=128,
                                 grad_payload=payload)
    g = torch.Generator().manual_seed(5)
    # points on 32nds of the cube: x01 * res - 0.5 is a multiple of 1/32 at
    # each integer res, so each trilinear weight, times the cotangent's
    # quarters, is a multiple of 2^-17 (as is its bf16 rounding), and the
    # sums stay far below 2^7: exact in f32
    x01 = torch.randint(0, 33, (4096, 3), generator=g) / 32.0
    x = (2.0 * x01 - 1.0).to(cuda)
    emb0 = torch.randn((spec.table_size, 4), generator=g).to(cuda)
    u = (torch.randint(-4, 5, (4096, 64), generator=g) / 4.0).to(cuda)
    v = torch.randn((spec.table_size, 4), generator=g).to(cuda)

    def run():
        emb = emb0.clone().requires_grad_()
        xi = x.clone().requires_grad_()
        out = hashgrid.encode(xi, emb, spec, 1.0)
        ge, gx = torch.autograd.grad((out * u).sum(), (emb, xi),
                                     create_graph=True)
        gxx = torch.autograd.grad((ge * v).sum(), xi)[0]
        torch.cuda.synchronize()
        return out.detach(), ge.detach(), gx.detach(), gxx

    n0 = rows.row_gather.launches
    got = run()
    assert rows.row_gather.launches > n0
    monkeypatch.setitem(hashgrid.ROUTES, "hist_rows",
                        (_index_select_rows, hashgrid.ROUTES["hist_rows"][1]))
    n1 = rows.row_gather.launches
    want = run()
    assert rows.row_gather.launches == n1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
