"""The hash grid's other options against the JAX package, on the CPU
(tests/hashgrid_parity.py's encode check: values, embedding and input
gradients, and the second-order embedding gradient).

Tolerances:
- smoothstep, tiled grids and align_corners: the float32 tolerances of
  tests/test_torch_hashgrid.py (values rtol 2e-5, atol 1e-6; gradients
  the same, the input gradient's and the second order's atol relative to
  their largest magnitude);
- the bfloat16 table of the mixed-precision policy (compute_dtype): values
  at the float32 tolerances (both sides interpolate the same bf16-rounded
  rows in f32). Under hist_rows and sort_pallas_rows the table cotangent
  is bf16: every entry of the f32 table's gradient must be a bf16 value
  (rounded where JAX rounds it, acc.astype(ct.dtype), and nowhere else),
  within 2^-8 of the histogram of |cotangent| per slot of JAX's - half a
  bf16 ulp of a slot whose terms do not cancel; the two sides sum the same
  bf16 terms in the same order, the packed prefix's shifted copies from
  the last corner to the first, and agree bit for bit on these inputs.
  Under mxu_rows the gather returns f32, so the table cotangent is not
  rounded and the f32 tolerances hold (the bf16 payload's 2^-7 bound where
  grad_payload rounds it).
"""
import pytest

torch = pytest.importorskip("torch")
from hashgrid_parity import GRIDS, _check_encode  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["hist_rows", "mxu_rows", "sort_pallas_rows"])
@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_bf16_table_matches_jax(mode, payload, monkeypatch):
    """compute_dtype bfloat16: the table cast to bf16 before the gather
    (JAX hashgrid.py:505-506), under each kernel route, on the grid with a
    packed dense prefix."""
    _check_encode(GRIDS["packed_and_hashed"], payload, monkeypatch,
                  gx_scaled=True, bf16=True, vjp_mode=mode)


@pytest.mark.parametrize("option", [
    dict(interpolation="smoothstep"),
    dict(interpolation="smoothstep", vjp_mode="mxu_rows"),
    dict(gridtype="tiled"),
    dict(align_corners=True),
    dict(align_corners=True, gridtype="tiled", vjp_mode="sort_pallas_rows"),
    dict(align_corners=True, interpolation="nearest"),
], ids=["smoothstep", "smoothstep_mxu", "tiled", "align_corners",
        "aligned_tiled_sort", "aligned_nearest"])
def test_grid_options_match_jax(option, monkeypatch):
    """smoothstep weights (JAX hashgrid.py:549, 606), the tiled grid (no
    hash: the lattice wraps, :476) and align_corners (:541-545), on the
    packed-and-hashed grid."""
    _check_encode(GRIDS["packed_and_hashed"], "float32", monkeypatch,
                  gx_scaled=True, **option)
