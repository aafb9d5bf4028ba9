"""The bfloat16 mixed-precision policy (tpu.compute_dtype / tpu.mlp_dtype)
against the JAX package on the CPU: the MLP's bf16 products with f32 sums
(ops/mlp.py, JAX ops/mlp.py:54-73) and the real-view loss with its
gradients under compute_dtype bfloat16 (bf16 hash tables and MLPs).
The encode with a bf16 table under each kernel route is in
tests/test_torch_grid_modes.py.

Tolerances:
- the MLP's output at rtol 2^-7 of its largest magnitude: both sides sum
  the same exact products of bf16 values in f32, in another order, and
  round each hidden activation to bf16, so a sum near a rounding boundary
  may land one bf16 ulp (2^-8 relative) apart and carry through the next
  layer; its gradients the same, relative to each one's largest magnitude
  (autograd rounds the activations' and the weights' cotangents to bf16
  where the JAX transpose does);
- the real-view loss at rtol 1e-4 and each parameter gradient within
  2^-7 of its leaf's largest |gradient| (plus the float32 test's rtol 1e-3,
  atol 1e-6), for the same reason, through every bf16 rounding of the step;
- three real steps (tests/torch_parity.py check_steps_match_jax): losses at
  rtol 1e-4, parameters within 2*n*lr, and the occupancy values at rtol
  2^-5 - the density exp(-|sdf|/beta)/beta of an sdf from bf16 products
  moves by |sdf|/beta times a one-ulp (2^-8) flip of a hidden activation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from morpheus_tpu.ops import mlp as jmlp  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.ops.mlp import MLP  # noqa: E402

torch.set_num_threads(1)
ULP = 2.0 ** -7


def _scaled_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ULP * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("lead", [(50,), (5, 7)])
def test_bf16_mlp_matches_apply_mlp(lead):
    p = jmlp.init_mlp(jax.random.PRNGKey(1), 49, 33, 64, 3)
    m = MLP(49, 33, 64, 3)
    m.load_state_dict({k.split(".", 1)[1]: v for k, v in
                       convert.params_from_jax({"m": p}).items()})
    x = np.random.default_rng(0).normal(size=lead + (49,)).astype(np.float32)
    u = np.random.default_rng(1).normal(size=lead + (33,)).astype(np.float32)

    def jf(pp, xx):
        out = jmlp.apply_mlp(pp, xx, jnp.bfloat16)
        return jnp.sum(out * u), out

    (_, j_out), (j_gp, j_gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = m(xt, torch.bfloat16)
    assert out.dtype == torch.float32
    _scaled_close(out.detach(), j_out, "output")
    grads = torch.autograd.grad((out * torch.as_tensor(u)).sum(),
                                [xt] + list(m.parameters()))
    _scaled_close(grads[0], j_gx, "x")
    for l in range(3):
        _scaled_close(grads[1 + 2 * l].T, j_gp["w"][l], f"w{l}")
        _scaled_close(grads[2 + 2 * l], j_gp["b"][l], f"b{l}")


def test_real_loss_and_grads_match_jax_bf16_policy(monkeypatch):
    tp.check_real_loss_matches_jax(
        "float32", "hist_rows", monkeypatch,
        overrides={"tpu": {"compute_dtype": "bfloat16"}}, leaf_atol=ULP)


def test_three_real_steps_match_jax_bf16_policy():
    tp.check_steps_match_jax(overrides={"tpu": {"compute_dtype": "bfloat16"}},
                             occ_rtol=2.0 ** -5)
