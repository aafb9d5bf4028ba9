"""Three real training steps of the port against three of the JAX trainer
(tests/torch_parity.py check_steps_match_jax) at the shape of
configs/ab_exact.yaml (the exact surface-band ladder, no budgets, linear
occupancy queries refreshing a quarter of the cells) and with the topology
field (encode_topo) and every dormant smoothness term on. The bf16 policy
and Adan take the same check in tests/test_torch_precision.py and
tests/test_torch_adan.py.

Tolerances: check_steps_match_jax's (losses rtol 1e-4, occupancy rtol
1e-5, parameters within 2*n*lr).
"""
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("overrides", [
    tp.AB_EXACT, {**tp.TOPO, "model": {"encode_topo": True}}],
    ids=["ab_exact", "topo"])
def test_three_real_steps_match_jax(overrides):
    tp.check_steps_match_jax(overrides=overrides)
