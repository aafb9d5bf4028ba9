"""Three real training steps of the port against three of the JAX trainer
(tests/torch_parity.py): the first with the warmup (all-cell) occupancy
update, the third with a sampled (strided-rotation) update; both gradient
payload types.

Tolerances: losses at rtol 1e-4, occupancy EMA values at rtol 1e-5, and the
parameters within 2*n*lr after n steps - Adam with eps 1e-15 can move a
weight whose gradient is at round-off level by a full lr either way.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_three_real_steps_match_jax(payload):
    tp.check_steps_match_jax(payload)
