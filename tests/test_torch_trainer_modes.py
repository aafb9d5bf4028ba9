"""The port's real-view loss and its gradients against the JAX trainer under
the non-default hash-grid routes (tpu.vjp_mode), on the tiny synthetic config
of tests/torch_parity.py: mxu_rows with both payload types (the bf16-split
level_gather forward, the level histogram backward) and sort_pallas_rows with
bf16 payloads (row gather, sort and sorted segment sum).

Tolerances are those of tests/test_torch_trainer.py: the loss at rtol 1e-4,
every parameter gradient at rtol 1e-3 and atol 1e-6, and under bf16 payloads
a hash-grid slot may further differ by 2^-7 of its histogram of
|cotangent|. The JAX side runs the same mode, so mxu_rows' bf16-rounded
forward values are on both sides.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("vjp_mode,payload", [
    ("mxu_rows", "bfloat16"), ("mxu_rows", "float32"),
    ("sort_pallas_rows", "bfloat16")])
def test_real_loss_and_grads_match_jax_under_vjp_mode(vjp_mode, payload,
                                                     monkeypatch):
    tp.check_real_loss_matches_jax(payload, vjp_mode, monkeypatch)
