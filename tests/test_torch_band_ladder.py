"""The exact surface-band ladder (tpu.band_reuse false, the reference's
two-ladder normal smoothness, JAX renderer.py:417-457) against the JAX
trainer's real-view loss and gradients on the CPU, at the shape of
configs/ab_exact.yaml (no sample, smooth or band budget, linear occupancy
queries) and with band_budget 2 (a random subset of the in-band ladder
points, top-k of a replayed score). The ladder's jitter, ortho phase and
subset score are replayed from the JAX key tree (k1, k2, k3 of k_smooth).

Tolerances: those of tests/test_torch_trainer.py (loss rtol 1e-4, each
gradient rtol 1e-3, atol 1e-6): the same float32 math in another order.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("overrides", [
    tp.AB_EXACT, {"tpu": {"band_reuse": False, "band_budget": 2}}],
    ids=["ab_exact", "ladder_budget_2"])
def test_ladder_real_loss_and_grads_match_jax(overrides, monkeypatch):
    tp.check_real_loss_matches_jax("float32", "hist_rows", monkeypatch,
                                   overrides=overrides)
