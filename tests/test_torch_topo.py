"""The topology field and the reference's dormant smoothness terms against
the JAX trainer's real-view loss and gradients on the CPU: topo_none off
(perturbed normals under the topo of their own points), normal_dir,
normal_smooth_3d_t, deform_smooth, deform_smooth_t and topo_smooth_t with
encode_topo on (JAX renderer.py:280-337, field.py:106-109, 211-222); and
central-difference normals (normal_mode 'fd', field.py:364-376), a spec
option no config key reaches.

Tolerances: the topo terms at those of tests/test_torch_trainer.py (loss
rtol 1e-4, gradients rtol 1e-3, atol 1e-6). fd normals: the loss the same,
each gradient within 1e-3 of its leaf's largest |gradient| as well - a
central difference divides the float32 round-off of two sdf values
(2^-24 of |sdf|) by 2*fd_eps = 4e-3, and its gradient carries the same
1/(2*fd_eps), so the two sides' summation orders show ~250x larger than in
an analytic normal. The fd case turns the smoothness terms off: each
would take six more sdf encodes of the same normal function.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


def test_topo_terms_real_loss_and_grads_match_jax(monkeypatch):
    tp.check_real_loss_matches_jax(
        "float32", "hist_rows", monkeypatch,
        overrides={**tp.TOPO, "model": {"encode_topo": True}})


def test_fd_normals_real_loss_and_grads_match_jax(monkeypatch):
    tp.check_real_loss_matches_jax(
        "float32", "hist_rows", monkeypatch,
        overrides={"train": {"normal_smoothness": 0.0,
                             "normal_smooth_3d": 0.0}},
        spec={"normal_mode": "fd"}, leaf_atol=1e-3)
