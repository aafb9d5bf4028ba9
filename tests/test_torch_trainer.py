"""The port's real-view loss and its gradients against the JAX trainer, on a
tiny synthetic config (tests/torch_parity.py): same parameters (initialised
in JAX, converted with convert.params_from_jax), same random draws (the JAX
key tree replayed into the port by name), both gradient payload types.

Tolerances: the loss at rtol 1e-4 and every parameter gradient at rtol 1e-3,
atol 1e-6 - the two run the same float32 math in another order (segmented
sums, matmul blocking, histogram vs scatter order). With bfloat16 payloads a
hash-grid gradient slot may further differ by one bf16 ulp of each update
summed into it (2^-7 of the histogram of |cotangent|): each side rounds its
own float32 cotangent once, and round-off can put the two on either side of a
rounding boundary.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.ops import hashgrid, occupancy  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

GRIDS = ("sdf_grid", "color_grid")


def _abs_hist_grads(monkeypatch, loss_fn, field):
    """Grid gradients of loss_fn() with every histogram payload replaced by
    its absolute value: per table slot, the sum of |cotangent| into it."""
    orig = hashgrid.level_histogram
    with monkeypatch.context() as m:
        m.setattr(hashgrid, "level_histogram",
                  lambda idx, vals, starts, n: orig(idx, vals.abs(), starts, n))
        grads = torch.autograd.grad(loss_fn(), [getattr(field, g)
                                                for g in GRIDS])
    return {g: h.numpy() for g, h in zip(GRIDS, grads)}


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_real_loss_and_grads_match_jax(payload, monkeypatch):
    jcfg, jtr, ttr = tp.make_pair(payload)
    epoch = 6
    ttr.epoch = jtr.epoch = epoch
    al = jtr._active_levels()
    assert ttr._active_levels() == al
    ttr._set_levels(al)
    spec = jtr._spec_for_levels(al)
    max_level = float(jtr.curr.max_level(epoch))

    # a fixed batch and a fixed, partly occupied occupancy grid
    key = jax.random.PRNGKey(11)
    k_b, k_occ, k_bg, k_r = jax.random.split(key, 4)
    batch = tp.jax_dataset.sample_real_view_rays(k_b, jtr.data, 4, 64)
    R = jcfg["tpu"]["occ_resolution"]
    occs = np.asarray(jax.random.uniform(k_occ, (R ** 3,))) * 0.02
    j_occ = tp.jax_trainer.occupancy.OccupancyState(
        occs=jnp.asarray(occs), binaries=jnp.asarray(occs > 0.01).reshape(
            R, R, R))
    bg = jax.random.uniform(k_bg, (64, 3))

    def jloss(p):
        return jtr.real_loss_from_batch(p, j_occ, k_r, epoch, max_level,
                                        batch, bg, spec=spec)[0]

    j_l, j_g = jax.jit(jax.value_and_grad(jloss))(jtr.state.params)

    t_batch = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    t_batch["rays_id"] = t_batch["rays_id"].long()
    t_occ = occupancy.OccupancyState(
        occs=torch.as_tensor(occs),
        binaries=torch.as_tensor(occs > 0.01).reshape(R, R, R))

    def t_loss():
        return ttr.real_loss_from_batch(
            t_occ, tp.ReplayDraws(tp.render_draws(k_r, jcfg, 64)), epoch,
            max_level, t_batch, torch.as_tensor(np.array(bg)))[0]

    t_l = t_loss()
    t_g = torch.autograd.grad(t_l, ttr.params)
    np.testing.assert_allclose(t_l.item(), float(j_l), rtol=1e-4)
    got = convert.params_to_jax(
        {n: g for (n, _), g in zip(ttr.field.named_parameters(), t_g)})
    want = jax.tree.map(np.asarray, j_g)
    bound = (_abs_hist_grads(monkeypatch, t_loss, ttr.field)
             if payload == "bfloat16" else {})
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        name = path[0].key
        atol = 1e-6 + (2.0 ** -7 * bound[name] if name in bound else 0.0)
        w = flat_want[path]
        bad = np.abs(g - w) > atol + 1e-3 * np.abs(w)
        assert not bad.any(), (jax.tree_util.keystr(path), g[bad], w[bad])


def test_trainer_imports_without_jax():
    """The port's trainer imports with jax and the JAX package unavailable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['morpheus_tpu'] = None; "
            "import morpheus_tpu_torch.train.trainer, morpheus_tpu_torch.convert")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_entry_point_refuses_missing_cuda():
    """The default device is CUDA; without a card the trainer raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = tp.config_pair("float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tcfg, load_synthetic(tcfg))


def test_field_refuses_missing_cuda():
    """Field, like the trainer, is built on CUDA unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from morpheus_tpu_torch.model.field import Field, FieldSpec
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Field(FieldSpec())


@pytest.mark.parametrize("section,key,value", [
    ("tpu", "vjp_mode", "sort_pallas_rows"),
    ("tpu", "mlp_dtype", "bfloat16"),
    ("tpu", "compute_dtype", "bfloat16"),
    ("tpu", "data_parallel", 2),
    ("train", "optim", "adan"),
])
def test_unported_modes_raise(section, key, value):
    _, tcfg = tp.config_pair("float32")
    tcfg[section][key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(tcfg, load_synthetic(tcfg), device="cpu")


def test_guidance_is_not_ported():
    _, tcfg = tp.config_pair("float32")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(tcfg, load_synthetic(tcfg), device="cpu", guidance=object())
