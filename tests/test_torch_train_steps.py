"""Three real training steps of the port against three of the JAX trainer
(tests/torch_parity.py): the first with the warmup (all-cell) occupancy
update, the third with a sampled (strided-rotation) update; both gradient
payload types.

Tolerances: losses at rtol 1e-4, occupancy EMA values at rtol 1e-5, and the
parameters within 2*n*lr after n steps - Adam with eps 1e-15 can move a
weight whose gradient is at round-off level by a full lr either way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_three_real_steps_match_jax(payload):
    jcfg, jtr, ttr = tp.make_pair(payload)
    epoch = 3
    jtr.epoch = ttr.epoch = epoch
    al = jtr._active_levels()
    ttr._set_levels(al)
    j_step = jtr._make_real_step(al)
    nf, n_pix, n = 4, 32 * 32, 3
    for step in range(n):
        jtr.key, k = jax.random.split(jtr.key)
        ttr.draws = tp.ReplayDraws(tp.step_draws(k, jcfg, nf, n_pix, step))
        jtr.state, j_loss = j_step(jtr.state, k, jnp.float32(epoch))
        t_loss = ttr.real_step(epoch)
        np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(ttr.occ.occs.numpy(),
                                   np.asarray(jtr.state.occ.occs), rtol=1e-5,
                                   atol=1e-7, err_msg=f"occs step {step}")
    assert ttr.global_step == n
    lr = float(jtr.curr.learning_rate(epoch))
    got = convert.params_to_jax(ttr.field)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jtr.state.params)))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(g, want[path], rtol=0, atol=2 * n * lr,
                                   err_msg=jax.tree_util.keystr(path))
