"""The port's SDS virtual step against the JAX trainer's on the CPU (tests/
torch_parity.py make_sds_pair, the JAX key trees replayed by name): one
step with the deform freeze on (Adam at once, the frozen groups' rate 0)
and one with it off (the gradients carried in pending_grads), the next
real step folding them in; a non-finite SDS gradient skipped; the render's
recomputation (remat_virtual) exact; and a checkpoint that carries
pending_grads and host_step resuming as a straight run.

Tolerances: losses at rtol 1e-4; gradients and first moments at rtol 1e-3,
atol 1e-6 + 1e-4 x the tensor's largest value, second moments (squares)
at twice that; parameters within 2*lr after an Adam step (eps 1e-15 turns
a round-off gradient into a full-lr move either way); the frozen groups'
parameters exactly unchanged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from morpheus_tpu.data import dataset as jdata  # noqa: E402
from morpheus_tpu_torch.train import optim  # noqa: E402

torch.set_num_threads(1)

STEP = 5                 # a global step that refreshes no occupancy


def _named(ttr, tensors):
    return {n: t.detach().numpy() for n, t in zip(ttr.optim.names, tensors)}


def _close(got, want, what, factor=1.0):
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = want[path]
        np.testing.assert_allclose(
            g, w, rtol=1e-3 * factor,
            atol=(1e-6 + 1e-4 * np.abs(w).max()) * factor,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, tree)))


def _tree(ttr, tensors):
    from morpheus_tpu_torch import convert
    return convert.params_to_jax({n: torch.as_tensor(a) for n, a in
                                  _named(ttr, tensors).items()})


@pytest.fixture(scope="module")
def pair():
    """The pair at a fixed occupancy grid and global step 5, the JAX
    virtual and real steps compiled once."""
    jcfg, jtr, ttr = tp.make_sds_pair(1)
    j_occ, t_occ = tp.fixed_occupancy(jcfg)
    jtr.state = jtr.state._replace(occ=j_occ,
                                   global_step=jnp.asarray(STEP, jnp.int32))
    jtr.epoch = 3               # epochs 3 and 6 both run all 4 levels
    al = jtr._active_levels()
    js = jdata.VirtualViewSampler(jtr.dataset, jcfg, tp.SDS_VIEW / 32)
    steps = {"virtual": jtr._make_virtual_step(js, al),
             "real": jtr._make_real_step(al)}
    start = (jtr.state, [p.detach().clone() for p in ttr.params])
    return jcfg, jtr, ttr, t_occ, steps, start


def _reset(pair, epoch):
    jcfg, jtr, ttr, t_occ, steps, (jstate, tparams) = pair
    jtr.state = jstate
    ttr.load_params({n: p.clone() for n, p in zip(ttr.optim.names,
                                                   tparams)})
    ttr.occ = tp.occupancy.OccupancyState(occs=t_occ.occs.clone(),
                                          binaries=t_occ.binaries.clone())
    ttr.global_step = STEP
    jtr.epoch = ttr.epoch = epoch
    assert jtr._active_levels() == 4
    ttr._set_levels(4)
    return jcfg, jtr, ttr, steps


def _virtual(jcfg, jtr, ttr, steps, epoch, key):
    jtr.state, j_loss, _ = steps["virtual"](
        jtr.state, jtr.guidance, jtr._embeddings, key, jnp.float32(epoch))
    lo_hi = ttr.curr.sds_steps(epoch)
    ttr.draws = tp.ReplayDraws(tp.virtual_step_draws(
        key, jcfg, 4, ttr.guidance.spec.latent_size, lo_hi))
    t_loss, diag = ttr.virtual_step(epoch,
                                    ttr.virtual_sampler(tp.SDS_VIEW / 32))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)
    return diag


def test_virtual_step_freeze_on_matches_jax(pair):
    """Epoch 3 <= freeze_epoch 4: Adam steps at once; both moments of every
    group move, the frozen groups' parameters do not."""
    epoch = 3
    jcfg, jtr, ttr, steps = _reset(pair, epoch)
    before = {n: p.detach().clone() for n, p in zip(ttr.optim.names,
                                                    ttr.params)}
    diag = _virtual(jcfg, jtr, ttr, steps, epoch, jax.random.PRNGKey(31))
    assert diag and ttr.global_step == STEP + 1
    assert not ttr._pending_live
    assert float(ttr.optim.step) == float(jtr.state.opt_state.step) == 1.0
    _close(_tree(ttr, ttr.optim.mu), _flat(jtr.state.opt_state.mu), "mu")
    _close(_tree(ttr, ttr.optim.nu), _flat(jtr.state.opt_state.nu), "nu",
           factor=2.0)
    lr = float(jtr.curr.learning_rate(epoch))
    want = _flat(jtr.state.params)
    for path, g in jax.tree_util.tree_leaves_with_path(_tree(ttr,
                                                             ttr.params)):
        np.testing.assert_allclose(g, want[path], rtol=0, atol=2 * lr,
                                   err_msg=jax.tree_util.keystr(path))
    frozen = [n for n in ttr.optim.names
              if optim.group_of(n) in optim.FREEZE_GROUPS]
    assert frozen
    mu = dict(zip(ttr.optim.names, ttr.optim.mu))
    for n, p in zip(ttr.optim.names, ttr.params):
        if n in frozen:
            assert torch.equal(p, before[n]), n
    assert any(float(mu[n].abs().max()) > 0 for n in frozen)


def test_virtual_step_carries_and_real_step_folds_matches_jax(pair):
    """Epoch 6 > freeze_epoch: the virtual step leaves the parameters and
    Adam alone and carries its gradients (/ virtual_freq); the next real
    step adds them to its own before Adam, then clears them."""
    epoch = 6
    jcfg, jtr, ttr, steps = _reset(pair, epoch)
    before = [p.detach().clone() for p in ttr.params]
    _virtual(jcfg, jtr, ttr, steps, epoch, jax.random.PRNGKey(32))
    assert ttr._pending_live and float(ttr.optim.step) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, ttr.params))
    pending = _flat(jtr.state.pending_grads)
    assert sum(np.abs(v).max() > 0 for v in pending.values()) >= 5
    _close(_tree(ttr, ttr.pending), pending, "pending")

    key = jax.random.PRNGKey(33)
    ttr.draws = tp.ReplayDraws(tp.step_draws(key, jcfg, 4, 32 * 32,
                                             STEP + 1))
    jtr.state, j_loss = steps["real"](jtr.state, key, jnp.float32(epoch))
    t_loss = ttr.real_step(epoch)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)
    assert not ttr._pending_live
    assert all(not bool(p.any()) for p in ttr.pending)
    assert all(not np.any(np.asarray(v))
               for v in jax.tree.leaves(jtr.state.pending_grads))
    _close(_tree(ttr, ttr.optim.mu), _flat(jtr.state.opt_state.mu), "mu")
    _close(_tree(ttr, ttr.optim.nu), _flat(jtr.state.opt_state.nu), "nu",
           factor=2.0)


@pytest.mark.parametrize("freeze", [True, False])
def test_non_finite_sds_gradient_is_skipped(pair, monkeypatch, freeze):
    """A NaN in the SDS loss makes every gradient non-finite: the step
    changes no parameter, moment or step count, and carries nothing (the
    GradScaler-parity skip, trainer.py:646-650 of the JAX package)."""
    from morpheus_tpu_torch.guidance import zero123 as tz
    epoch = 3 if freeze else 6
    jcfg, jtr, ttr, steps = _reset(pair, epoch)
    real = tz.sds_loss
    monkeypatch.setattr(tz, "sds_loss", lambda *a, **kw: (
        lambda lo: (lo[0] * float("nan"), lo[1]))(real(*a, **kw)))
    state = [t.clone() for t in (*ttr.params, *ttr.optim.mu,
                                 *ttr.optim.nu, ttr.optim.step)]
    ttr.draws = tp.ReplayDraws(tp.virtual_step_draws(
        jax.random.PRNGKey(34), jcfg, 4, ttr.guidance.spec.latent_size,
        ttr.curr.sds_steps(epoch)))
    loss, _ = ttr.virtual_step(epoch, ttr.virtual_sampler(tp.SDS_VIEW / 32))
    assert not torch.isfinite(loss)
    after = (*ttr.params, *ttr.optim.mu, *ttr.optim.nu, ttr.optim.step)
    assert all(torch.equal(a, b) for a, b in zip(state, after))
    assert all(not bool(p.any()) for p in ttr.pending)
    assert ttr.global_step == STEP + 1


def test_virtual_render_remat_is_exact(pair):
    """remat_virtual (torch.utils.checkpoint of the render, the draws
    replayed in the recomputation) gives the loss and every gradient bit
    for bit."""
    epoch = 6
    jcfg, jtr, ttr, steps = _reset(pair, epoch)
    arrays = tp.virtual_step_draws(jax.random.PRNGKey(35), jcfg, 4,
                                   ttr.guidance.spec.latent_size,
                                   ttr.curr.sds_steps(epoch))
    out = []
    for remat in (False, True):
        ttr.config["tpu"]["remat_virtual"] = remat
        loss, _ = ttr._virtual_loss(ttr.occ, tp.ReplayDraws(arrays), epoch,
                                    float(ttr.curr.max_level(epoch)),
                                    ttr.virtual_sampler(tp.SDS_VIEW / 32))
        out.append((loss, ttr._grads(loss)))
    ttr.config["tpu"]["remat_virtual"] = False
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_sds_ckpt_resume_equals_straight_run(tmp_path):
    """A run of virtual steps only past the freeze (pending_grads non-zero
    at the checkpoint), saved, resumed in a new trainer, then a real step
    that folds the carried gradients: the same state as a straight run,
    bit for bit; the checkpoint holds pending_grads and host_step."""
    import pickle
    from morpheus_tpu_torch.config import merge_defaults
    from morpheus_tpu_torch.data.dataset import load_synthetic
    from morpheus_tpu_torch.guidance.zero123 import (Zero123Guidance,
                                                     Zero123Spec)
    from morpheus_tpu_torch.train.trainer import Trainer
    tiny = {k: dict(v) for k, v in tp.TINY.items()}
    tiny["train"].update(tp.SDS_TRAIN, virtual_freq=2, real_freq=0,
                         n_iters=1)
    tiny["data"]["novel_view_scale"] = tp.SDS_VIEW / 32
    tiny["exp"]["save_guidance"] = False
    cfg = merge_defaults(tiny)

    def trainer(seed=3):
        g = Zero123Guidance.init_random(Zero123Spec(**tp.SPEC_KW), "cpu", 1)
        return Trainer(cfg, load_synthetic(cfg), device="cpu", guidance=g,
                       seed=seed)

    def run(tr, epochs):
        for e in epochs:
            tr.epoch = e
            tr.train_one_epoch()

    straight = trainer()
    run(straight, (5, 6))
    straight.real_step(6)
    first = trainer()
    run(first, (5,))
    path = str(tmp_path / "model_ep_0005.pkl")
    first.save_ckpt(path)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert saved["host_step"] == 2 and saved["global_step"] == 2
    assert any(np.any(v) for v in saved["pending_grads"].values())
    resumed = trainer(seed=99)
    resumed.load_ckpt(path)
    assert resumed._pending_live and resumed.host_step == 2
    run(resumed, (6,))
    resumed.real_step(6)
    for a, b in ((straight.params, resumed.params),
                 (straight.optim.mu, resumed.optim.mu),
                 (straight.optim.nu, resumed.optim.nu),
                 (straight.pending, resumed.pending),
                 (straight.ema, resumed.ema)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (resumed.host_step, resumed.global_step) == (4, 5)
