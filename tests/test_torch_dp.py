"""Data parallelism of the port (morpheus_tpu_torch/parallel/sharding.py)
on the CPU: two spawned gloo ranks (the ranks' side in
tests/torch_dp_ranks.py) against the JAX package's sharded step on a
2-device mesh of the conftest's 8 CPU devices, and against the port's own
one-process runs, at tests/torch_parity.py's TINY widths with its sample,
band and smooth budgets (8/2/2 a ray).

Tolerances: the JAX comparison as the single-device step parity
(tests/test_torch_train_steps.py): losses at rtol 1e-4, occupancy at rtol
1e-5, parameters within 2*n*lr after n steps. The selections' index sets
exactly. A world-2 loss against the one-rank loss at rtol 1e-5 (the same
float32 terms summed in another order). The virtual step's gradients
against the mean of the two views' one-process gradients at rtol 1e-6 and
1e-6 of each leaf's largest |gradient| (one process and two run the same
float32 ops on the same values, single-threaded).
"""
import copy
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402
import torch_parity as tp  # noqa: E402
from morpheus_tpu.parallel import sharding as jsharding  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.config import merge_defaults  # noqa: E402
from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.guidance import zero123 as tz  # noqa: E402
from morpheus_tpu_torch.parallel import sharding  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
N_RAYS = tp.TINY["train"]["real_ray_num"]


def _launch(tmp_path, fn, *args):
    """fn(reducer, device, *args, out) on WORLD gloo ranks; what each rank
    wrote."""
    out = tmp_path / "ranks"
    out.mkdir()
    sharding.launch(fn, WORLD, "cpu", args=args + (str(out),))
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _dp(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["tpu"]["data_parallel"] = WORLD
    return cfg


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _params(jtr):
    return convert.params_from_jax(jax.tree.map(np.asarray, jtr.state.params))


def dp_step_draws(key, cfg, step):
    """The draws of the JAX sharded real step under `key`
    (sharding.py:41-89): the occupancy update's as the single-device
    step's (tests/torch_parity.py step_draws), the render's under k_loss
    itself, at the global batch."""
    _, k_loss, _ = jax.random.split(key, 3)
    full = tp.step_draws(key, cfg, 4, 32 * 32, step)
    occ = {k: full[k] for k in ("t_occ", "occ_jitter", "occ_sel")
           if k in full}
    return _np({**occ, **tp.render_draws(k_loss, cfg, N_RAYS)})


def test_real_steps_match_the_jax_sharded_step(tmp_path):
    """Three data-parallel real steps (the warm-up occupancy update, none,
    a sampled one) on two ranks against make_sharded_real_step on a
    2-device mesh: the same parameters, the same numpy-drawn batches
    (host_sample_real_batch from the seed's generator) and the key's
    draws replayed."""
    jcfg, jtr, ttr = tp.make_pair("float32")
    params = _params(jtr)
    epoch, n = 3, 3
    mesh = jsharding.make_mesh(WORLD)
    step = jsharding.make_sharded_real_step(jtr, mesh)
    state = jsharding.replicate_state(jtr.state, mesh)
    rng = np.random.default_rng(jcfg["exp"]["seed"])
    key, draws, j_losses, j_occs = jtr.key, [], [], []
    for i in range(n):
        key, k = jax.random.split(key)
        draws.append(dp_step_draws(k, jcfg, i))
        b, bg = jsharding.host_sample_real_batch(rng, jtr.data, 4, N_RAYS)
        b = jsharding.shard_batch(b, mesh)
        bg = jsharding.shard_batch({"bg": bg}, mesh)["bg"]
        state, loss = step(state, b, bg, k, jnp.float32(epoch))
        j_losses.append(float(loss))
        j_occs.append(np.asarray(state.occ.occs))

    res = _launch(tmp_path, ranks.real_steps, _dp(ttr.config), params,
                  draws, epoch)
    lr = float(jtr.curr.learning_rate(epoch))
    for r in res:
        assert r["equal"]
        np.testing.assert_allclose(r["losses"], j_losses, rtol=1e-4)
        for i, (got, want) in enumerate(zip(r["occs"], j_occs)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"occs step {i}")
        tp.assert_trees_close(r["params"], state.params, rtol=0,
                              atol=2 * n * lr, what="params")
    for k, v in res[0]["params"].items():
        np.testing.assert_array_equal(v, res[1]["params"][k])


@pytest.mark.parametrize("band_reuse", [True, False])
def test_selections_union_to_the_one_rank_selection(tmp_path, band_reuse):
    """The compaction's samples and the smooth_sel, band_sel (the reuse
    band) or ladder_sel (the exact band) subsets each rank keeps, as
    global positions: their union over the ranks is the one-process
    selection on the whole batch, exactly, and the ranks' losses sum to
    its loss."""
    over = None if band_reuse else {"tpu": {"band_reuse": False}}
    jcfg, jtr, ttr = tp.make_pair("float32", overrides=over)
    epoch = 6
    batch, bg = jsharding.host_sample_real_batch(np.random.default_rng(1),
                                                 jtr.data, 4, N_RAYS)
    j_occ, _ = tp.fixed_occupancy(jcfg)
    occ = np.asarray(j_occ.occs)
    draws = _np(tp.render_draws(jax.random.PRNGKey(5), jcfg, N_RAYS))
    one_loss, one = ranks.record_selections(ttr, draws, batch, bg, occ,
                                            epoch)
    band = "band_sel" if band_reuse else "ladder_sel"
    assert set(one) == {"compaction", "smooth_sel", band}
    res = _launch(tmp_path, ranks.selections, _dp(ttr.config), _params(jtr),
                  draws, batch, bg, occ, epoch)
    assert all(len(r[1]["compaction"]) for r in res)
    for name, want in one.items():
        got = np.concatenate([r[1][name] for r in res])
        np.testing.assert_array_equal(np.sort(got), want, err_msg=name)
    np.testing.assert_allclose(sum(r[0] for r in res), one_loss, rtol=1e-5)


def _sds_config(tmp_path, **train):
    tiny = {k: dict(v) for k, v in tp.TINY.items()}
    tiny["train"].update(tp.SDS_TRAIN, **train)
    tiny["model"]["bg_radius"] = 1.4
    tiny["data"]["novel_view_scale"] = tp.SDS_VIEW / 32
    tiny["exp"]["output"] = str(tmp_path / "exp")
    return merge_defaults(tiny)


def _guided(cfg):
    g = tz.Zero123Guidance.init_random(tz.Zero123Spec(**tp.SPEC_KW), "cpu",
                                       seed=5)
    return Trainer(cfg, load_synthetic(cfg), device="cpu", guidance=g)


@pytest.mark.parametrize("epoch,freeze", [(3, True), (6, False)])
def test_virtual_step_is_the_mean_of_the_views(tmp_path, epoch, freeze):
    """One data-parallel SDS step, a view a rank, against the mean of the
    two views' gradients each taken in one process on the same draws
    (ViewDraws): the gradients handed to the optimizer while the deform
    freeze is on, the carried ones after it; the loss the views' mean."""
    cfg = _sds_config(tmp_path)
    want, losses = None, []
    for v in range(WORLD):
        tr = _guided(cfg)
        tr.epoch = epoch
        tr._set_levels(tr._active_levels())
        draws = tr.draws
        occ = tr._maybe_update_occ(tr.occ, 0, draws.uniform("t_occ", ()),
                                   draws)
        loss, _ = tr._virtual_loss(
            occ, sharding.ViewDraws(draws, v, WORLD), epoch,
            tr.curr.max_level(epoch),
            tr.virtual_sampler(tr._novel_view_scale()))
        g = tr._grads(loss)
        want = g if want is None else [a + b for a, b in zip(want, g)]
        losses.append(float(loss))
    vf = float(cfg["train"]["virtual_freq"])
    want = [w / WORLD / vf for w in want]

    res = _launch(tmp_path, ranks.virtual_step, _dp(cfg), None, tp.SPEC_KW,
                  epoch)
    for r in res:
        assert r["equal"] and r["applied"] == freeze
        np.testing.assert_allclose(r["loss"], np.mean(losses), rtol=1e-6)
        for name, got, w in zip(tr.optim.names, r["grads"], want):
            w = w.numpy()
            np.testing.assert_allclose(got, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
    assert any(np.abs(g).max() > 0 for g in res[0]["grads"])


def test_epoch_checkpoint_and_resume(tmp_path):
    """A data-parallel epoch of one SDS slot and one real step with the
    EMA keeps the ranks equal; rank 0 alone writes the checkpoint, every
    rank resumes from it to the same state and trains on."""
    cfg = _dp(_sds_config(tmp_path, n_iters=1))
    res = _launch(tmp_path, ranks.epoch_and_resume, cfg, tp.SPEC_KW,
                  str(tmp_path / "models" / "model_ep_0001.pkl"))
    assert [r["writes"] for r in res] == [1, 0]
    for r in res:
        assert r["equal"] and r["loaded_equal"] and r["resumed_equal"]
        assert r["ema_moved"] and r["host_step"] == r["global_step"] == 2
        assert np.isfinite([r["loss"], r["loss2"]]).all()
    assert res[0]["loss"] == res[1]["loss"]


def test_dryrun():
    """python -m morpheus_tpu_torch.parallel.dryrun 2 prints the JAX dry
    run's line."""
    proc = subprocess.run(
        [sys.executable, "-m", "morpheus_tpu_torch.parallel.dryrun", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.search(r"^dryrun_multichip\(2\): real_loss=[0-9.]+ "
                     r"virtual_loss=[-0-9.]+ OK$", proc.stdout, re.M), \
        proc.stdout
