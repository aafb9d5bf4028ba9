"""The chained data-parallel real step of the port (tpu.chain_steps under a
process group: train/trainer.py, parallel/sharding.py Rows) on the CPU:
two spawned gloo ranks (their side in tests/torch_dp_ranks.py) at
tests/torch_parity.py's TINY widths with its sample, band and smooth
budgets (8/2/2 a ray), where a rank's fixed-size selections are padded
(the compaction's capacity is the global budget, 512 samples, of which a
rank holds about half). Gloo's collectives cannot be captured, so the
ranks run the graph's body eagerly, its plain twin.

- Against the JAX package's make_sharded_real_steps_chained on a 2-device
  mesh of the conftest's CPU devices: real_freq = 3 chained steps from the
  same converted parameters, the same numpy-drawn batches (stacked, as
  shard_batch_stacked lays them out) and the key's draws replayed. The
  tolerances of tests/test_torch_dp.py: the loss at rtol 1e-4, the
  occupancy at rtol 1e-5, the parameters within 2*n*lr after n steps.
- Against the eager data-parallel epoch: bit for bit (parameters,
  optimizer slots, occupancy, global step, the numpy generator's state).
- The padding: members first, then inert entries whose contribution to the
  loss and to every gradient is exactly 0 (the loss and the gradients are
  the same whatever real entry the padding repeats) and finite.
- No host read: the body runs under NoHostRead (tests/torch_dp_ranks.py),
  which refuses nonzero, a tensor's value as a Python number (.item,
  .tolist, int), masked_select and indexing by a mask (outputs sized by
  the data), a tensor made of a numpy array (a step's host data) and a
  copy across devices.
"""
import copy
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402
import torch_parity as tp  # noqa: E402
from morpheus_tpu.parallel import sharding as jsharding  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.parallel import sharding  # noqa: E402

torch.set_num_threads(1)

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


def _chained(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["tpu"].update(data_parallel=WORLD, chain_steps=True)
    return cfg


def _params(jtr):
    return convert.params_from_jax(jax.tree.map(np.asarray, jtr.state.params))


def test_chained_steps_match_the_jax_chained_sharded_steps(tmp_path):
    """Three chained data-parallel steps (the warm-up occupancy update,
    none, a sampled one) in one epoch on two ranks against
    make_sharded_real_steps_chained's one scan on a 2-device mesh."""
    from test_torch_dp import dp_step_draws
    jcfg, jtr, ttr = tp.make_pair("float32")
    params = _params(jtr)
    epoch, n = 3, jcfg["train"]["real_freq"]
    mesh = jsharding.make_mesh(WORLD)
    steps = jsharding.make_sharded_real_steps_chained(jtr, mesh, n)
    rng = np.random.default_rng(jcfg["exp"]["seed"])
    pairs = [jsharding.host_sample_real_batch(rng, jtr.data, 4, N_RAYS)
             for _ in range(n)]
    batches = jax.tree.map(lambda *xs: np.stack(xs), *[p[0] for p in pairs])
    bgs = np.stack([p[1] for p in pairs])
    key, draws = jtr.key, []
    for i in range(n):       # the scan body's key splits
        key, k = jax.random.split(key)
        draws.append(dp_step_draws(k, jcfg, i))
    state, j_key, j_loss = steps(
        jsharding.replicate_state(jtr.state, mesh),
        jsharding.shard_batch_stacked(batches, mesh),
        jsharding.shard_batch_stacked({"bg": bgs}, mesh)["bg"], jtr.key,
        jnp.float32(epoch))
    np.testing.assert_array_equal(np.asarray(j_key), np.asarray(key))

    res = _launch(tmp_path, ranks.chained_epoch, _chained(ttr.config), params,
                  draws, epoch)
    lr = float(jtr.curr.learning_rate(epoch))
    for r in res:
        assert r["equal"] and r["chained"] == n
        assert r["global_step"] == int(state.global_step) == n
        assert r["np_state"] == rng.bit_generator.state
        np.testing.assert_allclose(r["loss"], float(j_loss), rtol=1e-4)
        np.testing.assert_allclose(r["occs"], np.asarray(state.occ.occs),
                                   rtol=1e-5, atol=1e-7)
        tp.assert_trees_close(r["params"], state.params, rtol=0,
                              atol=2 * n * lr, what="params")
    for k, v in res[0]["params"].items():
        np.testing.assert_array_equal(v, res[1]["params"][k])


def test_chained_epoch_is_the_eager_epoch_bit_for_bit(tmp_path):
    """Two epochs (6 real steps across occupancy refreshes, the warm-up's
    and sampled ones) of the chained trainer and of the eager one
    (chain_steps false) on the same two ranks end in the same state, bit
    for bit: the chained body adds the carried gradients always, zeros
    here, which changes no value."""
    res = _launch(tmp_path, ranks.chain_and_eager, _chained(
        tp.config_pair("float32")[1]), (3, 4))
    for r in res:
        assert r["chain"] == [True, False] and not r["graphed"]
        assert r["global_step"] == 6 and all(r["equal"])
        assert all(r["same"].values()), r["same"]


def _fixed_loss_inputs(over=None):
    jcfg, jtr, ttr = tp.make_pair("float32", overrides=over)
    batch, bg = jsharding.host_sample_real_batch(np.random.default_rng(1),
                                                 jtr.data, 4, N_RAYS)
    j_occ, _ = tp.fixed_occupancy(jcfg)
    draws = {k: np.asarray(v) for k, v in tp.render_draws(
        jax.random.PRNGKey(5), jcfg, N_RAYS).items()}
    return ttr, _params(jtr), draws, batch, bg, np.asarray(j_occ.occs)


@pytest.mark.parametrize("band_reuse", [True, False])
def test_padded_selections_are_members_then_inert(tmp_path, band_reuse):
    """Each rank's compaction (capacity 512 = the global budget, about
    half of it this rank's) and its smooth and band (reuse) or ladder
    (exact) subsets: the members first, then padding, which is not valid,
    at t 0, past every segment and in no ray's slot, and masked in every
    subset; the loss and every gradient the same, exactly, whatever real
    entry the padding repeats, and finite."""
    over = None if band_reuse else {"tpu": {"band_reuse": False}}
    ttr, params, draws, batch, bg, occ = _fixed_loss_inputs(over)
    res = _launch(tmp_path, ranks.padding, _chained(ttr.config), params,
                  draws, batch, bg, occ, 6)
    band = "band_sel" if band_reuse else "ladder_sel"
    for r in res:
        sels = r["selections"]
        assert set(sels) == {"compaction", "smooth_sel", band}
        assert sels["compaction"]["cap"] == 8 * N_RAYS
        assert 0 < sels["compaction"]["count"] < sels["compaction"]["cap"]
        for name, s in sels.items():
            assert s["members_first"] and s["inert"], (name, s)
        assert r["same_loss"] and r["same_grads"] and r["finite"]
    # the members of the two ranks' compactions make the global budget
    assert sum(r["selections"]["compaction"]["count"] for r in res) \
        == 8 * N_RAYS


def test_data_parallel_body_reads_nothing_back(tmp_path):
    """The chained data-parallel body (_real_body: the staged batch's
    march, the global compaction and subsets, the field, the losses with
    their global counts, the gradient bucket's all-reduce, the fold and
    the optimizer update) on two ranks under NoHostRead, which refuses
    each host read it is meant to."""
    cfg = _chained(tp.config_pair("float32")[1])
    res = _launch(tmp_path, ranks.body_reads_nothing_back, cfg, 6)
    for r in res:
        assert r["equal"] and np.isfinite(r["loss"])
        assert r["catches"] == ["nonzero", "item", "tolist", "int",
                                "masked_select", "mask_index",
                                "as_tensor"]
    assert res[0]["loss"] == res[1]["loss"]
