"""Checkpoints: the port's save_ckpt/load_ckpt resume a run bit for bit on
the CPU, and convert.load_jax_ckpt reads a JAX Trainer.save_ckpt file, in a
process where jax and the JAX package cannot be imported, into exactly the
JAX arrays."""
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.model import field as jfield  # noqa: E402
from morpheus_tpu.ops import hashgrid as jhash  # noqa: E402
from morpheus_tpu.ops import occupancy as jocc  # noqa: E402
from morpheus_tpu.train import optim as joptim  # noqa: E402
from morpheus_tpu.train import trainer as jtrainer  # noqa: E402
from morpheus_tpu_torch import convert  # noqa: E402
from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _epochs(tr, n):
    loss = None
    for _ in range(n):
        tr.epoch += 1
        loss = tr.train_one_epoch()
    return loss


def _state(tr):
    return ([p.detach().clone() for p in tr.params],
            [m.clone() for m in tr.optim.mu], [v.clone() for v in tr.optim.nu],
            [e.clone() for e in tr.ema], tr.optim.step.clone(),
            tr.occ.occs.clone(), tr.occ.binaries.clone())


def test_resume_equals_straight_run(tmp_path):
    _, cfg = tp.config_pair("bfloat16")
    straight = Trainer(cfg, load_synthetic(cfg), device="cpu")
    loss_straight = _epochs(straight, 3)

    first = Trainer(cfg, load_synthetic(cfg), device="cpu")
    _epochs(first, 2)
    path = str(tmp_path / "models" / "model_ep_0002.pkl")
    first.save_ckpt(path)
    assert not os.path.exists(path + ".tmp")
    resumed = Trainer(cfg, load_synthetic(cfg), device="cpu", seed=99)
    resumed.load_ckpt(path)
    assert (resumed.epoch, resumed.global_step) == (2, first.global_step)
    loss_resumed = _epochs(resumed, 1)

    assert resumed.global_step == straight.global_step
    assert loss_resumed == loss_straight
    for a, b in zip(_state(resumed), _state(straight)):
        if isinstance(a, list):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)
    # the EMA field (the test videos' weights) follows the loaded EMA
    ema_field = dict(resumed.ema_field.named_parameters())
    for n, e in zip(resumed.optim.names, resumed.ema):
        assert torch.equal(ema_field[n], e)


def test_ckpt_holds_only_plain_types(tmp_path):
    _, cfg = tp.config_pair("float32")
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    path = str(tmp_path / "m.pkl")
    tr.save_ckpt(path)

    class Plain(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] != "numpy":
                raise pickle.UnpicklingError(f"{module}.{name}")
            return super().find_class(module, name)

    with open(path, "rb") as f:
        state = Plain(f).load()
    assert set(state) == {"params", "optim", "ema", "occ", "global_step",
                          "epoch", "draws", "host_step", "pending_grads"}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A file written by the JAX Trainer.save_ckpt at tiny size, with
    nonzero moments, an EMA apart from the parameters, carried virtual-step
    gradients (pending_grads) and a host step apart from the global step.
    The trainer is a stand-in holding only what save_ckpt reads (state,
    epoch, optim_name, key, _host_step), so no JAX step is compiled."""
    spec = jfield.FieldSpec(grid=jhash.HashGridSpec(
        num_levels=4, log2_hashmap_size=10, base_resolution=8,
        desired_resolution=32), num_frames=4, bound=1.01, bg_radius=0.0)
    p = jfield.init_field(jax.random.PRNGKey(2), spec)
    rng = np.random.default_rng(6)

    def rand(tree):
        return jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
            a.shape).astype(np.float32)), tree)

    jtr = types.SimpleNamespace(
        state=jtrainer.TrainState(
            params=p, opt_state=joptim.AdamState(
                step=jnp.asarray(7, jnp.int32), mu=rand(p), nu=rand(p)),
            ema=rand(p), occ=jocc.init_occupancy(16),
            global_step=jnp.asarray(21, jnp.int32), pending_grads=rand(p)),
        epoch=5, optim_name="adam", key=jax.random.PRNGKey(0), spec=spec,
        _host_step=23)
    path = str(tmp_path_factory.mktemp("jax") / "model_ep_0005.pkl")
    jtrainer.Trainer.save_ckpt(jtr, path)
    return jtr, path


def _load_without_jax(path, out):
    code = ("import pickle, sys; sys.modules['jax'] = None; "
            "sys.modules['morpheus_tpu'] = None; "
            "from morpheus_tpu_torch import convert; "
            f"d = convert.load_jax_ckpt({path!r}); "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'morpheus_tpu.'))"
            " for m in sys.modules if sys.modules[m] is not None); "
            f"pickle.dump(d, open({out!r}, 'wb'))")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    with open(out, "rb") as f:
        return pickle.load(f)


def test_jax_ckpt_loads_without_jax(jax_ckpt, tmp_path):
    jtr, path = jax_ckpt
    got = _load_without_jax(path, str(tmp_path / "out.pkl"))
    st = jtr.state
    want = {
        "params": st.params, "ema": st.ema, "pending_grads": st.pending_grads,
        "mu": st.opt_state.mu, "nu": st.opt_state.nu}
    for key, tree in want.items():
        ref = convert.params_from_jax(jax.tree.map(np.asarray, tree))
        have = got[key] if key not in ("mu", "nu") else got["optim"][key]
        assert set(have) == set(ref)
        for name, a in ref.items():
            assert np.array_equal(have[name], a.numpy()), (key, name)
    assert got["optim"]["step"] == 7.0
    assert np.array_equal(got["occ"]["occs"], np.asarray(st.occ.occs))
    assert np.array_equal(got["occ"]["binaries"],
                          np.asarray(st.occ.binaries))
    assert (got["global_step"], got["epoch"], got["host_step"]) == (21, 5,
                                                                      23)

    # and it loads into the port's trainer, the carried gradients with it
    _, cfg = tp.config_pair("float32")
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr.load_state_dict(got)
    for name, p in tr.field.named_parameters():
        assert np.array_equal(p.detach().numpy(), got["params"][name])
    for name, g in zip(tr.optim.names, tr.pending):
        assert np.array_equal(g.numpy(), got["pending_grads"][name])
    assert tr._pending_live
    assert (tr.epoch, tr.global_step, tr.host_step) == (5, 21, 23)


def test_jax_adan_ckpt_and_foreign_classes_are_refused(jax_ckpt, tmp_path):
    """A JAX Adan checkpoint (AdanState) now loads, without jax, into an
    Adan trainer: its step and four state trees come across exactly.
    Classes foreign to a checkpoint are still refused."""
    jtr, _ = jax_ckpt
    rng = np.random.default_rng(8)
    p = jtr.state.params

    def rand(tree):
        return jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
            a.shape).astype(np.float32)), tree)

    opt = joptim.AdanState(step=jnp.asarray(4, jnp.int32), m=rand(p),
                           v=rand(p), n=rand(p), prev_grad=rand(p))
    adan = types.SimpleNamespace(**{
        **vars(jtr), "optim_name": "adan",
        "state": jtr.state._replace(opt_state=opt)})
    path = str(tmp_path / "models" / "adan.pkl")
    jtrainer.Trainer.save_ckpt(adan, path)
    got = _load_without_jax(path, str(tmp_path / "out.pkl"))
    assert got["optim"]["name"] == "adan" and got["optim"]["step"] == 4.0
    for k in ("m", "v", "n", "prev_grad"):
        ref = convert.params_from_jax(jax.tree.map(np.asarray,
                                                   getattr(opt, k)))
        assert set(got["optim"][k]) == set(ref)
        for name, a in ref.items():
            assert np.array_equal(got["optim"][k][name], a.numpy()), (k, name)
    _, cfg = tp.config_pair("float32", overrides={"train": {"optim": "adan"}})
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr.load_state_dict(got)
    for name, t in zip(tr.optim.names, tr.optim.prev_grad):
        assert np.array_equal(t.numpy(), got["optim"]["prev_grad"][name])
    assert float(tr.optim.step) == 4.0
    bad = str(tmp_path / "bad.pkl")
    with open(bad, "wb") as f:
        pickle.dump({"state": {"spec": jtr.spec}}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        convert.load_jax_ckpt(bad)
