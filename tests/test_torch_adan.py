"""The port's Adan (train/optim.py) against the JAX package's adan_update
over three steps - a first step (no gradient difference), a step whose
global gradient norm is clipped to 5, and a step with the deform freeze -
its non-finite skip, its 5x learning rate, an Adan trainer's checkpoint
round trip, and three real steps of an Adan trainer against the JAX
trainer's.

Tolerances: parameters at rtol 1e-6, atol 1e-7 (the same float32 update
in the same order, the global norm summed in another order); the three
steps at check_steps_match_jax's (losses rtol 1e-4, parameters within
2*n*lr: Adan's first step is sign(g) * lr, so a weight whose gradient is
at round-off level moves a full lr either way).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from morpheus_tpu.train import optim as joptim  # noqa: E402
from morpheus_tpu.train.schedule import Curriculum as JCurriculum  # noqa
from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.train import optim  # noqa: E402
from morpheus_tpu_torch.train.schedule import Curriculum  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402

SHAPES = {"sdf_grid": (50, 2), "deform_net": (7,), "pose": (4, 6),
          "beta": ()}


def test_adan_matches_adan_update():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    names = list(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tps = [torch.nn.Parameter(torch.as_tensor(params[k].copy()))
           for k in names]
    opt = optim.Adan(list(zip(names, tps)))
    js = joptim.adan_init(jp)
    # step 0: first step; step 1: gradients of global norm ~40 (clipped to
    # 5); step 2: the deform freeze (deform_net at rate 0)
    for step, (scale, freeze) in enumerate(((0.1, 0.0), (3.0, 0.0),
                                            (0.1, 1.0))):
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        lr = np.float32(1e-2)
        js, jp = joptim.adan_update(js, {k: jnp.asarray(v)
                                         for k, v in g.items()}, jp, lr,
                                    freeze)
        frozen = optim.FREEZE_GROUPS if freeze else ()
        before = tps[names.index("deform_net")].detach().clone()
        assert bool(opt.update([torch.as_tensor(g[k]) for k in names], lr,
                               frozen=frozen))
        for k, p in zip(names, tps):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
        for k in ("m", "v", "n", "prev_grad"):
            for name, a in zip(names, getattr(opt, k)):
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(getattr(js, k)[name]), rtol=1e-6,
                    atol=1e-7, err_msg=f"step {step} {k} {name}")
    # the frozen group neither stepped nor decayed
    assert torch.equal(before, tps[names.index("deform_net")])
    assert float(opt.step) == 3.0
    # a non-finite gradient leaves everything as it was
    state = [[t.clone() for t in getattr(opt, k)] for k in opt.SLOTS]
    bad = [torch.full_like(p, float("nan")) for p in tps]
    kept = [p.detach().clone() for p in tps]
    assert not bool(opt.update(bad, 1e-2))
    assert all(torch.equal(a, b) for a, b in zip(kept, tps))
    for k, saved in zip(opt.SLOTS, state):
        assert all(torch.equal(a, b) for a, b in zip(saved, getattr(opt, k)))
    assert float(opt.step) == 3.0


def test_adan_learning_rate_is_five_times_adams():
    """morpheus.py:149: get_params_all(5*lr) under Adan."""
    for name in ("adam", "adan"):
        jcfg, tcfg = tp.config_pair("float32", overrides={
            "train": {"optim": name}})
        for epoch in (0, 3, 6, 8):
            assert np.float32(Curriculum.from_config(tcfg).learning_rate(
                epoch)) == np.float32(JCurriculum.from_config(
                    jcfg).learning_rate(epoch))


def test_adan_trainer_checkpoint_round_trip(tmp_path):
    """An Adan trainer's checkpoint holds the optimizer's name and its four
    state tensors per parameter; it loads back into an Adan trainer and is
    refused by an Adam one."""
    _, cfg = tp.config_pair("float32", overrides={"train": {"optim": "adan"}})
    tr = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr.epoch = 3
    tr.real_step(3)
    path = str(tmp_path / "adan.pkl")
    tr.save_ckpt(path)
    state = tr.state_dict()
    assert state["optim"]["name"] == "adan"
    assert set(state["optim"]) == {"name", "step", "m", "v", "n",
                                   "prev_grad"}
    tr2 = Trainer(cfg, load_synthetic(cfg), device="cpu")
    tr2.load_ckpt(path)
    for k in optim.Adan.SLOTS:
        for a, b in zip(getattr(tr.optim, k), getattr(tr2.optim, k)):
            assert torch.equal(a, b)
    assert float(tr2.optim.step) == 1.0
    _, adam_cfg = tp.config_pair("float32")
    adam = Trainer(adam_cfg, load_synthetic(adam_cfg), device="cpu")
    with pytest.raises(ValueError, match="adan"):
        adam.load_ckpt(path)


def test_three_real_steps_match_jax_adan():
    tp.check_steps_match_jax(overrides={"train": {"optim": "adan"}})
