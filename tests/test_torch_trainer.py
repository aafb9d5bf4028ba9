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

import pytest

torch = pytest.importorskip("torch")
import torch_parity as tp  # noqa: E402
from morpheus_tpu_torch.data.dataset import load_synthetic  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_real_loss_and_grads_match_jax(payload, monkeypatch):
    tp.check_real_loss_matches_jax(payload, "hist_rows", monkeypatch)


def test_trainer_imports_without_jax():
    """The port's trainer, guidance, CLI, mesh export, videos and eval
    worker import with jax and the JAX package unavailable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['morpheus_tpu'] = None; "
            "import morpheus_tpu_torch.train.trainer, morpheus_tpu_torch.convert, "
            "morpheus_tpu_torch.guidance.zero123, "
            "morpheus_tpu_torch.guidance.checkpoint, "
            "morpheus_tpu_torch.ops.segsum, morpheus_tpu_torch.ops.gather, "
            "morpheus_tpu_torch.__main__, morpheus_tpu_torch.mesh_export, "
            "morpheus_tpu_torch.vis.video, morpheus_tpu_torch.vis.mesh_video, "
            "morpheus_tpu_torch.eval.backfill, morpheus_tpu_torch.eval.culling, "
            "morpheus_tpu_torch.native")
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
    ("model", "encode_topo", True),
    ("tpu", "mlp_dtype", "bfloat16"),
    ("tpu", "compute_dtype", "bfloat16"),
    ("tpu", "data_parallel", 2),
    ("train", "optim", "adan"),
])
def test_unported_modes_raise(section, key, value):
    """Data parallelism needs its process group: without one of
    tpu.data_parallel ranks the trainer raises, saying how to start them
    (tests/test_torch_dp.py trains it). The other modes, once unported,
    now train and match JAX: the
    port takes three real steps (finite losses, every parameter group
    moves) and its real-view loss on a fixed batch matches the JAX
    trainer's at rtol 1e-4 (tests/torch_parity.py
    check_trains_and_loss_matches_jax); their gradients and three-step
    parity are in tests/test_torch_precision.py, test_torch_adan.py,
    test_torch_topo.py and test_torch_mode_steps.py."""
    if key == "data_parallel":
        _, tcfg = tp.config_pair("float32")
        tcfg[section][key] = value
        with pytest.raises(RuntimeError, match="needs a process group of 2 "
                           "ranks and none is up"):
            Trainer(tcfg, load_synthetic(tcfg), device="cpu")
        return
    ttr = tp.check_trains_and_loss_matches_jax({section: {key: value}})
    assert ttr.config[section][key] == value


def test_guidance_is_not_ported():
    """Guidance is ported (the SDS virtual step): the trainer takes a
    Zero123Guidance, computes the keyframe embeddings and moves the CLIP
    tower to the host; anything else is refused."""
    from morpheus_tpu_torch.guidance.zero123 import Zero123Guidance, Zero123Spec
    _, tcfg = tp.config_pair("float32")
    with pytest.raises(TypeError, match="Zero123Guidance"):
        Trainer(tcfg, load_synthetic(tcfg), device="cpu", guidance=object())
    g = Zero123Guidance.init_random(Zero123Spec(**tp.SPEC_KW), "cpu")
    tr = Trainer(tcfg, load_synthetic(tcfg), device="cpu", guidance=g)
    assert tr.embeddings["c_concat"].shape == (3, 4, 8, 8)
    assert tr.guidance.clip.proj.device.type == "cpu"
