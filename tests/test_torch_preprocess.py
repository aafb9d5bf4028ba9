"""The port's offline preprocessing (morpheus_tpu_torch/preprocess) against
the JAX package's: the same synthetic raw RGB-D sequence, written twice,
goes through each package's run_pose_init and preprocess_sequence, and the
two directories hold the same files. PNGs are byte-identical; the arrays of
the .txt, .npy and .npz files agree within 1e-12. The port's DeformDataset
loads the output, and the port's load_K_Rt_from_P decomposes P = K [R|t]
as the JAX copy does, within 1e-10."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from morpheus_tpu import cameras as jcameras  # noqa: E402
from morpheus_tpu.preprocess import pose_init as jpose  # noqa: E402
from morpheus_tpu.preprocess import virtual_cams as jvirt  # noqa: E402
from morpheus_tpu_torch import cameras  # noqa: E402
from morpheus_tpu_torch.config import merge_defaults  # noqa: E402
from morpheus_tpu_torch.data.dataset import DeformDataset  # noqa: E402
from morpheus_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from morpheus_tpu_torch.preprocess import pose_init, virtual_cams  # noqa: E402


def write_raw_capture(d, scene):
    """rgb/ depth/ mask/ and intrinsics.txt, as tests/test_preprocess.py
    writes them."""
    for sub in ("rgb", "depth", "mask"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i in range(scene["num_frames"]):
        cv2.imwrite(os.path.join(d, "rgb", f"{i:04d}.png"),
                    cv2.cvtColor((scene["images"][i] * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(d, "depth", f"{i:04d}.png"),
                    (scene["depths"][i] * 1000).astype(np.uint16))
        cv2.imwrite(os.path.join(d, "mask", f"{i:04d}.png"),
                    (scene["masks"][i] * 255).astype(np.uint8))
    np.savetxt(os.path.join(d, "intrinsics.txt"), scene["K"])
    return d


def _files(d):
    return sorted(os.path.relpath(os.path.join(b, f), d)
                  for b, _, fs in os.walk(d) for f in fs)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX and the port's pipeline on two copies of one raw capture:
    pose init, then 48x48 virtual cameras."""
    scene = make_synthetic_scene(num_frames=4, H=72, W=96, radius=0.4,
                                 motion=0.05)
    out = {}
    for name, pi, vc in (("jax", jpose, jvirt),
                         ("port", pose_init, virtual_cams)):
        d = write_raw_capture(str(tmp_path_factory.mktemp(name)), scene)
        trans, radius = pi.run_pose_init(d, depth_scale=1000.0)
        res = vc.preprocess_sequence(d, size_h=48, size_w=48)
        out[name] = (d, trans, radius, res)
    return out


def test_preprocessing_writes_the_same_files(both):
    dj, tj, rj, resj = both["jax"]
    dp, tp, rp, resp = both["port"]
    files = _files(dj)
    assert files == _files(dp)
    assert "cameras_sphere.npz" in files and "K_virt.txt" in files
    assert sum(f.endswith(".png") for f in files) == 4 * 3 + 4 * 4
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-12)
    assert abs(rp - rj) <= 1e-12
    for f in files:
        a, b = os.path.join(dj, f), os.path.join(dp, f)
        if f.endswith(".png"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        elif f.endswith(".txt"):
            np.testing.assert_allclose(np.loadtxt(b), np.loadtxt(a),
                                       rtol=0, atol=1e-12, err_msg=f)
        elif f.endswith(".npy"):
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=0,
                                       atol=1e-12, err_msg=f)
        else:
            assert f.endswith(".npz"), f
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=1e-12,
                                           err_msg=f"{f}:{k}")
    for k in ("poses_virt", "K_virt", "radius", "theta", "phi"):
        np.testing.assert_allclose(resp[k], resj[k], rtol=0, atol=1e-12)


def test_port_dataset_loads_the_output(both):
    d = both["port"][0]
    ds = DeformDataset(merge_defaults({"data": {"data_dir": d}}))
    assert ds.num_frames == 4 and (ds.H, ds.W) == (48, 48)
    m = ds.masks[0]
    assert m.sum() > 50
    ys, xs = np.nonzero(m > 0.5)
    assert abs(ys.mean() - 24) < 8 and abs(xs.mean() - 24) < 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_K_Rt_from_P_matches_jax(seed):
    """P = K [R|t] from random K (positive focal lengths, skew), R and t:
    the intrinsics and the c2w pose as the JAX copy's within 1e-10, and the
    pose the inverse of [R|t] (float32)."""
    rng = np.random.default_rng(seed)
    K = np.array([[rng.uniform(200, 900), rng.uniform(-2, 2),
                   rng.uniform(100, 400)],
                  [0.0, rng.uniform(200, 900), rng.uniform(100, 400)],
                  [0.0, 0.0, 1.0]])
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    t = rng.normal(size=3) * 2.0
    P = K @ np.concatenate([Q, t[:, None]], 1)
    K_p, pose_p = cameras.load_K_Rt_from_P(P)
    K_j, pose_j = jcameras.load_K_Rt_from_P(P)
    np.testing.assert_allclose(K_p, K_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pose_p, pose_j, rtol=0, atol=1e-10)
    assert pose_p.dtype == np.float32
    np.testing.assert_allclose(K_p[:3, :3], K, rtol=1e-9)
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = Q, t
    np.testing.assert_allclose(pose_p, np.linalg.inv(w2c), atol=1e-5)
