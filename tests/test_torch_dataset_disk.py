"""The port's disk loader, pose outlier removal and eval-render rays
(data/dataset.py) against the JAX package's, on a 3-frame preprocessed
sequence written to a temporary directory (8-bit colour and mask PNGs,
16-bit depth PNGs, pose, intrinsics and r/theta/phi text files). Loaded
arrays must be equal; rays agree at atol 1e-6 (float32 products)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
import jax  # noqa: E402

from morpheus_tpu.config import merge_defaults as jax_merge_defaults  # noqa: E402
from morpheus_tpu.data import dataset as jdata  # noqa: E402
from morpheus_tpu_torch.config import merge_defaults  # noqa: E402
from morpheus_tpu_torch.data import dataset as data  # noqa: E402
from morpheus_tpu_torch.cameras import c2w_from_polar  # noqa: E402

T, H, W = 3, 12, 16
ATOL = 1e-6


def _write_sequence(root, jump: bool = False):
    rng = np.random.default_rng(3)
    for sub in ("color_virt", "depth_raw_crop", "mask_virt", "poses_virt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    r = np.float32(2.5) + rng.uniform(-0.1, 0.1, T).astype(np.float32)
    theta = 80.0 + rng.uniform(-5, 5, T)
    phi = np.array([10.0, 50.0, 350.0])
    poses = c2w_from_polar(r, theta, phi).astype(np.float64)
    if jump:
        poses[1, :3, 3] += 3.0
    for i in range(T):
        cv2.imwrite(os.path.join(root, "color_virt", f"{i:04d}.png"),
                    rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        cv2.imwrite(os.path.join(root, "depth_raw_crop", f"{i:04d}.png"),
                    rng.integers(0, 4000, (H, W), dtype=np.uint16))
        cv2.imwrite(os.path.join(root, "mask_virt", f"{i:04d}.png"),
                    (rng.uniform(size=(H, W)) > 0.5).astype(np.uint8) * 255)
        np.savetxt(os.path.join(root, "poses_virt", f"{i:04d}.txt"), poses[i])
    np.savetxt(os.path.join(root, "K_virt.txt"),
               np.array([[20.0, 0, 8.2], [0, 21.0, 5.9], [0, 0, 1]]))
    np.savetxt(os.path.join(root, "r_theta_phi.txt"),
               np.stack([r, theta, phi], -1))
    return str(root)


def _pair(root, **data_kw):
    cfg = {"data": {"data_dir": root, **data_kw}}
    jcfg, tcfg = jax_merge_defaults(cfg), merge_defaults(cfg)
    return (jcfg, jdata.DeformDataset(jcfg)), (tcfg, data.DeformDataset(tcfg))


@pytest.mark.parametrize("outlier_remove", [False, True])
def test_disk_sequence_loads_equal(tmp_path, outlier_remove):
    root = _write_sequence(tmp_path, jump=outlier_remove)
    (_, jds), (_, tds) = _pair(root, outlier_remove=outlier_remove,
                               depth_scale=500.0)
    assert (tds.num_frames, tds.H, tds.W) == (T, H, W)
    for key in ("images", "depths", "masks", "poses", "intrinsics", "radius",
                "theta", "phi"):
        got, want = getattr(tds, key), getattr(jds, key)
        assert got.dtype == want.dtype, key
        assert np.array_equal(got, want), key
    assert tds.bound == jds.bound


def test_remove_outlier_matches_jax():
    rng = np.random.default_rng(0)
    n = 12
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    poses[5, :3, 3] += 1.0                       # one frame jumps away
    poses[6, :3, 3] += 1.0                       # and the next stays there
    angles = [rng.uniform(0, 90, n).astype(np.float32) for _ in range(3)]
    ours = [a.copy() for a in angles]
    theirs = [a.copy() for a in angles]
    got = data.remove_outlier(poses.copy(), *ours)
    want = jdata.remove_outlier(poses.copy(), *theirs)
    assert np.array_equal(got, want)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    assert not np.array_equal(got, poses)        # something was replaced


def test_full_frame_rays_match_jax(tmp_path):
    root = _write_sequence(tmp_path)
    (_, jds), (_, tds) = _pair(root)
    jd = jds.device_data()
    td = tds.device_data("cpu")
    for i in range(T):
        got = data.full_frame_rays(td, T, i)
        want = jdata.full_frame_rays(jd, T, i)
        for key in ("rays_o", "rays_d", "rays_t", "rays_id"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_fixed_angle_virtual_view_matches_jax(tmp_path, scale):
    root = _write_sequence(tmp_path)
    (jcfg, jds), (tcfg, tds) = _pair(root, novel_view_scale_factor=1.2)
    js = jdata.VirtualViewSampler(jds, jcfg, scale)
    ts = data.VirtualViewSampler(tds, tcfg, scale, "cpu")
    assert (ts.H, ts.W) == (js.H, js.W)
    for i, (th, ph) in enumerate(((90.0, 0.0), (70.0, 180.0), (85.0, 300.0))):
        got = ts.sample(frame_idx=i, theta_deg=th, phi_deg=ph)
        want = js.sample(jax.random.PRNGKey(i), frame_idx=i, theta_deg=th,
                         phi_deg=ph)
        for key in ("rays_o", "rays_d", "rays_t", "rays_id", "polar",
                    "azimuth", "radius"):
            g = got[key]
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_allclose(g, np.asarray(want[key]), rtol=0,
                                       atol=ATOL, err_msg=key)
    # the random frame and camera of the SDS step: the JAX key tree
    # replayed by name (tests/torch_parity.py camera_draws)
    import torch_parity as tp
    key = jax.random.PRNGKey(7)
    want = js.sample(key)
    got = ts.sample(draws=tp.ReplayDraws(tp.camera_draws(key,
                                                         tds.num_frames)))
    assert int(got["frame_idx"]) == int(want["frame_idx"])
    for k in ("rays_o", "rays_d", "rays_t", "rays_id", "radius"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("polar", "azimuth"):      # degrees
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="needs draws"):
        ts.sample()
