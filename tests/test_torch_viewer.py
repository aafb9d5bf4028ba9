"""The port's world-space viewer (python -m morpheus_tpu_torch.visualizer)
and what it is built from, against the JAX package's visualizer.py:

- TSDFVolume on the CPU (float64 projection) against the JAX numpy copy:
  tsdf, weight and color within 1e-6, with at most 0.01% of the voxels
  apart (a voxel whose projection lands on a pixel's half coordinate may
  round the other way; the test prints how many);
- RenderDataset's raw and NDR spaces, get_recon2world_transform and
  create_360_trajectory within 1e-12;
- render_world_video writes byte-identical frames from the same foreground
  and background PLYs;
- the entry point on a tiny trained workspace with --device cpu writes its
  frames and mp4 (its background mesh fused beforehand on a coarse volume:
  the default 401^3 volume is fused on the card); without --device, on a
  host without CUDA, it raises.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import visualizer as jvisualizer  # noqa: E402
from morpheus_tpu.config import merge_defaults as jmerge  # noqa: E402
from morpheus_tpu.data.dataset import RenderDataset as JRenderDataset  # noqa: E402
from morpheus_tpu.eval import tsdf as jtsdf  # noqa: E402
from morpheus_tpu.vis import pose_utils as jpose_utils  # noqa: E402
from morpheus_tpu_torch import visualizer  # noqa: E402
from morpheus_tpu_torch.config import merge_defaults  # noqa: E402
from morpheus_tpu_torch.data.dataset import RenderDataset  # noqa: E402
from morpheus_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from morpheus_tpu_torch.eval import tsdf  # noqa: E402
from morpheus_tpu_torch.ops import meshing  # noqa: E402
from morpheus_tpu_torch.preprocess import pose_init, virtual_cams  # noqa: E402
from morpheus_tpu_torch.vis import pose_utils  # noqa: E402
from test_torch_preprocess import write_raw_capture  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 3


def scene_with_wall(num_frames=FRAMES, H=60, W=80):
    """The synthetic sphere with a slanted, checkered wall 2.8-3.2 m behind
    it in every frame's camera (a static background, as a raw capture
    from a fixed RGB-D camera has)."""
    sc = make_synthetic_scene(num_frames=num_frames, H=H, W=W, radius=0.4,
                              motion=0.05)
    v, u = np.mgrid[0:H, 0:W]
    wall = (2.8 + 0.4 * v / H).astype(np.float32)
    check = ((v // 6 + u // 6) % 2).astype(np.float32)
    color = np.stack([0.3 + 0.4 * check, 0.5 + 0.0 * check,
                      0.7 - 0.4 * check], -1)
    bg = sc["masks"] < 0.5
    sc["depths"] = np.where(bg, wall, sc["depths"]).astype(np.float32)
    sc["images"] = np.where(bg[..., None], color,
                            sc["images"]).astype(np.float32)
    return sc


def test_tsdf_matches_jax():
    sc = scene_with_wall()
    bounds = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]])
    kw = {"voxel_size": 0.05, "bounds": bounds, "mask_out_object": False}
    want = jtsdf.run_tsdf_fusion(sc["images"], sc["depths"], sc["masks"],
                                 sc["K"], sc["poses"], **kw)
    got = tsdf.run_tsdf_fusion(sc["images"], sc["depths"], sc["masks"],
                               sc["K"], sc["poses"], device="cpu", **kw)
    assert (got.dims == want.dims).all()
    apart = np.zeros(tuple(want.dims), bool)
    for name in ("tsdf", "weight", "color"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.dtype == w.dtype == np.float32
        err = np.abs(g - w).reshape(apart.shape + (-1,)).max(-1)
        apart |= err > 1e-6
    n = int(apart.sum())
    print(f"TSDF voxels apart: {n} of {apart.size} "
          f"({int((want.weight > 0).sum())} observed)")
    assert (want.weight > 0).sum() > 5000
    assert n <= 1e-4 * apart.size
    if n == 0:
        (gv, gf, gc), (wv, wf, wc) = got.extract_mesh(), want.extract_mesh()
        assert len(wf) > 1000
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gc, wc)


def preprocessed_capture(d, frames=FRAMES):
    """A raw capture of `frames` frames under d, preprocessed (pose init,
    48x48 virtual cameras)."""
    write_raw_capture(d, scene_with_wall(frames))
    pose_init.run_pose_init(d)
    virtual_cams.preprocess_sequence(d, size_h=48, size_w=48)
    return d


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return preprocessed_capture(str(tmp_path_factory.mktemp("capture")))


def _renderer(cls, config, dataset, workspace):
    """A Renderer of either package around a given dataset (no trainer)."""
    r = object.__new__(cls)
    r.config, r.dataset, r.workspace = config, dataset, workspace
    r.stats = {}
    return r


@pytest.fixture(scope="module")
def datasets(capture):
    cfg = {"data": {"data_dir": capture}}
    return (JRenderDataset(jmerge(cfg)), RenderDataset(merge_defaults(cfg)))


def test_render_dataset_and_transforms_match_jax(datasets):
    jd, td = datasets
    for k in ("images", "depths", "masks"):
        np.testing.assert_array_equal(td.raw[k], jd.raw[k])
    for k in ("poses_ndr", "K_ndr", "poses_raw", "K_raw"):
        np.testing.assert_allclose(getattr(td, k), getattr(jd, k), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert td.sc_ndr == jd.sc_ndr
    jr = _renderer(jvisualizer.Renderer, None, jd, None)
    tr = _renderer(visualizer.Renderer, None, td, None)
    offset = np.diag([1.0, 2.0, 0.5, 1.0])
    for off in (None, offset):
        for a, b in zip(tr.get_recon2world_transform(off),
                        jr.get_recon2world_transform(off)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    rng = np.random.default_rng(0)
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = rng.normal(size=3)
    target, axis = rng.normal(size=3), rng.normal(size=3)
    for reverse in (False, True):
        got = pose_utils.create_360_trajectory(c2w, target, axis, 7, reverse)
        want = jpose_utils.create_360_trajectory(c2w, target, axis, 7,
                                                 reverse)
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(pose_utils.gl2cv(c2w),
                                  jpose_utils.gl2cv(c2w))


def _fg_meshes(mesh_dir, n):
    """n colored sphere meshes of growing radius, as per-frame PLYs."""
    os.makedirs(mesh_dir, exist_ok=True)
    g = np.linspace(-1, 1, 24)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    for i in range(n):
        sdf = np.sqrt(x ** 2 + y ** 2 + z ** 2) - (0.4 + 0.1 * i)
        v, f, _ = meshing.extract_isosurface(sdf.astype(np.float32))
        v = v / 23.0 * 2 - 1
        meshing.save_ply(os.path.join(mesh_dir, f"mesh_{i:04d}.ply"), v, f,
                         np.clip(0.5 + 0.5 * v, 0, 1))


def _fuse_background(dataset, data_dir, voxel_size=0.1):
    """The background mesh the viewer reuses, fused by the port on the CPU
    on a coarse volume."""
    raw = dataset.raw
    vol = tsdf.run_tsdf_fusion(raw["images"], raw["depths"], raw["masks"],
                               dataset.K_raw, dataset.poses_raw,
                               voxel_size=voxel_size, device="cpu")
    v, f, c = vol.extract_mesh()
    path = os.path.join(data_dir, "scene_meshes", "bg_mesh.ply")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meshing.save_ply(path, v, f, c)
    return f


@pytest.mark.parametrize("traj", ["360", "real_view"])
def test_render_world_video_writes_the_same_frames(capture, datasets,
                                                   tmp_path, traj):
    jd, td = datasets
    faces = _fuse_background(td, capture)
    assert len(faces) > 500
    mesh_dir = str(tmp_path / "fg")
    _fg_meshes(mesh_dir, FRAMES)
    cfg = {"data": {"data_dir": capture}}
    frames = []
    for cls, ds, name in ((jvisualizer.Renderer, jd, "jax"),
                          (visualizer.Renderer, td, "port")):
        r = _renderer(cls, cfg, ds, str(tmp_path / name))
        frames.append(r.render_world_video(mesh_dir, traj))
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)
    assert len(frames[1]) == FRAMES and frames[1][0].shape == (60, 80, 3)
    assert frames[1][0].std() > 1.0          # not a blank frame
    for i in range(FRAMES):
        png = os.path.join("scene_renderings", "rgb", f"{i:04d}.png")
        assert open(tmp_path / "jax" / png, "rb").read() == \
            open(tmp_path / "port" / png, "rb").read()
    assert os.path.exists(tmp_path / "port" / "scene_renderings" /
                          f"render_{traj}.mp4")


TINY = {
    "exp": {"exp_name": "view", "test_interval": 100, "mesh_interval": 100,
            "mesh_all_interval": 100, "mesh_all_eval_interval": 100},
    "train": {"n_epochs": 1, "n_iters": 1, "warm_up_end": 3,
              "warm_up_steps": 2, "normal_smoothness": 0.0,
              "normal_smooth_3d": 0.0},
    "model": {"bg_radius": 0.0, "grid_num_levels": 4,
              "grid_log2_hashmap_size": 12, "grid_desired_resolution": 48},
    "tpu": {"max_samples_per_ray": 32, "march_steps": 64,
            "occ_resolution": 16, "occ_warmup_steps": 4,
            "occ_update_every": 8},
}


def test_viewer_entry_point_on_a_trained_workspace(tmp_path, monkeypatch):
    """One epoch of the port's CLI on a preprocessed two-frame capture (the
    256^3 colored export takes ~1 min a frame on the CPU), then
    `python -m morpheus_tpu_torch.visualizer --device cpu --traj 360`:
    it loads that epoch's checkpoint, exports the colored per-frame
    meshes, composes them with the background and writes the frames and
    the mp4; `viewer-stats` and `kernel-launches` lines end its output."""
    import yaml

    import morpheus_tpu_torch.__main__ as cli
    capture = preprocessed_capture(str(tmp_path / "capture"), frames=2)
    cfg = {k: dict(v) for k, v in TINY.items()}
    cfg["data"] = {"data_dir": capture}
    cfg["exp"]["output"] = str(tmp_path / "exp")
    path = tmp_path / "view.yaml"
    path.write_text(yaml.dump(cfg))
    _fuse_background(RenderDataset(merge_defaults(cfg)), capture)
    monkeypatch.setattr(cli, "MESH_RES", 16)
    monkeypatch.setattr(cli, "MESH_ALL_RES", 16)
    monkeypatch.setattr(cli, "MESH_ALL_FINAL_RES", 16)
    monkeypatch.setenv("MORPHEUS_EVAL_DRAIN_S", "600")
    cli.main(["--config", str(path), "--device", "cpu"])
    ws = tmp_path / "exp" / "view"
    assert (ws / "models" / "model_ep_0001.pkl").exists()

    r = subprocess.run(
        [sys.executable, "-m", "morpheus_tpu_torch.visualizer", "--config",
         str(path), "--traj", "360", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "not found; using random weights" not in r.stdout
    stats = json.loads(r.stdout.split("viewer-stats ", 1)[1].splitlines()[0])
    assert stats["frames"] == 2 and stats["fg_exports"] == 2
    assert min(stats["fg_faces"]) > 0 and stats["bg_mesh_faces"] > 500
    assert "tsdf_s" not in stats           # the background was reused
    out = ws / "scene_renderings"
    assert sorted(os.listdir(out / "rgb")) == ["0000.png", "0001.png"]
    assert (out / "render_360.mp4").stat().st_size > 0
    meshes = os.listdir(ws / f"mesh_final_color_{visualizer.FG_RES}")
    assert sorted(meshes) == ["mesh_0001_0000.ply", "mesh_0001_0001.ply"]
    assert "kernel-launches" in r.stdout

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        visualizer.main(["--config", str(path), "--traj", "360"])
