"""The port's mesh export (mesh_export.py) against the JAX package's on the
same parameters (initialised in JAX, converted with convert.params_from_jax):
the dense SDF grid and the vertex colors at rtol 1e-4, atol 1e-5 (the same
float32 math in another summation order), and the mesh itself, which the
JAX extraction must give identically from the port's own grid.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu import mesh_export as jexport  # noqa: E402
from morpheus_tpu.model import field as jfield  # noqa: E402
from morpheus_tpu.ops import hashgrid as jhash  # noqa: E402
from morpheus_tpu.ops import meshing as jmeshing  # noqa: E402
from morpheus_tpu_torch import convert, mesh_export  # noqa: E402
from morpheus_tpu_torch.model.field import Field, FieldSpec  # noqa: E402
from morpheus_tpu_torch.ops import meshing  # noqa: E402
from morpheus_tpu_torch.ops.hashgrid import HashGridSpec  # noqa: E402

torch.set_num_threads(1)

GRID = dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
            log2_hashmap_size=10, desired_resolution=32)
FIELD = dict(num_frames=4, bound=1.01, bg_radius=0.0)
R = 20
RTOL, ATOL = 1e-4, 1e-5
TIMES = [pytest.param(None, id="cano"), pytest.param(0.25, id="t0.25")]


@pytest.fixture(scope="module")
def pair():
    jspec = jfield.FieldSpec(grid=jhash.HashGridSpec(**GRID), **FIELD)
    params = jfield.init_field(jax.random.PRNGKey(4), jspec)
    # off the geometric init, so the grid and the deformation shape the
    # surface
    params["sdf_grid"] = params["sdf_grid"] * 100.0
    params["color_grid"] = params["color_grid"] * 100.0
    w0 = params["deform_net"]["w"][0]
    params["deform_net"]["w"][0] = w0 + 0.2 * jax.random.normal(
        jax.random.PRNGKey(5), w0.shape)
    f = Field(FieldSpec(grid=HashGridSpec(**GRID), **FIELD), "cpu")
    f.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    return params, jspec, f


@pytest.mark.parametrize("t", TIMES)
def test_query_sdf_grid_matches_jax(pair, t):
    params, jspec, f = pair
    # chunks that do not divide the grid, on both sides
    got = mesh_export.query_sdf_grid(f, R, t=t, chunk=3000)
    want = jexport.query_sdf_grid(params, jspec, R, t=t, chunk=3000)
    assert got.shape == (R, R, R) and got.dtype == np.float32
    assert (got < 0).any() and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", TIMES)
def test_export_mesh_topology_and_colors_match_jax(pair, t, tmp_path):
    params, jspec, f = pair
    path = str(tmp_path / "m.ply")
    verts, faces, info = mesh_export.export_mesh(f, path, resolution=R, t=t,
                                                 chunk=3000)
    assert info["backend"] == "native" and len(faces) > 0
    assert (info["verts"], info["faces"]) == (len(verts), len(faces))
    # the JAX extraction of the port's own grid gives the identical mesh
    sdf = mesh_export.query_sdf_grid(f, R, t=t)
    jv, jf = jmeshing.extract_isosurface(sdf, 0.0)
    assert np.array_equal(jv / (R - 1.0) * 2.0 - 1.0, verts)
    assert np.array_equal(jf, faces)
    # the vertex colors, against the JAX export's chunk query
    got = mesh_export.vertex_colors(f, verts, t=t, chunk=500)
    want = jexport._query_chunk(
        params, jnp.asarray(verts, jnp.float32),
        jnp.asarray(0.0 if t is None else t, jnp.float32), jspec,
        t is None, True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # the PLY holds the mesh and its colors, quantised to bytes
    v, fc, c = meshing.load_ply(path)
    assert np.array_equal(v, verts.astype(np.float32))
    assert np.array_equal(fc, faces)
    np.testing.assert_array_equal(
        c, np.clip(got * 255.0, 0, 255).astype(np.uint8) / np.float32(255.0))


def test_export_all_meshes_writes_each_frame(pair, tmp_path):
    _, _, f = pair
    infos = mesh_export.export_all_meshes(f, str(tmp_path), 3, 7,
                                          resolution=12)
    assert [os.path.basename(i["path"]) for i in infos] == [
        f"mesh_0007_000{i}.ply" for i in range(3)]
    for i in infos:
        v, fc, c = meshing.load_ply(i["path"])
        assert len(v) == i["verts"] and len(fc) == i["faces"] and c is None
