"""Iso-surface extraction + PLY mesh I/O (the port's copy of
morpheus_tpu/ops/meshing.py; host code, numpy only).

Replaces the reference's PyMCubes marching cubes + trimesh export
(morpheus.py:367-408). Extraction uses marching *tetrahedra* (each cube split
into 6 tets): a fully vectorized numpy implementation with exact zero-crossing
interpolation — same surface accuracy as marching cubes without the 256-entry
case tables, and trivially correct. The native C++ version of the same
algorithm (morpheus_tpu_torch/native/) is what `extract_isosurface` runs
when it builds.
"""
from __future__ import annotations

import struct
import subprocess

import numpy as np

# Each cube [0,1]^3 split into 6 tetrahedra sharing the main diagonal (0,7).
# Corner numbering: bit0=x, bit1=y, bit2=z.
_TETS = np.array([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
], dtype=np.int32)

_CORNERS = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                     for c in range(8)], dtype=np.int32)


def marching_tetrahedra(sdf: np.ndarray, level: float = 0.0):
    """Extract the `level` iso-surface of a dense scalar grid.

    sdf: (X, Y, Z) array. Returns (vertices (V,3) in index coordinates,
    triangles (F,3) int). Vertices are deduplicated.
    """
    sdf = np.asarray(sdf, np.float32)
    X, Y, Z = sdf.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    f = sdf - level
    # cube corner values/coords: (X-1, Y-1, Z-1, 8)
    base = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                                np.arange(Z - 1), indexing="ij"), -1)  # (...,3)
    ncubes = (X - 1) * (Y - 1) * (Z - 1)
    base = base.reshape(-1, 3)

    corner_vals = np.empty((ncubes, 8), np.float32)
    for c in range(8):
        dx, dy, dz = _CORNERS[c]
        corner_vals[:, c] = f[dx:X - 1 + dx, dy:Y - 1 + dy,
                              dz:Z - 1 + dz].ravel()

    tris = []
    for tet in _TETS:
        v = corner_vals[:, tet]                      # (n, 4)
        inside = v < 0
        code = (inside[:, 0].astype(np.int32)
                | (inside[:, 1] << 1) | (inside[:, 2] << 2)
                | (inside[:, 3] << 3))
        # coordinates of the 4 tet corners for all cubes: (n, 4, 3)
        pts = base[:, None, :] + _CORNERS[tet][None, :, :]

        def edge_point(sel, a, b):
            """Zero crossing on tet edge a-b for selected cubes."""
            va, vb = v[sel, a], v[sel, b]
            t = va / (va - vb + 1e-30)
            return pts[sel, a] + t[:, None] * (pts[sel, b] - pts[sel, a])

        # one-inside cases (1 triangle), by inside corner i
        for i in range(4):
            others = [j for j in range(4) if j != i]
            sel = code == (1 << i)
            if not np.any(sel):
                continue
            p = [edge_point(sel, i, j) for j in others]
            tris.append(np.stack(p, axis=1))
        # three-inside cases (1 triangle), by outside corner i
        for i in range(4):
            others = [j for j in range(4) if j != i]
            sel = code == (0b1111 ^ (1 << i))
            if not np.any(sel):
                continue
            p = [edge_point(sel, i, j) for j in others]
            tris.append(np.stack(p, axis=1))
        # two-inside cases (quad → 2 triangles)
        for (a, b) in [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]:
            others = [j for j in range(4) if j not in (a, b)]
            sel = code == ((1 << a) | (1 << b))
            if not np.any(sel):
                continue
            c0, c1 = others
            pa0 = edge_point(sel, a, c0)
            pa1 = edge_point(sel, a, c1)
            pb0 = edge_point(sel, b, c0)
            pb1 = edge_point(sel, b, c1)
            tris.append(np.stack([pa0, pb0, pa1], axis=1))
            tris.append(np.stack([pa1, pb0, pb1], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tri_pts = np.concatenate(tris, axis=0)            # (F, 3, 3)

    # dedup vertices
    flat = tri_pts.reshape(-1, 3)
    keys = np.round(flat * 1e5).astype(np.int64)
    _, idx, inv = np.unique(keys, axis=0, return_index=True,
                            return_inverse=True)
    verts = flat[idx]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return verts.astype(np.float32), faces[ok]


def extract_isosurface(sdf: np.ndarray, level: float = 0.0, backend="auto"):
    """(vertices, faces, backend that ran): the native C++ extraction when
    it builds and loads ("auto" falls back to numpy otherwise, "native"
    raises), or the numpy one ("numpy")."""
    if backend in ("auto", "native"):
        try:
            from ..native import mcubes_native
            verts, faces = mcubes_native.marching_cubes(
                np.ascontiguousarray(sdf, np.float32), float(level))
            return verts, faces, "native"
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            if backend == "native":
                raise
    verts, faces = marching_tetrahedra(sdf, level)
    return verts, faces, "numpy"


# ---- PLY I/O (replaces trimesh; reference morpheus.py:407-408) ----

def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
             vertex_colors: np.ndarray | None = None):
    """Binary little-endian PLY writer."""
    V, F = len(vertices), len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {V}",
               "property float x", "property float y", "property float z"]
        if vertex_colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {F}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if vertex_colors is not None:
            cols = np.clip(vertex_colors * 255.0, 0, 255).astype(np.uint8)
            for v, c in zip(vertices.astype("<f4"), cols):
                f.write(v.tobytes() + c.tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        lead = np.full((F, 1), 3, np.uint8)
        body = b"".join(struct.pack("<B3i", 3, *face) for face in
                        faces.astype(np.int64)) if F < 100000 else None
        if body is None:
            rec = np.zeros(F, dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = lead[:, 0]
            rec["idx"] = faces
            body = rec.tobytes()
        f.write(body)


def load_ply(path: str):
    """Minimal PLY reader (binary-LE or ascii) for our own exports + eval."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    header = data[:end].decode().splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt = "ascii" if any("format ascii" in line for line in header) else "binary"
    nv = nf = 0
    vprops = []
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                nv = int(parts[2])
            elif cur == "face":
                nf = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            vprops.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    if fmt == "binary":
        dt = np.dtype([(n, type_map[t]) for n, t in vprops])
        varr = np.frombuffer(body, dtype=dt, count=nv)
        verts = np.stack([varr["x"], varr["y"], varr["z"]], -1).astype(np.float32)
        off = nv * dt.itemsize
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        farr = np.frombuffer(body, dtype=fdt, count=nf, offset=off)
        faces = farr["idx"].astype(np.int32)
        colors = None
        if "red" in [n for n, _ in vprops]:
            colors = np.stack([varr["red"], varr["green"], varr["blue"]],
                              -1).astype(np.float32) / 255.0
        return verts, faces, colors
    # ascii
    lines = body.decode().splitlines()
    verts = np.array([[float(x) for x in l.split()[:3]] for l in lines[:nv]],
                     np.float32)
    faces = np.array([[int(x) for x in l.split()[1:4]]
                      for l in lines[nv:nv + nf]], np.int32)
    return verts, faces, None
