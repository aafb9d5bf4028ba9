"""Software depth rasterizer — replaces pyrender/OSMesa
(reference: tools/culling.py:51-84).

Meshes fed to the culling protocol are pre-subdivided to max edge 0.01 world
units (tools/culling.py:95), so projected triangles span only a few pixels.
The rasterizer exploits that: every triangle is tested against a fixed BLOCK×
BLOCK pixel window anchored at its bbox corner — fully vectorized barycentric
coverage + z-interpolation + scatter-min, no per-triangle Python loop. Larger
triangles (rare; un-subdivided meshes) fall back to a bbox loop.
"""
from __future__ import annotations

import numpy as np

_BLOCK = 4


def _project(points: np.ndarray, c2w_gl: np.ndarray, K: np.ndarray):
    """OpenGL c2w pose + pinhole K → pixel coords (x, y) and camera-z depth."""
    c2w = c2w_gl.copy()
    c2w[:3, 1] *= -1   # OpenGL → OpenCV
    c2w[:3, 2] *= -1
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    u = K[0, 0] * cam[:, 0] / np.maximum(z, 1e-8) + K[0, 2]
    v = K[1, 1] * cam[:, 1] / np.maximum(z, 1e-8) + K[1, 2]
    return u, v, z


def render_depth_map(vertices: np.ndarray, faces: np.ndarray,
                     c2w_gl: np.ndarray, K: np.ndarray, H: int, W: int,
                     near: float = 0.01, far: float = 10.0) -> np.ndarray:
    """Depth map (H, W), 0 where no geometry. Double-sided (no backface cull),
    matching render_depth_maps_doublesided (tools/culling.py:71-84)."""
    if len(faces) == 0:
        return np.zeros((H, W), np.float32)
    u, v, z = _project(np.asarray(vertices, np.float64), c2w_gl,
                       np.asarray(K, np.float64))
    tu, tv, tz = u[faces], v[faces], z[faces]             # (F, 3)

    in_front = np.all(tz > near, axis=1) & np.all(tz < far, axis=1)
    xmin = np.floor(tu.min(1)).astype(np.int64)
    ymin = np.floor(tv.min(1)).astype(np.int64)
    xmax = np.ceil(tu.max(1)).astype(np.int64)
    ymax = np.ceil(tv.max(1)).astype(np.int64)
    onscreen = (xmax >= 0) & (ymax >= 0) & (xmin < W) & (ymin < H) & in_front

    small = onscreen & (xmax - xmin < _BLOCK) & (ymax - ymin < _BLOCK)
    depth = np.full((H * W,), np.inf, np.float64)

    def _raster_batch(sel_idx, bw, bh):
        """Rasterize faces sel_idx over a bw×bh window anchored at bbox min."""
        if len(sel_idx) == 0:
            return
        su, sv, sz = tu[sel_idx], tv[sel_idx], tz[sel_idx]     # (S, 3)
        x0 = np.floor(su.min(1)).astype(np.int64)
        y0 = np.floor(sv.min(1)).astype(np.int64)
        gx, gy = np.meshgrid(np.arange(bw), np.arange(bh), indexing="xy")
        px = x0[:, None] + gx.ravel()[None, :] + 0.5            # (S, P)
        py = y0[:, None] + gy.ravel()[None, :] + 0.5
        # barycentric coords wrt (A, B, C)
        ax, ay = su[:, 0:1], sv[:, 0:1]
        v0x, v0y = su[:, 1:2] - ax, sv[:, 1:2] - ay
        v1x, v1y = su[:, 2:3] - ax, sv[:, 2:3] - ay
        v2x, v2y = px - ax, py - ay
        den = v0x * v1y - v1x * v0y
        den = np.where(np.abs(den) < 1e-12, 1e-12, den)
        b1 = (v2x * v1y - v1x * v2y) / den
        b2 = (v0x * v2y - v2x * v0y) / den
        b0 = 1.0 - b1 - b2
        cover = (b0 >= -1e-9) & (b1 >= -1e-9) & (b2 >= -1e-9)
        # perspective-correct depth via 1/z interpolation
        iz = b0 / sz[:, 0:1] + b1 / sz[:, 1:2] + b2 / sz[:, 2:3]
        zpix = 1.0 / np.maximum(iz, 1e-12)
        inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & cover
        flat = (py.astype(np.int64) * W + px.astype(np.int64))[inb]
        np.minimum.at(depth, flat, zpix[inb])

    _raster_batch(np.nonzero(small)[0], _BLOCK, _BLOCK)

    big = np.nonzero(onscreen & ~small)[0]
    for f in big:   # rare path: triangles wider than the block
        bw = int(min(xmax[f], W - 1) - max(xmin[f], 0) + 2)
        bh = int(min(ymax[f], H - 1) - max(ymin[f], 0) + 2)
        if bw <= 0 or bh <= 0:
            continue
        _raster_batch(np.array([f]), bw, bh)

    depth = depth.reshape(H, W)
    return np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)


def render_mesh_view(vertices: np.ndarray, faces: np.ndarray,
                     c2w_gl: np.ndarray, K: np.ndarray, H: int, W: int,
                     vertex_colors: np.ndarray | None = None,
                     bg_color=1.0, shaded: bool = True,
                     near: float = 0.01, far: float = 10.0):
    """Shaded color render of a mesh — replaces Open3D offscreen visualization
    (reference: tools/vis.py render_mesh_from_view / morpheus.py
    render_all_meshes). Returns (rgb (H,W,3) float, depth (H,W)).

    Depth pass via render_depth_map; the color pass splats per-face flat
    attributes (mean vertex color × Lambert term on the face normal) for
    pixels that won the z-test — exact enough for diagnostics videos given
    screen-space-small triangles.
    """
    depth = render_depth_map(vertices, faces, c2w_gl, K, H, W, near, far)
    rgb = np.full((H, W, 3), bg_color, np.float32)
    if len(faces) == 0:
        return rgb, depth

    u, v, z = _project(np.asarray(vertices, np.float64), c2w_gl,
                       np.asarray(K, np.float64))
    tu, tv, tz = u[faces], v[faces], z[faces]

    # per-face color: flat vertex-color mean × headlight Lambert shading
    if vertex_colors is None:
        base = np.full((len(faces), 3), 0.7, np.float32)
    else:
        base = vertex_colors[faces].mean(1).astype(np.float32)
    if shaded:
        tri = np.asarray(vertices, np.float64)[faces]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
        view = c2w_gl[:3, 2]   # headlight along the optical axis
        lam = np.abs(n @ view)
        base = base * (0.35 + 0.65 * lam[:, None])

    in_front = np.all(tz > near, axis=1) & np.all(tz < far, axis=1)
    xmin = np.floor(tu.min(1)).astype(np.int64)
    ymin = np.floor(tv.min(1)).astype(np.int64)
    xmax = np.ceil(tu.max(1)).astype(np.int64)
    ymax = np.ceil(tv.max(1)).astype(np.int64)
    onscreen = (xmax >= 0) & (ymax >= 0) & (xmin < W) & (ymin < H) & in_front
    small = onscreen & (xmax - xmin < _BLOCK) & (ymax - ymin < _BLOCK)

    sel = np.nonzero(small)[0]
    if len(sel):
        su, sv_, sz = tu[sel], tv[sel], tz[sel]
        x0 = np.floor(su.min(1)).astype(np.int64)
        y0 = np.floor(sv_.min(1)).astype(np.int64)
        gx, gy = np.meshgrid(np.arange(_BLOCK), np.arange(_BLOCK),
                             indexing="xy")
        px = x0[:, None] + gx.ravel()[None, :] + 0.5
        py = y0[:, None] + gy.ravel()[None, :] + 0.5
        ax, ay = su[:, 0:1], sv_[:, 0:1]
        v0x, v0y = su[:, 1:2] - ax, sv_[:, 1:2] - ay
        v1x, v1y = su[:, 2:3] - ax, sv_[:, 2:3] - ay
        v2x, v2y = px - ax, py - ay
        den = v0x * v1y - v1x * v0y
        den = np.where(np.abs(den) < 1e-12, 1e-12, den)
        b1 = (v2x * v1y - v1x * v2y) / den
        b2 = (v0x * v2y - v2x * v0y) / den
        b0 = 1.0 - b1 - b2
        cover = (b0 >= -1e-9) & (b1 >= -1e-9) & (b2 >= -1e-9)
        iz = b0 / sz[:, 0:1] + b1 / sz[:, 1:2] + b2 / sz[:, 2:3]
        zpix = 1.0 / np.maximum(iz, 1e-12)
        inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & cover
        flat = (py.astype(np.int64) * W + px.astype(np.int64))
        won = inb & (zpix <= depth.reshape(-1)[np.clip(flat, 0, H * W - 1)]
                     + 1e-4)
        fidx, pidx = np.nonzero(won)
        rgb.reshape(-1, 3)[flat[fidx, pidx]] = base[sel[fidx]]
    return rgb, depth
