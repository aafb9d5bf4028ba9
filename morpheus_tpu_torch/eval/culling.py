"""Mesh culling + 3D reconstruction metrics + depth-L1, host code (the port's
copy of morpheus_tpu/eval/culling.py; reference: tools/culling.py — protocol
reproduced step by step so numbers are comparable with the paper:
subdivide→double-sided depth render→frustum/occlusion/missing-depth
culling→ICP align→50k-sample Acc/Comp/ratio)."""
from __future__ import annotations

import os
# imported at module scope, NOT inside eval_mesh_3d: that function runs on a
# background eval thread (morpheus.py epoch loop), and a first import of
# concurrent.futures during interpreter shutdown raises "can't register
# atexit after shutdown", silently dropping the epoch's 3-D metrics
# (observed live, round-3 full-budget run supervisor.log 14:21)
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy

import numpy as np
from scipy.spatial import cKDTree as KDTree

from ..ops import meshing
from .icp import icp_point_to_point
from .rasterizer import render_depth_map


def subdivide_to_size(vertices: np.ndarray, faces: np.ndarray,
                      max_edge: float = 0.01, max_iter: int = 10):
    """Midpoint-subdivide faces until every edge <= max_edge
    (trimesh.remesh.subdivide_to_size equivalent, tools/culling.py:95)."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    for _ in range(max_iter):
        tri = vertices[faces]
        edge_len = np.stack([
            np.linalg.norm(tri[:, 0] - tri[:, 1], axis=-1),
            np.linalg.norm(tri[:, 1] - tri[:, 2], axis=-1),
            np.linalg.norm(tri[:, 2] - tri[:, 0], axis=-1)], -1)
        too_big = edge_len.max(-1) > max_edge
        if not too_big.any():
            break
        keep = faces[~too_big]
        split = faces[too_big]
        # midpoints of all 3 edges (deduplicated)
        edges = np.concatenate([split[:, [0, 1]], split[:, [1, 2]],
                                split[:, [2, 0]]], 0)
        edges_sorted = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges_sorted, axis=0, return_inverse=True)
        mids = 0.5 * (vertices[uniq[:, 0]] + vertices[uniq[:, 1]])
        mid_idx = len(vertices) + np.arange(len(uniq))
        vertices = np.concatenate([vertices, mids], 0)
        n = len(split)
        m01 = mid_idx[inv[:n]]
        m12 = mid_idx[inv[n:2 * n]]
        m20 = mid_idx[inv[2 * n:]]
        new_faces = np.concatenate([
            np.stack([split[:, 0], m01, m20], -1),
            np.stack([m01, split[:, 1], m12], -1),
            np.stack([m20, m12, split[:, 2]], -1),
            np.stack([m01, m12, m20], -1)], 0)
        faces = np.concatenate([keep, new_faces], 0)
    return vertices, faces


def cull_from_one_pose(points, pose, K, H, W, rendered_depth, eps=0.005,
                       depth_gt=None, remove_missing_depth=True):
    """Frustum / occlusion / missing-depth vertex masks
    (tools/culling.py:17-49)."""
    c2w = deepcopy(np.asarray(pose, np.float64))
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    uvz = cam @ np.asarray(K, np.float64).T
    pz = uvz[:, 2] + 1e-8
    px = uvz[:, 0] / pz
    py = uvz[:, 1] / pz

    in_frustum = (0 <= px) & (px <= W - 1) & (0 <= py) & (py <= H - 1) & (pz > 0)
    u = np.clip(px, 0, W - 1).astype(np.int32)
    v = np.clip(py, 0, H - 1).astype(np.int32)
    obs_mask = in_frustum & (pz < (rendered_depth[v, u] + eps))
    if remove_missing_depth:
        invalid_mask = in_frustum & (depth_gt[v, u] <= 0.0)
    else:
        invalid_mask = np.zeros_like(in_frustum)
    return obs_mask, invalid_mask


def cull_one_mesh(K, H, W, mesh_path, save_path, c2w, depth_gt,
                  remove_missing_depth=True, eps=0.005, subdivide=True,
                  max_edge=0.01):
    """Cull a reconstructed mesh to what the camera could observe
    (tools/culling.py:86-131)."""
    vertices, faces, colors = meshing.load_ply(mesh_path)
    if subdivide and len(faces):
        vertices, faces = subdivide_to_size(vertices, faces, max_edge=max_edge)
        colors = None  # subdivision invalidates per-vertex colors

    rendered = render_depth_map(vertices, faces, np.asarray(c2w, np.float64),
                                K, H, W, far=10.0)
    obs_mask, invalid_mask = cull_from_one_pose(
        np.asarray(vertices, np.float64), c2w, K, H, W, rendered_depth=rendered,
        depth_gt=depth_gt, remove_missing_depth=remove_missing_depth, eps=eps)

    obs = obs_mask[faces[:, 0]] | obs_mask[faces[:, 1]] | obs_mask[faces[:, 2]]
    inv = (invalid_mask[faces[:, 0]] & invalid_mask[faces[:, 1]]
           & invalid_mask[faces[:, 2]])
    tri_keep = faces[obs & ~inv]
    meshing.save_ply(save_path, np.asarray(vertices, np.float32), tri_keep,
                     colors)
    return vertices, tri_keep


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                   rng=None) -> np.ndarray:
    """Area-weighted uniform surface sampling
    (trimesh.sample.sample_surface equivalent, tools/culling.py:201-205)."""
    rng = np.random.default_rng(0) if rng is None else rng
    tri = vertices[faces]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    if areas.sum() <= 0 or len(faces) == 0:
        return vertices[rng.integers(0, max(len(vertices), 1), n)] \
            if len(vertices) else np.zeros((0, 3))
    probs = areas / areas.sum()
    fi = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=n))[:, None]
    r2 = rng.uniform(size=n)[:, None]
    a, b, c = tri[fi, 0], tri[fi, 1], tri[fi, 2]
    return (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c


def accuracy(gt_points, rec_points):
    d, _ = KDTree(gt_points).query(rec_points)
    return np.mean(d)


def completion(gt_points, rec_points):
    d, _ = KDTree(rec_points).query(gt_points)
    return np.mean(d)


def completion_ratio(gt_points, rec_points, dist_th=0.05):
    d, _ = KDTree(rec_points).query(gt_points)
    return np.mean((d < dist_th).astype(np.float32))


def f_score(gt_points, rec_points, dist_th=0.05):
    """Harmonic mean of precision (rec within th of gt) and recall."""
    d_rec, _ = KDTree(gt_points).query(rec_points)
    d_gt, _ = KDTree(rec_points).query(gt_points)
    precision = np.mean(d_rec < dist_th)
    recall = np.mean(d_gt < dist_th)
    return 2 * precision * recall / max(precision + recall, 1e-8)


def calc_3d_metric(rec_meshfile, gt_meshfile, align=True, num_points=50000):
    """Acc/Comp (cm) + completion ratio (%) + F-score
    (tools/culling.py:189-221)."""
    rv, rf, _ = meshing.load_ply(rec_meshfile)
    gv, gf, _ = meshing.load_ply(gt_meshfile)
    if align and len(rv) >= 3 and len(gv) >= 3:
        # estimate the alignment on <=100k vertices: the subdivided culled
        # mesh can carry millions, and ICP queries every source point against
        # the KD-tree each iteration — a 100k subsample gives a statistically
        # identical rigid fit at a fraction of the cost
        src = rv
        if len(src) > 100_000:
            sel = np.random.default_rng(0).choice(len(src), 100_000,
                                                  replace=False)
            src = src[sel]
        T = icp_point_to_point(src.astype(np.float64), gv.astype(np.float64),
                               threshold=0.1)
        rv = rv @ T[:3, :3].T + T[:3, 3]

    rec_pc = sample_surface(rv, rf, num_points)
    gt_pc = sample_surface(gv, gf, num_points)
    return {
        "acc": accuracy(gt_pc, rec_pc) * 100.0,
        "comp": completion(gt_pc, rec_pc) * 100.0,
        "comp ratio": completion_ratio(gt_pc, rec_pc) * 100.0,
        "f_score": f_score(gt_pc, rec_pc) * 100.0,
    }


def cull_meshes(mesh_dir, save_dir, dataset, target):
    os.makedirs(save_dir, exist_ok=True)
    K = np.asarray(dataset.intrinsics, np.float64)
    for i in range(dataset.num_frames):
        c2w = np.asarray(dataset.poses[i], np.float64)
        depth_gt = dataset.depths[i]
        mesh_path = os.path.join(mesh_dir, f"{target}_{i:04d}.ply")
        save_path = os.path.join(save_dir, f"{target}_{i:04d}.ply")
        cull_one_mesh(K, dataset.H, dataset.W, mesh_path, save_path, c2w,
                      depth_gt=depth_gt, eps=0.005)


def _metric_many_main():
    """Subprocess entry: compute Acc/Comp for a list of (rec, gt) mesh pairs
    (argv: rec0 gt0 rec1 gt1 ...) and print one tagged 'METRIC i acc comp'
    line per pair. One interpreter serves many frames (the round-1 version
    forked per frame — wasteful at 1000-frame scenes). Runs with
    CUDA_VISIBLE_DEVICES="" so workers never touch the trainer's card.
    Per-pair failures print 'FAILED i' and do not kill the worker."""
    import sys
    args = sys.argv[1:]
    for j in range(0, len(args), 2):
        i = j // 2
        try:
            r = calc_3d_metric(args[j], args[j + 1])
            print(f"METRIC {i} {r['acc']} {r['comp']}", flush=True)
        except Exception as e:  # noqa: BLE001 — worker must survive bad frames
            print(f"FAILED {i} {e!r}", flush=True)


def eval_mesh_3d(rec_files, gt_files, save_file, epoch, workers=None):
    """Per-frame metrics, parallel across CPU subprocesses (the ICP +
    50k-sample KDTree stage is minutes per frame; the reference hides the same
    cost in background threads, morpheus.py:1513-1516 — subprocesses actually
    use the cores and never touch the card). Frames are chunked
    round-robin over a fixed pool of interpreters; failed frames are dropped
    from the average instead of discarding the whole epoch's metrics."""
    import subprocess
    import sys

    n = len(rec_files)
    workers = workers or min(10, os.cpu_count() or 1, n)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))

    chunks = [list(range(w, n, workers)) for w in range(workers)]

    def run_chunk(idxs):
        if not idxs:
            return []
        argv = []
        for i in idxs:
            argv += [rec_files[i], gt_files[i]]
        out = subprocess.run(
            [sys.executable, "-c",
             "from morpheus_tpu_torch.eval.culling import _metric_many_main; "
             "_metric_many_main()"] + argv,
            env=env, capture_output=True, text=True,
            timeout=3600 * max(1, len(idxs)))
        res = []
        for line in out.stdout.splitlines():
            parts = line.split()
            if len(parts) == 4 and parts[0] == "METRIC":
                res.append((float(parts[2]), float(parts[3])))
            elif parts and parts[0] == "FAILED":
                print(f"[eval_mesh_3d] frame failed: {line}")
        if out.returncode != 0:
            # worker died — possibly mid-chunk, after emitting some METRIC
            # lines; report how many frames this chunk lost so a silently
            # smaller epoch average is visible in the log
            print(f"[eval_mesh_3d] worker died rc={out.returncode} "
                  f"({len(res)}/{len(idxs)} frames recovered): "
                  f"{out.stderr[-500:]}")
        return res

    with ThreadPoolExecutor(workers) as ex:
        res = [r for chunk in ex.map(run_chunk, chunks) for r in chunk]
    if not res:
        print(f"[eval_mesh_3d] no frames succeeded for epoch {epoch}")
        return None
    accs = [r[0] for r in res]
    comps = [r[1] for r in res]
    with open(save_file, "a") as f:
        print(f"Ep_{epoch}:\t Acc:{np.mean(accs)}\t Comp:{np.mean(comps)}",
              file=f)
    return float(np.mean(accs)), float(np.mean(comps))


def eval_mesh(workspace, mesh_dir, dataset, target, epoch):
    """Full per-frame cull + metric pipeline (tools/culling.py:262-275).
    Skips gracefully when GT backprojection meshes are absent (synthetic)."""
    gt_files = [os.path.join(getattr(dataset, "data_dir", dataset.cfg["data"]["data_dir"]),
                             f"mesh/backproj_{i}.ply")
                for i in range(dataset.num_frames)]
    if not all(os.path.exists(g) for g in gt_files):
        print(f"[eval_mesh] GT backprojection meshes missing; skipping 3D "
              f"metrics for epoch {epoch}")
        return None

    cull_dir = os.path.join(workspace, "mesh_all_culled")
    cull_meshes(mesh_dir, cull_dir, dataset, target)
    rec_files = [os.path.join(cull_dir, f"{target}_{i:04d}.ply")
                 for i in range(dataset.num_frames)]
    result = eval_mesh_3d(rec_files, gt_files,
                          os.path.join(workspace, "metric_3d.txt"), epoch)
    for f in rec_files:
        try:
            os.remove(f)
        except OSError:
            pass
    return result


def eval_depthL1(depth_dir, dataset, epoch=None):
    """Masked depth L1 vs mesh-rendered depth + error heatmaps
    (tools/culling.py:237-260). The protocol files (shared depth_error dir,
    reference layout) are last-writer-wins across epochs; passing `epoch`
    additionally writes a per-epoch mean file so the metric series survives
    out-of-order backfill evals. The heatmaps are cv2's BGR colormap
    written as RGB, as the JAX copy writes them (through imageio); here cv2
    writes them, so the card's machine needs no imageio."""
    import cv2

    error_dir = os.path.join(os.path.dirname(depth_dir), "depth_error")
    os.makedirs(error_dir, exist_ok=True)
    preds = np.load(os.path.join(depth_dir, "depths.npz"))
    errors = []
    for i in range(dataset.num_frames):
        pred = preds[f"depth_{i}"]
        gt = np.asarray(dataset.depths[i])
        mask = np.asarray(dataset.masks[i]) > 0.0
        valid = (gt > 0.0) & mask
        err = np.abs(gt - pred)
        err[~valid] = 0.0
        err[err > 1.0] = 0.0
        errors.append(err[err > 0.0].mean() if (err > 0).any() else 0.0)
        plot = 255.0 - np.clip(err / max(err.max(), 1e-8), 0, 1) * 255.0
        cmap = cv2.applyColorMap(np.uint8(plot), cv2.COLORMAP_JET)
        cv2.imwrite(os.path.join(error_dir, f"{i:04d}.png"), cmap[..., ::-1])
    errors = np.array(errors)
    np.savetxt(os.path.join(error_dir, "depthL1_scores.txt"), errors,
               fmt="%.5f")
    np.savetxt(os.path.join(error_dir, "depthL1_score_mean.txt"),
               np.array([errors.mean()]), fmt="%.5f")
    if epoch is not None:
        np.savetxt(os.path.join(error_dir,
                                f"depthL1_score_mean_{epoch:04d}.txt"),
                   np.array([errors.mean()]), fmt="%.5f")
    return errors
