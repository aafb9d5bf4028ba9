"""Point-cloud registration: point-to-point ICP (replaces Open3D
registration_icp, tools/culling.py:148-166) and Welsch-robust IRLS ICP
(replaces the external Fast-Robust-ICP binary used for pose init,
preprocess/pose_init/registrate.py:138-144)."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree as KDTree


def _kabsch(src: np.ndarray, dst: np.ndarray, weights: np.ndarray | None = None):
    """Weighted least-squares rigid transform src→dst."""
    if weights is None:
        weights = np.ones(len(src))
    w = weights / (weights.sum() + 1e-12)
    mu_s = (src * w[:, None]).sum(0)
    mu_d = (dst * w[:, None]).sum(0)
    S = (src - mu_s).T @ ((dst - mu_d) * w[:, None])
    U, _, Vt = np.linalg.svd(S)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


def icp_point_to_point(src: np.ndarray, dst: np.ndarray,
                       threshold: float = 0.1, max_iter: int = 30,
                       init: np.ndarray | None = None) -> np.ndarray:
    """Vanilla point-to-point ICP; correspondences within `threshold` only —
    Open3D registration_icp semantics (tools/culling.py:156-165).
    Returns a 4x4 transform mapping src into dst's frame."""
    T = np.eye(4) if init is None else init.copy()
    tree = KDTree(dst)
    cur = src @ T[:3, :3].T + T[:3, 3]
    prev_err = np.inf
    for _ in range(max_iter):
        dist, idx = tree.query(cur)
        m = dist < threshold
        if m.sum() < 3:
            break
        R, t = _kabsch(cur[m], dst[idx[m]])
        cur = cur @ R.T + t
        Tn = np.eye(4)
        Tn[:3, :3], Tn[:3, 3] = R, t
        T = Tn @ T
        err = dist[m].mean()
        if abs(prev_err - err) < 1e-7:
            break
        prev_err = err
    return T


def robust_icp(src: np.ndarray, dst: np.ndarray, max_iter: int = 50,
               nu_factor: float = 3.0, init: np.ndarray | None = None
               ) -> np.ndarray:
    """Welsch-IRLS robust ICP — the FRICP replacement for pose init
    (robust to partial overlap/outliers). Welsch weight w = exp(-r²/ν²),
    ν annealed from a large multiple of the median residual down to the
    median residual (graduated non-convexity, like Fast-Robust-ICP)."""
    T = np.eye(4) if init is None else init.copy()
    tree = KDTree(dst)
    cur = src @ T[:3, :3].T + T[:3, 3]
    dist, _ = tree.query(cur)
    nu_end = max(np.median(dist), 1e-6)
    nu = nu_factor * max(dist.max(), 1e-6)
    for it in range(max_iter):
        dist, idx = tree.query(cur)
        w = np.exp(-(dist ** 2) / max(nu ** 2, 1e-12))
        R, t = _kabsch(cur, dst[idx], weights=w)
        cur = cur @ R.T + t
        Tn = np.eye(4)
        Tn[:3, :3], Tn[:3, 3] = R, t
        T = Tn @ T
        nu = max(nu * 0.9, nu_end)
    return T
