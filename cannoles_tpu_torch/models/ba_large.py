"""Large single-scene bundle adjustment with a full (or masked) visibility
grid.

Port of ``cannoles_tpu/models/ba_large.py``; ``core/ba.py``'s
``SchurBASolver`` and ``ba_block_jacobi`` solve these scenes.  Layout
``x = [cams (C, 6).ravel(); pts (P, 3).ravel()]``, pose = (angle-axis w,
translation t), pinhole projection u = f·(R(X − t))_{xy}/z.  The scene, the
visibility mask, the gauge constants and x0 are drawn with numpy in the JAX
builder's order from the same seed; the observations are projected in
float64 numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..problem import NLSProblem, default_device, nls_problem

__all__ = ["rotate", "project_point", "large_bundle_adjustment"]


def rotate(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """R(w) X for angle-axis ``w`` (..., 3) and points ``X`` (..., 3), both
    of X's shape: the small-angle-safe Rodrigues formula of the JAX
    ``project_point`` (X + w × X below θ² = 1e-12)."""
    theta2 = (w * w).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-30)
    k = w / theta
    c, s = torch.cos(theta), torch.sin(theta)
    k, w = k.expand(X.shape), w.expand(X.shape)
    kxX = torch.linalg.cross(k, X, dim=-1)
    Xc_full = c * X + s * kxX + (1 - c) * (k * X).sum(-1, keepdim=True) * k
    return torch.where(theta2 < 1e-12, X + torch.linalg.cross(w, X, dim=-1), Xc_full)


def project_point(cam: torch.Tensor, pt: torch.Tensor, focal: float = 1.0) -> torch.Tensor:
    """Pinhole projection of landmarks through cameras, broadcast over the
    leading axes: ``cam`` (..., 6), ``pt`` (..., 3) → (..., 2) normalized
    image coordinates.  Small-angle-safe Rodrigues rotation, the formula of
    the JAX ``project_point``."""
    w, t = cam[..., :3], cam[..., 3:]
    X = pt - t
    Xc = rotate(w, X)
    z = torch.clamp(Xc[..., 2:], min=1e-3)
    return focal * Xc[..., :2] / z


def _np_project_grid(cams: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(C, P, 2) projections of every landmark through every camera, float64."""
    w, t = cams[:, None, :3], cams[:, None, 3:]
    X = pts[None, :, :] - t
    theta2 = (w * w).sum(-1, keepdims=True)
    theta = np.sqrt(theta2 + 1e-30)
    k = np.broadcast_to(w / theta, X.shape)
    Xc_full = np.cos(theta) * X + np.sin(theta) * np.cross(k, X) + (
        (1 - np.cos(theta)) * (k * X).sum(-1, keepdims=True) * k
    )
    Xc = np.where(theta2 < 1e-12, X + np.cross(np.broadcast_to(w, X.shape), X), Xc_full)
    return Xc[..., :2] / np.maximum(Xc[..., 2:], 1e-3)


def large_bundle_adjustment(
    n_cams: int = 100,
    n_pts: int = 10_000,
    noise: float = 0.0,
    seed: int = 0,
    gauge: str = "constraints",
    visibility: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[NLSProblem, np.ndarray]:
    """Synthesize one consistent large scene; returns (problem, x_true).

    ``data = {"obs": (C, P, 2), "pose0": (6,), "base2": (1,)}``, plus
    ``"vis"`` (C, P) below full ``visibility`` (every landmark seen by ≥ 2
    cameras, every camera sees ≥ 6 landmarks; the residual is
    vis ⊙ (proj − obs)) and ``"gidx"``/``"gvals"`` with ``gauge='fixed'``.

    ``gauge``: ``"constraints"`` pins pose 0 and the squared baseline with 7
    equality constraints; ``"fixed"`` freezes pose 0's six coordinates and
    camera 1's x translation inside the residual, unconstrained.

    ``device`` defaults to the card; ``"cpu"`` builds on the CPU."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    C, P = n_cams, n_pts
    angles = np.linspace(-0.4, 0.4, C)
    t_true = np.stack([5.0 * np.sin(angles), 0.3 * rng.normal(size=C), -7.0 + np.cos(angles)], axis=1)
    w_true = np.stack([0.05 * rng.normal(size=C), angles * 0.5, 0.02 * rng.normal(size=C)], axis=1)
    X_true = rng.uniform(-2.5, 2.5, size=(P, 3))
    X_true[:, 2] += 1.0
    cams_true = np.concatenate([w_true, t_true], axis=1)
    x_true = np.concatenate([cams_true.reshape(-1), X_true.reshape(-1)])

    obs = _np_project_grid(cams_true, X_true)
    obs = obs + noise * rng.normal(size=obs.shape)

    vis = None
    if visibility < 1.0:
        vis = (rng.random((C, P)) < visibility).astype(np.float64)
        for p_idx in np.nonzero(vis.sum(axis=0) < 2)[0]:
            vis[rng.choice(C, size=2, replace=False), p_idx] = 1.0
        for c_idx in np.nonzero(vis.sum(axis=1) < 6)[0]:
            vis[c_idx, rng.choice(P, size=6, replace=False)] = 1.0

    base2 = float(np.sum((t_true[1] - t_true[0]) ** 2))
    pose0 = cams_true[0].copy()
    gauge_idx = np.concatenate([np.arange(6), [9]])
    gauge_vals = x_true[gauge_idx].copy()
    masked = vis is not None

    def _err(x, d):
        cams = x[: 6 * C].reshape(C, 1, 6)
        pts = x[6 * C:].reshape(1, P, 3)
        e = project_point(cams, pts) - d["obs"]
        if masked:
            e = e * d["vis"][..., None]
        return e.reshape(-1)

    if gauge == "fixed":

        def residual(x, d):
            return _err(x.scatter(0, d["gidx"].long(), d["gvals"]), d)

        cons = None
    else:
        residual = _err

        def cons(x, d):
            c_pin = x[:6] - d["pose0"]
            c_scale = ((x[9:12] - x[3:6]) ** 2).sum().reshape(1) - d["base2"]
            return torch.cat([c_pin, c_scale])

    x0 = x_true + 0.01 * rng.normal(size=x_true.shape)
    x0[:6] = pose0
    if gauge == "fixed":
        x0[gauge_idx] = gauge_vals

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    data = {"obs": t(obs), "pose0": t(pose0), "base2": t([base2])}
    if masked:
        data["vis"] = t(vis)
    if gauge == "fixed":
        data["gidx"] = torch.as_tensor(gauge_idx, dtype=torch.int64, device=device)
        data["gvals"] = t(gauge_vals)
    pb = nls_problem(
        residual,
        t(x0),
        2 * C * P,
        cons,
        None if cons is None else np.zeros(7),
        None if cons is None else np.zeros(7),
        data=data,
        name=f"ba_large_{C}c{P}p_{gauge}" + (f"_vis{visibility:g}" if masked else ""),
        device=device,
    )
    return pb, x_true
