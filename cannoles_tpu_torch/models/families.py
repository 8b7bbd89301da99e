"""Problem families of the port's paths.

Port of ``cannoles_tpu/models/families.py`` (``curve_fit_family``,
``bundle_adjustment`` and ``bundle_adjustment_batch``) plus two problems
of ``bench.py``: the bench
family with its batch draw, and the large rung's dense problem.
Observations, starts and gauge constants come from the same numpy code and
seeds as in the JAX package, so both packages get identical data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..problem import NLSProblem, default_device, nls_problem

__all__ = [
    "curve_fit_family",
    "bundle_adjustment",
    "bundle_adjustment_batch",
    "lm_bench_family",
    "lm_bench_batch",
    "large_rung_problem",
]


def curve_fit_family(m: int = 1024, dtype: torch.dtype = torch.float32, device=None) -> NLSProblem:
    """y(t) = a1·exp(-b1 t) + a2·exp(-b2 t) + c: 5 parameters, m rows.

    ``data = {"t": (m,), "y": (m,)}``; build batches by stacking data
    leaves.  ``device`` defaults to the card; ``"cpu"`` builds on the CPU."""
    device = default_device(device)
    t = torch.as_tensor(np.linspace(0.0, 4.0, m), dtype=dtype, device=device)

    def model(x, t):
        return x[0] * torch.exp(-x[1] * t) + x[2] * torch.exp(-x[3] * t) + x[4]

    def residual(x, d):
        return model(x, d["t"]) - d["y"]

    true = torch.tensor([2.0, 1.5, 1.0, 0.4, 0.5], dtype=dtype, device=device)
    data = {"t": t, "y": model(true, t)}
    x0 = torch.tensor([1.0, 1.0, 0.5, 0.1, 0.0], dtype=dtype, device=device)
    return nls_problem(residual, x0, m, data=data, name=f"curvefit_{m}", device=device)


def lm_bench_family(dtype: torch.dtype, device=None) -> NLSProblem:
    """The bench family (port of ``bench.py:build_problem``): a Rosenbrock
    residual with one linear constraint, data d = (d0, d1, d2):
    F = (x0 - d0, 10(x1 - x0²) - d1), c = x0 + x1 - d2.  N = n+m+p = 5.
    ``device`` defaults to the card; ``"cpu"`` builds on the CPU."""
    device = default_device(device)

    def residual(x, d):
        return torch.stack([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]])

    def cons(x, d):
        return torch.stack([x[0] + x[1] - d[2]])

    return nls_problem(
        residual,
        torch.tensor([-1.2, 1.0], dtype=dtype, device=device),
        2,
        cons,
        [0.0],
        [0.0],
        data=torch.zeros((3,), dtype=dtype, device=device),
        name="bench_lm_family",
        device=device,
    )


def lm_bench_batch(B: int, seed: int = 0):
    """Starts and data of the bench family, drawn as ``bench.py`` draws them
    (``:142-150``): x0 (B, 2) and d (B, 3), float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(scale=0.5, size=(B, 2)) + [-1.2, 1.0]
    d = np.stack(
        [1 + 0.2 * rng.normal(size=B), 0.1 * rng.normal(size=B), 1 + 0.2 * rng.normal(size=B)],
        axis=1,
    )
    return x0, d


def large_rung_problem(
    m: int = 8192, n: int = 1024, seed: int = 0, dtype: torch.dtype = torch.float32, device=None
):
    """The large rung's problem (port of ``bench.py:run_large_rung``,
    ``:281-296``): F(x) = B1 x + 0.1 sin(B2 x) − y with y = B1 x_true +
    0.1 sin(B2 x_true), x0 = 0, unconstrained.  B1, B2 and x_true are drawn
    as bench.py draws them (``default_rng(seed)``, float32 draws, B/√n); y is
    computed in ``dtype`` on ``device`` (default: the card; ``"cpu"`` to
    build on the CPU).

    Returns ``(problem, x_true, data)``: ``data`` holds the numpy B1, B2
    (float64 arrays of float32 draws scaled by 1/√n, as bench.py hands them
    to JAX) and x_true is the float32 draw."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    B1 = rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n)
    B2 = rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n)
    x_true = rng.normal(size=n).astype(np.float32)

    def model(x, d):
        return d["B1"] @ x + 0.1 * torch.sin(d["B2"] @ x)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    data = {"B1": t(B1), "B2": t(B2)}
    data["y"] = model(t(x_true), data)
    pb = nls_problem(
        lambda x, d: model(x, d) - d["y"],
        torch.zeros(n, dtype=dtype, device=device),
        m,
        data=data,
        name=f"bench_large_{m}x{n}",
        device=device,
    )
    return pb, x_true, {"B1": B1, "B2": B2}


def _rodrigues(w, X):
    """Rotate points X (..., 3) by angle-axis w (3,), small-angle safe."""
    theta2 = (w * w).sum()
    theta = torch.sqrt(theta2 + 1e-30)
    k = w / theta
    c, s = torch.cos(theta), torch.sin(theta)
    kxX = torch.linalg.cross(k.expand(X.shape), X, dim=-1)
    kdX = (X @ k)[..., None]
    R = c * X + s * kxX + (1 - c) * kdX * k
    small = theta2 < 1e-12
    return torch.where(small, X + torch.linalg.cross(w.expand(X.shape), X, dim=-1), R)


def bundle_adjustment(
    n_cams: int = 4,
    n_pts: int = 32,
    noise: float = 0.0,
    seed: int = 0,
    focal: float = 1.0,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Tuple[NLSProblem, np.ndarray]:
    """Synthesize a consistent planar-pinhole BA scene; returns
    (problem, x_true).  Parameters ``[poses (n_cams, 6); points (n_pts, 3)]``
    with pose = (angle-axis w, translation t), u = f·(R(X−t))_{xy}/z; the
    gauge is fixed by 7 equality constraints (pose 0 pinned, ‖t₁−t₀‖² fixed).
    ``device`` defaults to the card; ``"cpu"`` builds on the CPU."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    angles = np.linspace(-0.3, 0.3, n_cams)
    t_true = np.stack([4.0 * np.sin(angles), 0.3 * rng.normal(size=n_cams), -6.0 + np.cos(angles)], axis=1)
    w_true = np.stack([0.05 * rng.normal(size=n_cams), angles * 0.5, 0.02 * rng.normal(size=n_cams)], axis=1)
    X_true = rng.uniform(-2.0, 2.0, size=(n_pts, 3))
    X_true[:, 2] += 1.0

    cams_true = np.concatenate([w_true, t_true], axis=1)
    x_true = np.concatenate([cams_true.reshape(-1), X_true.reshape(-1)])

    def project_all(x):
        cams = x[: 6 * n_cams].reshape(n_cams, 6)
        pts = x[6 * n_cams:].reshape(n_pts, 3)
        w = cams[:, :3]
        t = cams[:, 3:]
        rel = pts[None, :, :] - t[:, None, :]
        Xc = torch.stack([_rodrigues(w[i], rel[i]) for i in range(n_cams)])
        z = torch.clamp(Xc[..., 2], min=1e-3)
        uv = focal * Xc[..., :2] / z[..., None]
        return uv.reshape(-1)

    def _np_project(cams, pts):
        uv = np.empty((n_cams, n_pts, 2))
        for i in range(n_cams):
            w, t = cams[i, :3], cams[i, 3:]
            th = np.sqrt((w**2).sum()) + 1e-30
            k = w / th
            X = pts - t
            c, s_ = np.cos(th), np.sin(th)
            Xc = c * X + s_ * np.cross(np.broadcast_to(k, X.shape), X) + (
                (1 - c) * (X @ k)[:, None] * k
            )
            uv[i] = focal * Xc[:, :2] / np.maximum(Xc[:, 2], 1e-3)[:, None]
        return uv.reshape(-1)

    obs = _np_project(cams_true, X_true)
    obs = obs + noise * rng.normal(size=obs.shape)

    def residual(x, d):
        return project_all(x) - d["obs"]

    base2 = float(np.sum((t_true[1] - t_true[0]) ** 2))
    pose0 = cams_true[0].copy()

    def cons(x, d):
        c_pin = x[:6] - d["pose0"]
        c_scale = ((x[9:12] - x[3:6]) ** 2).sum().reshape(1) - d["base2"]
        return torch.cat([c_pin, c_scale])

    x0 = x_true + 0.02 * rng.normal(size=x_true.shape)
    x0[:6] = pose0
    m = 2 * n_cams * n_pts

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pb = nls_problem(
        residual,
        t(x0),
        m,
        cons,
        np.zeros(7),
        np.zeros(7),
        data={"obs": t(obs), "pose0": t(pose0), "base2": t([base2])},
        name=f"bundle_adjustment_{n_cams}c{n_pts}p",
        device=device,
    )
    return pb, x_true


def bundle_adjustment_batch(
    n_scenes: int,
    n_cams: int = 4,
    n_pts: int = 32,
    noise: float = 0.0,
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
):
    """``n_scenes`` independent BA instances of one family: returns
    (problem, x0_batch (B, n), data_batch (leaves (B, ...)), x_true_batch).
    ``device`` defaults to the card; ``"cpu"`` builds on the CPU."""
    device = default_device(device)
    pb0, x0s, datas, trues = None, [], [], []
    for i in range(n_scenes):
        pb, xt = bundle_adjustment(n_cams, n_pts, noise=noise, seed=seed + i, dtype=dtype, device=device)
        if pb0 is None:
            pb0 = pb
        x0s.append(pb.x0)
        datas.append(pb.data)
        trues.append(xt)
    data_batch = {k: torch.stack([d[k] for d in datas]) for k in datas[0]}
    return pb0, torch.stack(x0s), data_batch, np.stack(trues)
