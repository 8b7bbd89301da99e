"""Bundle adjustment in the large (BAL): Snavely's 9-parameter camera on an
observation list.

The problems of Agarwal, Snavely, Seitz and Szeliski, *Bundle Adjustment in
the Large* (ECCV 2010).  Layout ``x = [cams (C, 9).ravel(); pts (P, 3).ravel()]``;
a camera is (w (3), t (3), f, k1, k2): Rodrigues rotation w, translation t,
focal length f and radial distortion k1, k2 (the BAL page's model, Ceres'
``SnavelyReprojectionError``):

    P = R(w)·X + t,   p = −P_xy / P_z,   u = f·(1 + k1‖p‖² + k2‖p‖⁴)·p,

and the residual of observation k is ``u(cam[cam_idx[k]], pt[pt_idx[k]]) −
obs[k]``, in pixels, raveled to (2·n_obs,).  Each camera sees each point at
most once.  ``core/ba.py``'s ``SchurBASolver`` solves these problems on the
observation list, with no (C, P) grid.

The gauge (a similarity: rotation, translation, scale) is fixed by 7
equality constraints on the camera block, as ``large_bundle_adjustment``
fixes it: camera 0's w and t pinned (6), and the squared distance between
the centres c = −R(w)ᵀt of cameras 0 and 1 (1).

* :func:`bal_problem`: the problem of given cameras, points and
  observations (x0 is the given cameras and points).
* :func:`bal_scene`: a consistent synthetic scene drawn from a seed at
  exactly the given counts, with pixel noise and a perturbed start.
* :func:`read_bal` / :func:`write_bal`: the BAL text format (``.bz2`` read
  and written through the standard library), so that a published problem
  file runs unchanged.
"""

from __future__ import annotations

import bz2
import math
from typing import Tuple

import numpy as np
import torch

from ..problem import NLSProblem, default_device, nls_problem
from .ba_large import rotate

__all__ = ["snavely_project", "camera_centre", "bal_problem", "bal_scene", "draw_scene", "perturb", "read_bal",
           "write_bal"]

CAM = 9  # parameters a camera


def snavely_project(cam: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """Snavely's projection, broadcast over the leading axes: ``cam``
    (..., 9), ``pt`` (..., 3) → (..., 2) pixels (the module docstring's
    equations; small-angle-safe rotation as ``project_point``'s)."""
    shape = torch.broadcast_shapes(cam.shape[:-1], pt.shape[:-1]) + (3,)
    P = rotate(cam[..., :3].expand(shape), pt.expand(shape)) + cam[..., 3:6]
    p = -P[..., :2] / P[..., 2:]
    r2 = (p * p).sum(-1, keepdim=True)
    f, k1, k2 = cam[..., 6:7], cam[..., 7:8], cam[..., 8:9]
    return f * (1 + k1 * r2 + k2 * r2 * r2) * p


def camera_centre(cam: torch.Tensor) -> torch.Tensor:
    """c = −R(w)ᵀt of cameras (..., ≥ 6), (..., 3)."""
    return -rotate(-cam[..., :3], cam[..., 3:6])


def bal_problem(
    cams,
    pts,
    cam_idx,
    pt_idx,
    obs,
    *,
    pose0=None,
    base2=None,
    dtype: torch.dtype = torch.float32,
    device=None,
    name: str = "bal",
) -> NLSProblem:
    """The BAL problem of cameras ``cams`` (C, 9), points ``pts`` (P, 3) and
    observations (``cam_idx``, ``pt_idx``, ``obs`` (n_obs, 2)), started at
    the given cameras and points, with the 7 gauge constraints.

    ``data = {"cam_idx", "pt_idx" (n_obs,) int64, "obs" (n_obs, 2), "pose0"
    (6,), "base2" (1,)}``: ``pose0`` (camera 0's w and t) and ``base2`` (the
    squared distance of the centres of cameras 0 and 1) default to the
    start's.  ``device`` defaults to the card; ``"cpu"`` builds on the CPU."""
    device = default_device(device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a).to(dtype=dt, device=device)

    cams, pts = t(cams), t(pts)
    C, P = cams.shape[0], pts.shape[0]
    if cams.shape != (C, CAM) or pts.shape != (P, 3) or C < 2:
        raise ValueError(f"cams must be (C >= 2, 9) and pts (P, 3); got {tuple(cams.shape)}, {tuple(pts.shape)}")
    cam_idx, pt_idx, obs = t(cam_idx, torch.int64), t(pt_idx, torch.int64), t(obs)
    n_obs = cam_idx.shape[0]
    if pt_idx.shape != (n_obs,) or obs.shape != (n_obs, 2):
        raise ValueError("cam_idx, pt_idx (n_obs,) and obs (n_obs, 2) must agree")
    if n_obs and (int(cam_idx.min()) < 0 or int(cam_idx.max()) >= C or int(pt_idx.min()) < 0
                  or int(pt_idx.max()) >= P):
        raise ValueError("an observation indexes a camera or point that does not exist")
    if pose0 is None:
        pose0 = cams[0, :6]
    if base2 is None:
        base2 = ((camera_centre(cams[1]) - camera_centre(cams[0])) ** 2).sum().reshape(1)

    def residual(x, d):
        cam = x[: CAM * C].reshape(C, CAM)
        pt = x[CAM * C:].reshape(P, 3)
        return (snavely_project(cam[d["cam_idx"]], pt[d["pt_idx"]]) - d["obs"]).reshape(-1)

    def cons(x, d):
        c01 = camera_centre(x[: 2 * CAM].reshape(2, CAM))
        c_scale = ((c01[1] - c01[0]) ** 2).sum().reshape(1) - d["base2"]
        return torch.cat([x[:6] - d["pose0"], c_scale])

    data = {"cam_idx": cam_idx, "pt_idx": pt_idx, "obs": obs, "pose0": t(pose0).reshape(6),
            "base2": t(base2).reshape(1)}
    return nls_problem(residual, torch.cat([cams.reshape(-1), pts.reshape(-1)]), 2 * n_obs, cons,
                       np.zeros(7), np.zeros(7), data=data, name=name, device=device)


# the scene's geometry: cameras on a ring of radius RING, points in a disk of
# radius DISK and height ±HEIGHT; a track's cameras among the WINDOW nearest
RING, DISK, HEIGHT, WINDOW = 10.0, 4.0, 1.0, 48


def draw_scene(n_cams: int, n_pts: int, n_obs: int, seed: int = 0) -> dict:
    """A consistent scene at exactly the given counts, drawn in float64 on
    the CPU from ``seed`` (the same draw on every machine).

    Cameras stand on a ring of radius ``RING`` (radial and height jitter)
    in the x-z plane, facing its centre (yaw to the centre, pitch, roll and
    yaw jitter of 0.02 rad), with f ~ U(500, 1500) px, k1 ~ N(0, 0.05²),
    k2 ~ N(0, 0.01²).  Points lie in the disk of radius ``DISK`` (height
    U(−``HEIGHT``, ``HEIGHT``)), so every point is in front of every camera.
    Track lengths are 2 + a geometric count with mean n_obs/P − 2, at most
    ``WINDOW`` (or C), moved by one at random points until they sum to
    n_obs.  A point is seen by k_p distinct cameras drawn among the
    ``WINDOW`` nearest on the ring to its own bearing.
    Observations are ordered by camera, then point.

    Returns float64 tensors ``cams`` (C, 9), ``pts`` (P, 3), int64
    ``cam_idx``, ``pt_idx`` and the exact projections ``u`` (n_obs, 2)."""
    C, P = int(n_cams), int(n_pts)
    W = min(WINDOW, C)
    if not 2 * P <= n_obs <= W * P:
        raise ValueError(f"n_obs must lie in [2P, {W}P] for tracks of 2 to {W} cameras; got {n_obs}")
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    f64 = torch.float64

    def U(*shape):
        return torch.rand(shape, generator=g, dtype=f64)

    def N(*shape):
        return torch.randn(shape, generator=g, dtype=f64)

    phi = 2 * math.pi * (torch.arange(C, dtype=f64) + 0.25 * (U(C) - 0.5)) / C
    rad = RING + 0.3 * N(C)
    centre = torch.stack([rad * torch.sin(phi), 0.2 * N(C), rad * torch.cos(phi)], -1)
    yaw = torch.remainder(-phi + math.pi, 2 * math.pi) - math.pi
    w = torch.stack([0.02 * N(C), yaw + 0.02 * N(C), 0.02 * N(C)], -1)
    t = -rotate(w, centre)
    intr = torch.stack([500 + 1000 * U(C), 0.05 * N(C), 0.01 * N(C)], -1)
    cams = torch.cat([w, t, intr], -1)

    bearing = 2 * math.pi * U(P)
    r = DISK * torch.sqrt(U(P))
    pts = torch.stack([r * torch.sin(bearing), HEIGHT * (2 * U(P) - 1), r * torch.cos(bearing)], -1)

    q = 1.0 / (1.0 + (n_obs / P - 2))
    k = 2 + torch.floor(torch.log(U(P).clamp_min(1e-300)) / math.log1p(-q)).to(torch.int64) if q < 1 else \
        torch.full((P,), 2, dtype=torch.int64)
    k = k.clamp(2, W)
    while True:
        diff = n_obs - int(k.sum())
        if diff == 0:
            break
        cand = torch.nonzero(k < W if diff > 0 else k > 2)[:, 0]
        pick = cand[torch.randperm(cand.numel(), generator=g)[: min(abs(diff), cand.numel())]]
        k[pick] += 1 if diff > 0 else -1

    anchor = torch.round(bearing * C / (2 * math.pi)).to(torch.int64)
    slots = torch.argsort(U(P, W), dim=1)
    chosen = slots[torch.arange(W)[None, :] < k[:, None]]
    pt_idx = torch.repeat_interleave(torch.arange(P), k)
    cam_idx = torch.remainder(anchor[pt_idx] - W // 2 + chosen, C)
    order = torch.argsort(cam_idx * P + pt_idx)
    cam_idx, pt_idx = cam_idx[order], pt_idx[order]
    depth = rotate(cams[cam_idx, :3], pts[pt_idx])[:, 2] + cams[cam_idx, 5]
    if not bool((depth < 0).all()):
        raise ValueError("a drawn point lies behind a camera that sees it")
    u = snavely_project(cams[cam_idx], pts[pt_idx])
    return {"cams": cams, "pts": pts, "cam_idx": cam_idx, "pt_idx": pt_idx, "u": u}


def perturb(cams: torch.Tensor, pts: torch.Tensor, g: torch.Generator):
    """The start of a re-run: cameras and points moved from ``cams``,
    ``pts`` by w += N(0, 1e-3²) rad, t += N(0, 1e-2²), f ×= 1 + N(0, 1e-3²),
    k1 += N(0, 1e-3²), k2 += N(0, 1e-4²), X += N(0, 1e-2²), camera 0's w and
    t kept (its pinned gauge); draws from ``g`` on the tensors' device."""
    scale = torch.tensor([1e-3] * 3 + [1e-2] * 3 + [1e-3, 1e-3, 1e-4], dtype=cams.dtype, device=cams.device)
    dc = torch.randn(cams.shape, generator=g, dtype=cams.dtype, device=cams.device) * scale
    dc[:, 6] = dc[:, 6] * cams[:, 6]
    dc[0, :6] = 0
    dp = 1e-2 * torch.randn(pts.shape, generator=g, dtype=pts.dtype, device=pts.device)
    return cams + dc, pts + dp


def bal_scene(
    n_cams: int,
    n_pts: int,
    n_obs: int,
    seed: int = 0,
    *,
    noise: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[NLSProblem, np.ndarray]:
    """A BAL problem on a synthetic scene at exactly the given counts
    (:func:`draw_scene`), observations the exact projections plus
    N(0, ``noise``²) pixels, started from the truth moved by
    :func:`perturb`, gauge at the truth; returns (problem, x_true).  Every
    draw is made on the CPU from ``seed``."""
    sc = draw_scene(n_cams, n_pts, n_obs, seed)
    g = torch.Generator().manual_seed((int(seed) + 1) % (1 << 63))
    obs = sc["u"] + noise * torch.randn(sc["u"].shape, generator=g, dtype=torch.float64)
    cams0, pts0 = perturb(sc["cams"], sc["pts"], g)
    c = sc["cams"]
    base2 = ((camera_centre(c[1]) - camera_centre(c[0])) ** 2).sum()
    pb = bal_problem(cams0, pts0, sc["cam_idx"], sc["pt_idx"], obs, pose0=c[0, :6], base2=base2, dtype=dtype,
                     device=device, name=f"bal_{n_cams}c{n_pts}p{n_obs}o")
    x_true = torch.cat([c.reshape(-1), sc["pts"].reshape(-1)]).numpy()
    return pb, x_true


def _open(path, mode):
    return bz2.open(path, mode) if str(path).endswith(".bz2") else open(path, mode)


def read_bal(path) -> dict:
    """A BAL problem file (``.bz2`` or plain text): ``{"cams" (C, 9),
    "pts" (P, 3), "cam_idx", "pt_idx" (n_obs,) int64, "obs" (n_obs, 2)}``
    as numpy arrays.  The format: a line ``C P n_obs``; n_obs lines
    ``camera point x y``; then the 9·C camera parameters and the 3·P point
    coordinates, whitespace-separated (one a line in the published files)."""
    with _open(path, "rt") as f:
        head = f.readline().split()
        if len(head) != 3:
            raise ValueError(f"{path}: the first line must be 'C P n_obs'")
        C, P, n = (int(v) for v in head)
        rows = np.loadtxt(f, max_rows=n, ndmin=2) if n else np.zeros((0, 4))
        rest = np.array(f.read().split(), dtype=np.float64)
    if rows.shape != (n, 4) or rest.size != CAM * C + 3 * P:
        raise ValueError(f"{path}: expected {n} observations and {CAM * C + 3 * P} parameters, "
                         f"got {rows.shape[0]} and {rest.size}")
    return {"cams": rest[: CAM * C].reshape(C, CAM), "pts": rest[CAM * C:].reshape(P, 3),
            "cam_idx": rows[:, 0].astype(np.int64), "pt_idx": rows[:, 1].astype(np.int64),
            "obs": rows[:, 2:4].copy()}


def write_bal(path, cams, pts, cam_idx, pt_idx, obs):
    """Write a problem in the BAL text format that :func:`read_bal` reads
    (``.bz2`` compressed where ``path`` ends so)."""
    cams, pts = np.asarray(cams, dtype=np.float64), np.asarray(pts, dtype=np.float64)
    cam_idx, pt_idx = np.asarray(cam_idx, dtype=np.int64), np.asarray(pt_idx, dtype=np.int64)
    obs = np.asarray(obs, dtype=np.float64)
    with _open(path, "wt") as f:
        f.write(f"{cams.shape[0]} {pts.shape[0]} {cam_idx.shape[0]}\n")
        for c, p, (u, v) in zip(cam_idx.tolist(), pt_idx.tolist(), obs.tolist()):
            f.write(f"{c} {p} {u!r} {v!r}\n")
        f.write("".join(f"{v!r}\n" for v in np.concatenate([cams.ravel(), pts.ravel()]).tolist()))
