"""bal_dubrovnik356: BAL Dubrovnik-356 for the program under test.

A synthetic scene at the published counts of BAL's Dubrovnik
problem-356-226730 (``bal_dubrovnik356.json``): the scene is drawn once per
run from the file's ``scene_seed``, on the CPU in float64 (the same scene on
every machine and every run), by a frozen copy of the program's
``models.bal.draw_scene`` and ``perturb`` as they were first written, the
start's moves scaled by the file's ``x0_scale``.  The problem is built by
the program's ``bal_problem``, as a user holding the observations would;
each input of the bank carries its own observations (the exact projections
plus N(0, 1 px^2)) and its own start, drawn on the card from the mix's pool
seed.
"""

from __future__ import annotations

import math

import torch


def _rotate(w, X):
    theta2 = (w * w).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-30)
    k = w / theta
    c, s = torch.cos(theta), torch.sin(theta)
    kxX = torch.linalg.cross(k, X, dim=-1)
    full = c * X + s * kxX + (1 - c) * (k * X).sum(-1, keepdim=True) * k
    return torch.where(theta2 < 1e-12, X + torch.linalg.cross(w, X, dim=-1), full)


def _project(cam, pt):
    P = _rotate(cam[..., :3], pt) + cam[..., 3:6]
    p = -P[..., :2] / P[..., 2:]
    r2 = (p * p).sum(-1, keepdim=True)
    return cam[..., 6:7] * (1 + cam[..., 7:8] * r2 + cam[..., 8:9] * r2 * r2) * p


RING, DISK, HEIGHT, WINDOW = 10.0, 4.0, 1.0, 48


def draw_scene(C: int, P: int, n_obs: int, seed: int) -> dict:
    """The frozen scene draw: float64 on the CPU (``assumed`` in the file)."""
    W = min(WINDOW, C)
    if not 2 * P <= n_obs <= W * P:
        raise ValueError(f"n_obs must lie in [2P, {W}P]; got {n_obs}")
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
    t = -_rotate(w, centre)
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
    return {"cams": cams, "pts": pts, "cam_idx": cam_idx, "pt_idx": pt_idx,
            "u": _project(cams[cam_idx], pts[pt_idx])}


def _perturb(cams, pts, g, scale: float):
    """The frozen start: the scene moved (``assumed.x0`` in the file, at the
    file's ``x0_scale``), on the tensors' device."""
    sd = scale * torch.tensor([1e-3] * 3 + [1e-2] * 3 + [1e-3, 1e-3, 1e-4], dtype=cams.dtype, device=cams.device)
    dc = torch.randn(cams.shape, generator=g, dtype=cams.dtype, device=cams.device) * sd
    dc[:, 6] = dc[:, 6] * cams[:, 6]
    dc[0, :6] = 0
    dp = scale * 1e-2 * torch.randn(pts.shape, generator=g, dtype=pts.dtype, device=pts.device)
    return cams + dc, pts + dp


def shared_inputs(cfg: dict, g: torch.Generator, device):
    """The scene every solve of a run shares, drawn from ``scene_seed`` (not
    from the run's seed): float64 truth on the card, and the gauge's values."""
    sc = draw_scene(cfg["n_cams"], cfg["n_pts"], cfg["n_obs"], cfg["scene_seed"])
    out = {k: v.to(device) for k, v in sc.items()}
    cams = out["cams"]
    c01 = -_rotate(-cams[:2, :3], cams[:2, 3:6])
    out["pose0"] = cams[0, :6].clone()
    out["base2"] = ((c01[1] - c01[0]) ** 2).sum().reshape(1)
    return out


def problem(cfg: dict, device, shared):
    """The program's BAL problem of the scene, started at the truth and
    observing the exact projections (each call brings its own start and
    observations)."""
    from cannoles_tpu_torch.models.bal import bal_problem

    return bal_problem(shared["cams"], shared["pts"], shared["cam_idx"], shared["pt_idx"], shared["u"],
                       pose0=shared["pose0"], base2=shared["base2"], dtype=getattr(torch, cfg["dtype"]),
                       device=device, name="portbench_bal_dubrovnik356")


def draw(cfg: dict, g: torch.Generator, count: int, batch: int, device, shared=None):
    """``count`` inputs of one solve each (``batch`` must be 1): dicts with
    x0 (1, n), data {obs (1, n_obs, 2)} and the input's number ``set`` (1,)."""
    if batch != 1:
        raise ValueError("bal_dubrovnik356 solves one problem at a time (batch 1)")
    dtype = getattr(torch, cfg["dtype"])
    items = []
    for k in range(count):
        noise = torch.randn(shared["u"].shape, generator=g, dtype=torch.float64, device=device)
        cams, pts = _perturb(shared["cams"], shared["pts"], g, float(cfg["x0_scale"]))
        x0 = torch.cat([cams.reshape(-1), pts.reshape(-1)]).to(dtype)
        items.append(dict(x0=x0[None], data={"obs": (shared["u"] + noise).to(dtype)[None]},
                          set=torch.tensor([k], device=device)))
    return items
