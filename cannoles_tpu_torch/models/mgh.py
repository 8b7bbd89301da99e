"""Moré–Garbow–Hillstrom (1981) 35-problem nonlinear least-squares battery,
plus 20 dimensional variants from the paper's tables.

Port of ``cannoles_tpu/models/mgh.py``.  Each problem is a torch residual
with the standard starting point; ``fmin`` records the certified minimum
of Σfᵢ² where the literature gives one (None: unknown or ambiguous).

Every constructor and every spec's ``make`` takes ``dtype=None`` (float64)
and ``device=None`` (the card; ``"cpu"`` builds on the CPU).  Data tables
and derived constants are computed in float64 numpy and cast once, at
build time, to the problem's dtype and device.  Residuals are vectorized
(no Python loop over the variables) so that they vmap and differentiate
with ``torch.func``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..problem import NLSProblem, default_device, nls_problem

__all__ = ["mgh_problem", "mgh_suite", "MGH_NAMES", "MGHSpec"]


class MGHSpec(NamedTuple):
    name: str
    make: Callable[..., NLSProblem]  # make(dtype=None, device=None)
    fmin: Optional[float]  # certified min of Σ fᵢ² (= 2·objective), if known


def _placed(fn):
    """Resolve a constructor's ``dtype``/``device`` once and hand it a
    caster ``c`` (float64 numpy → tensor there; boolean masks stay
    boolean) and a problem builder ``p(F, x0, m, name)``."""

    @functools.wraps(fn)
    def wrapper(*args, dtype=None, device=None):
        dt = torch.float64 if dtype is None else dtype
        dev = default_device(device)

        def c(a):
            a = np.asarray(a)
            if a.dtype == bool:
                return torch.as_tensor(a, device=dev)
            return torch.as_tensor(a.astype(np.float64), dtype=dt, device=dev)

        def p(F, x0, m, name):
            return nls_problem(F, np.asarray(x0, dtype=np.float64), m, name=name, dtype=dt, device=dev)

        return fn(*args, c=c, p=p)

    return wrapper


# ----------------------------------------------------------------------
# data tables (copied from the JAX package's models/mgh.py)
# ----------------------------------------------------------------------
_BARD_Y = np.array(
    [0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39, 0.37, 0.58, 0.73, 0.96, 1.34, 2.10, 4.39]
)
_GAUSS_Y = np.array(
    [0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420, 0.3521, 0.3989,
     0.3521, 0.2420, 0.1295, 0.0540, 0.0175, 0.0044, 0.0009]
)
_MEYER_Y = np.array(
    [34780., 28610., 23650., 19630., 16370., 13720., 11540., 9744.,
     8261., 7030., 6005., 5147., 4427., 3820., 3307., 2872.]
)
_KOW_Y = np.array(
    [0.1957, 0.1947, 0.1735, 0.1600, 0.0844, 0.0627, 0.0456, 0.0342, 0.0323, 0.0235, 0.0246]
)
_KOW_U = np.array([4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1, 0.0833, 0.0714, 0.0625])
_OSB1_Y = np.array(
    [0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881, 0.850, 0.818, 0.784, 0.751,
     0.718, 0.685, 0.658, 0.628, 0.603, 0.580, 0.558, 0.538, 0.522, 0.506, 0.490,
     0.478, 0.467, 0.457, 0.448, 0.438, 0.431, 0.424, 0.420, 0.414, 0.411, 0.406]
)
_OSB2_Y = np.array(
    [1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847, 0.786, 0.725, 0.746,
     0.679, 0.608, 0.655, 0.616, 0.606, 0.602, 0.626, 0.651, 0.724, 0.649, 0.649,
     0.694, 0.644, 0.624, 0.661, 0.612, 0.558, 0.533, 0.495, 0.500, 0.423, 0.395,
     0.375, 0.372, 0.391, 0.396, 0.405, 0.428, 0.429, 0.523, 0.562, 0.607, 0.653,
     0.672, 0.708, 0.633, 0.668, 0.645, 0.632, 0.591, 0.559, 0.597, 0.625, 0.739,
     0.710, 0.729, 0.720, 0.636, 0.581, 0.428, 0.292, 0.162, 0.098, 0.054]
)


# ----------------------------------------------------------------------
# problem constructors (numbering follows MGH 1981)
# ----------------------------------------------------------------------
@_placed
def rosenbrock(*, c, p):  # 1
    return p(lambda x: torch.stack([10 * (x[1] - x[0] ** 2), 1 - x[0]]),
             [-1.2, 1.0], 2, "mgh01_rosenbrock")


@_placed
def freudenstein_roth(*, c, p):  # 2
    def F(x):
        return torch.stack(
            [-13 + x[0] + ((5 - x[1]) * x[1] - 2) * x[1],
             -29 + x[0] + ((x[1] + 1) * x[1] - 14) * x[1]]
        )
    return p(F, [0.5, -2.0], 2, "mgh02_freudenstein_roth")


@_placed
def powell_badly_scaled(*, c, p):  # 3
    def F(x):
        return torch.stack([1e4 * x[0] * x[1] - 1, torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001])
    return p(F, [0.0, 1.0], 2, "mgh03_powell_badly_scaled")


@_placed
def brown_badly_scaled(*, c, p):  # 4
    def F(x):
        return torch.stack([x[0] - 1e6, x[1] - 2e-6, x[0] * x[1] - 2])
    return p(F, [1.0, 1.0], 3, "mgh04_brown_badly_scaled")


@_placed
def beale(*, c, p):  # 5
    y = c([1.5, 2.25, 2.625])
    i = c(np.arange(1, 4))

    def F(x):
        return y - x[0] * (1 - x[1] ** i)
    return p(F, [1.0, 1.0], 3, "mgh05_beale")


@_placed
def jennrich_sampson(m=10, *, c, p):  # 6
    i = c(np.arange(1, m + 1))

    def F(x):
        return 2 + 2 * i - (torch.exp(i * x[0]) + torch.exp(i * x[1]))
    return p(F, [0.3, 0.4], m, "mgh06_jennrich_sampson")


@_placed
def helical_valley(*, c, p):  # 7
    def F(x):
        # atan2 matches the MGH branch convention (adds 0.5 for x1 < 0)
        theta = torch.atan2(x[1], x[0]) / (2 * math.pi)
        return torch.stack(
            [10 * (x[2] - 10 * theta),
             10 * (torch.sqrt(x[0] ** 2 + x[1] ** 2) - 1),
             x[2]]
        )
    return p(F, [-1.0, 0.0, 0.0], 3, "mgh07_helical_valley")


@_placed
def bard(*, c, p):  # 8
    y = c(_BARD_Y)
    u_np = np.arange(1.0, 16.0)
    u, v, w = c(u_np), c(16.0 - u_np), c(np.minimum(u_np, 16.0 - u_np))

    def F(x):
        return y - (x[0] + u / (v * x[1] + w * x[2]))
    return p(F, [1.0, 1.0, 1.0], 15, "mgh08_bard")


@_placed
def gaussian(*, c, p):  # 9
    y = c(_GAUSS_Y)
    t = c((8.0 - np.arange(1.0, 16.0)) / 2.0)

    def F(x):
        return x[0] * torch.exp(-x[1] * (t - x[2]) ** 2 / 2) - y
    return p(F, [0.4, 1.0, 0.0], 15, "mgh09_gaussian")


@_placed
def meyer(*, c, p):  # 10
    y = c(_MEYER_Y)
    t = c(45.0 + 5.0 * np.arange(1.0, 17.0))

    def F(x):
        return x[0] * torch.exp(x[1] / (t + x[2])) - y
    return p(F, [0.02, 4000.0, 250.0], 16, "mgh10_meyer")


@_placed
def gulf(m=99, *, c, p):  # 11
    t_np = np.arange(1.0, m + 1) / 100.0
    t, mi = c(t_np), c(25.0 + (-50.0 * np.log(t_np)) ** (2.0 / 3.0))

    def F(x):
        return torch.exp(-(torch.abs(mi - x[1]) ** x[2]) / x[0]) - t
    return p(F, [5.0, 2.5, 0.15], m, "mgh11_gulf")


@_placed
def box3d(m=10, *, c, p):  # 12
    t_np = 0.1 * np.arange(1.0, m + 1)
    t, e = c(t_np), c(np.exp(-t_np) - np.exp(-10 * t_np))

    def F(x):
        return torch.exp(-t * x[0]) - torch.exp(-t * x[1]) - x[2] * e
    return p(F, [0.0, 10.0, 20.0], m, "mgh12_box3d")


@_placed
def powell_singular(*, c, p):  # 13
    s5, s10 = math.sqrt(5.0), math.sqrt(10.0)

    def F(x):
        return torch.stack(
            [x[0] + 10 * x[1],
             s5 * (x[2] - x[3]),
             (x[1] - 2 * x[2]) ** 2,
             s10 * (x[0] - x[3]) ** 2]
        )
    return p(F, [3.0, -1.0, 0.0, 1.0], 4, "mgh13_powell_singular")


@_placed
def wood(*, c, p):  # 14
    s90, s10 = math.sqrt(90.0), math.sqrt(10.0)

    def F(x):
        return torch.stack(
            [10 * (x[1] - x[0] ** 2),
             1 - x[0],
             s90 * (x[3] - x[2] ** 2),
             1 - x[2],
             s10 * (x[1] + x[3] - 2),
             (x[1] - x[3]) / s10]
        )
    return p(F, [-3.0, -1.0, -3.0, -1.0], 6, "mgh14_wood")


@_placed
def kowalik_osborne(*, c, p):  # 15
    y, u = c(_KOW_Y), c(_KOW_U)

    def F(x):
        return y - x[0] * (u**2 + u * x[1]) / (u**2 + u * x[2] + x[3])
    return p(F, [0.25, 0.39, 0.415, 0.39], 11, "mgh15_kowalik_osborne")


@_placed
def brown_dennis(m=20, *, c, p):  # 16
    t_np = np.arange(1.0, m + 1) / 5.0
    t, et, st, ct = c(t_np), c(np.exp(t_np)), c(np.sin(t_np)), c(np.cos(t_np))

    def F(x):
        return (x[0] + t * x[1] - et) ** 2 + (x[2] + x[3] * st - ct) ** 2
    return p(F, [25.0, 5.0, -5.0, -1.0], m, "mgh16_brown_dennis")


@_placed
def osborne1(*, c, p):  # 17
    y = c(_OSB1_Y)
    t = c(10.0 * np.arange(0.0, 33.0))

    def F(x):
        return y - (x[0] + x[1] * torch.exp(-t * x[3]) + x[2] * torch.exp(-t * x[4]))
    return p(F, [0.5, 1.5, -1.0, 0.01, 0.02], 33, "mgh17_osborne1")


@_placed
def biggs_exp6(m=13, *, c, p):  # 18
    t_np = 0.1 * np.arange(1.0, m + 1)
    t = c(t_np)
    y = c(np.exp(-t_np) - 5 * np.exp(-10 * t_np) + 3 * np.exp(-4 * t_np))

    def F(x):
        return (x[2] * torch.exp(-t * x[0]) - x[3] * torch.exp(-t * x[1])
                + x[5] * torch.exp(-t * x[4]) - y)
    return p(F, [1.0, 2.0, 1.0, 1.0, 1.0, 1.0], m, "mgh18_biggs_exp6")


@_placed
def osborne2(*, c, p):  # 19
    y = c(_OSB2_Y)
    t = c(np.arange(0.0, 65.0) / 10.0)

    def F(x):
        return y - (x[0] * torch.exp(-t * x[4])
                    + x[1] * torch.exp(-((t - x[8]) ** 2) * x[5])
                    + x[2] * torch.exp(-((t - x[9]) ** 2) * x[6])
                    + x[3] * torch.exp(-((t - x[10]) ** 2) * x[7]))
    return p(F, [1.3, 0.65, 0.65, 0.7, 0.6, 3.0, 5.0, 7.0, 2.0, 4.5, 5.5], 65, "mgh19_osborne2")


@_placed
def watson(n=6, *, c, p):  # 20
    t = np.arange(1.0, 30.0) / 29.0  # (29,)
    j = np.arange(1.0, n + 1)  # (n,)
    Tp = c(t[:, None] ** (j[None, :] - 1))  # t^(j-1), (29, n)
    Td = c((j[None, 1:] - 1) * t[:, None] ** (j[None, 1:] - 2))  # (j-1) t^(j-2), (29, n-1)

    def F(x):
        s2 = Tp @ x  # Σ x_j t^(j-1)
        s1 = Td @ x[1:]  # Σ (j-1) x_j t^(j-2)
        f = s1 - s2**2 - 1
        return torch.cat([f, torch.stack([x[0], x[1] - x[0] ** 2 - 1])])
    return p(F, np.zeros(n), 31, f"mgh20_watson_{n}")


@_placed
def extended_rosenbrock(n=10, *, c, p):  # 21
    if n % 2:
        raise ValueError(f"extended_rosenbrock needs an even n, got {n}")

    def F(x):
        xe, xo = x[0::2], x[1::2]
        return torch.stack([10 * (xo - xe**2), 1 - xe], dim=1).reshape(-1)
    return p(F, np.tile([-1.2, 1.0], n // 2), n, f"mgh21_ext_rosenbrock_{n}")


@_placed
def extended_powell(n=12, *, c, p):  # 22
    if n % 4:
        raise ValueError(f"extended_powell needs n divisible by 4, got {n}")
    s5, s10 = math.sqrt(5.0), math.sqrt(10.0)

    def F(x):
        x1, x2, x3, x4 = x[0::4], x[1::4], x[2::4], x[3::4]
        return torch.stack(
            [x1 + 10 * x2,
             s5 * (x3 - x4),
             (x2 - 2 * x3) ** 2,
             s10 * (x1 - x4) ** 2],
            dim=1,
        ).reshape(-1)
    return p(F, np.tile([3.0, -1.0, 0.0, 1.0], n // 4), n, f"mgh22_ext_powell_{n}")


@_placed
def penalty1(n=10, *, c, p):  # 23
    a = math.sqrt(1e-5)

    def F(x):
        return torch.cat([a * (x - 1), torch.stack([(x**2).sum() - 0.25])])
    return p(F, np.arange(1.0, n + 1), n + 1, f"mgh23_penalty1_{n}")


@_placed
def penalty2(n=10, *, c, p):  # 24
    a = math.sqrt(1e-5)
    i = np.arange(2.0, n + 1)
    y = c(np.exp(i / 10.0) + np.exp((i - 1) / 10.0))
    w = c(n - np.arange(1.0, n + 1) + 1)
    e = math.exp(-1.0 / 10.0)

    def F(x):
        f1 = torch.stack([x[0] - 0.2])
        f2 = a * (torch.exp(x[1:] / 10.0) + torch.exp(x[:-1] / 10.0) - y)
        f3 = a * (torch.exp(x[1:] / 10.0) - e)
        f4 = torch.stack([(w * x**2).sum() - 1])
        return torch.cat([f1, f2, f3, f4])
    return p(F, np.full(n, 0.5), 2 * n, f"mgh24_penalty2_{n}")


@_placed
def variably_dimensioned(n=10, *, c, p):  # 25
    j_np = np.arange(1.0, n + 1)
    j = c(j_np)

    def F(x):
        s = (j * (x - 1)).sum()
        return torch.cat([x - 1, torch.stack([s, s**2])])
    return p(F, 1.0 - j_np / n, n + 2, f"mgh25_vardim_{n}")


@_placed
def trigonometric(n=10, *, c, p):  # 26
    i = c(np.arange(1.0, n + 1))

    def F(x):
        return n - torch.cos(x).sum() + i * (1 - torch.cos(x)) - torch.sin(x)
    return p(F, np.full(n, 1.0 / n), n, f"mgh26_trigonometric_{n}")


@_placed
def brown_almost_linear(n=10, *, c, p):  # 27
    def F(x):
        head = x + x.sum() - (n + 1)
        return torch.cat([head[:-1], torch.stack([x.prod() - 1])])
    return p(F, np.full(n, 0.5), n, f"mgh27_brown_almost_linear_{n}")


@_placed
def discrete_boundary_value(n=10, *, c, p):  # 28
    h = 1.0 / (n + 1)
    t_np = h * np.arange(1.0, n + 1)
    t = c(t_np)

    def F(x):
        z = x.new_zeros(1)
        xm = torch.cat([z, x[:-1]])
        xp = torch.cat([x[1:], z])
        return 2 * x - xm - xp + h**2 * (x + t + 1) ** 3 / 2
    return p(F, t_np * (t_np - 1), n, f"mgh28_disc_boundary_{n}")


@_placed
def discrete_integral(n=10, *, c, p):  # 29
    h = 1.0 / (n + 1)
    t_np = h * np.arange(1.0, n + 1)
    t = c(t_np)
    lower = c(t_np[:, None] >= t_np[None, :])  # j <= i

    def F(x):
        g = (x + t + 1) ** 3
        a = torch.where(lower, t[None, :] * g[None, :], 0.0).sum(1)
        b = torch.where(~lower, (1 - t[None, :]) * g[None, :], 0.0).sum(1)
        return x + h * ((1 - t) * a + t * b) / 2
    return p(F, t_np * (t_np - 1), n, f"mgh29_disc_integral_{n}")


@_placed
def broyden_tridiagonal(n=10, *, c, p):  # 30
    def F(x):
        z = x.new_zeros(1)
        xm = torch.cat([z, x[:-1]])
        xp = torch.cat([x[1:], z])
        return (3 - 2 * x) * x - xm - 2 * xp + 1
    return p(F, np.full(n, -1.0), n, f"mgh30_broyden_tridiag_{n}")


@_placed
def broyden_banded(n=10, *, c, p):  # 31
    i = np.arange(n)
    mask = c((i[None, :] >= i[:, None] - 5) & (i[None, :] <= i[:, None] + 1) & (i[None, :] != i[:, None]))

    def F(x):
        s = torch.where(mask, (x * (1 + x))[None, :], 0.0).sum(1)
        return x * (2 + 5 * x**2) + 1 - s
    return p(F, np.full(n, -1.0), n, f"mgh31_broyden_banded_{n}")


@_placed
def linear_full_rank(n=10, m=20, *, c, p):  # 32
    def F(x):
        s = x.sum()
        head = x - 2 * s / m - 1
        tail = (-2 * s / m - 1).expand(m - n)
        return torch.cat([head, tail])
    return p(F, np.ones(n), m, f"mgh32_linear_full_rank_{n}_{m}")


@_placed
def linear_rank1(n=10, m=20, *, c, p):  # 33
    i, j = c(np.arange(1.0, m + 1)), c(np.arange(1.0, n + 1))

    def F(x):
        return i * (j * x).sum() - 1
    return p(F, np.ones(n), m, f"mgh33_linear_rank1_{n}_{m}")


@_placed
def linear_rank1_zero(n=10, m=20, *, c, p):  # 34
    i_np, j_np = np.arange(1.0, m + 1), np.arange(1.0, n + 1)
    i = c(i_np)
    jm = c(np.where((j_np >= 2) & (j_np <= n - 1), j_np, 0.0))
    inner = c((i_np >= 2) & (i_np <= m - 1))

    def F(x):
        s = (jm * x).sum()
        mid = (i - 1) * s - 1
        return torch.where(inner, mid, -1.0)
    return p(F, np.ones(n), m, f"mgh34_linear_rank1_zero_{n}_{m}")


@_placed
def chebyquad(n=7, *, c, p):  # 35 (m = n)
    k = np.arange(1, n + 1)
    integrals = c(np.where(k % 2 == 0, -1.0 / np.maximum(k**2 - 1.0, 1.0), 0.0))

    def F(x):
        # shifted Chebyshev on [0,1] by the three-term recurrence: smooth
        # polynomials on all of R (the arccos form has infinite derivatives
        # at the interval ends, which breaks AD once constraints push x
        # outside [0,1])
        z = 2 * x - 1
        Ts = [z, 2 * z * z - 1]
        for _ in range(2, n):
            Ts.append(2 * z * Ts[-1] - Ts[-2])
        T = torch.stack(Ts[:n])  # (n_poly, n_points)
        return T.mean(1) - integrals
    return p(F, k / (n + 1), n, f"mgh35_chebyquad_{n}")


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
_SUITE: List[MGHSpec] = [
    MGHSpec("rosenbrock", rosenbrock, 0.0),
    MGHSpec("freudenstein_roth", freudenstein_roth, 0.0),  # also local min 48.9842
    MGHSpec("powell_badly_scaled", powell_badly_scaled, 0.0),
    MGHSpec("brown_badly_scaled", brown_badly_scaled, 0.0),
    MGHSpec("beale", beale, 0.0),
    MGHSpec("jennrich_sampson", jennrich_sampson, 124.362),
    MGHSpec("helical_valley", helical_valley, 0.0),
    MGHSpec("bard", bard, 8.21487e-3),
    MGHSpec("gaussian", gaussian, 1.12793e-8),
    MGHSpec("meyer", meyer, 87.9458),
    MGHSpec("gulf", gulf, 0.0),
    MGHSpec("box3d", box3d, 0.0),
    MGHSpec("powell_singular", powell_singular, 0.0),
    MGHSpec("wood", wood, 0.0),
    MGHSpec("kowalik_osborne", kowalik_osborne, 3.07505e-4),
    MGHSpec("brown_dennis", brown_dennis, 85822.2),
    MGHSpec("osborne1", osborne1, 5.46489e-5),
    MGHSpec("biggs_exp6", biggs_exp6, None),  # 0 at (1,10,1,5,4,3); local 5.65565e-3
    MGHSpec("osborne2", osborne2, 4.01377e-2),
    MGHSpec("watson", watson, 2.28767e-3),
    MGHSpec("ext_rosenbrock", extended_rosenbrock, 0.0),
    MGHSpec("ext_powell", extended_powell, 0.0),
    MGHSpec("penalty1", penalty1, 7.08765e-5),
    MGHSpec("penalty2", penalty2, 2.93660e-4),
    MGHSpec("variably_dimensioned", variably_dimensioned, 0.0),
    MGHSpec("trigonometric", trigonometric, 0.0),
    MGHSpec("brown_almost_linear", brown_almost_linear, 0.0),  # also local min 1
    MGHSpec("discrete_boundary_value", discrete_boundary_value, 0.0),
    MGHSpec("discrete_integral", discrete_integral, 0.0),
    MGHSpec("broyden_tridiagonal", broyden_tridiagonal, 0.0),
    MGHSpec("broyden_banded", broyden_banded, 0.0),
    MGHSpec("linear_full_rank", linear_full_rank, 10.0),  # m - n
    MGHSpec("linear_rank1", linear_rank1, None),  # m(m-1)/(2(2m+1)) = 4.63415
    MGHSpec("linear_rank1_zero", linear_rank1_zero, None),  # (m²+3m-6)/(2(2m-3)) ≈ 6.13514
    MGHSpec("chebyquad", chebyquad, 0.0),
]

MGH_NAMES = [spec.name for spec in _SUITE]
_BY_NAME: Dict[str, MGHSpec] = {s.name: s for s in _SUITE}

_P = functools.partial
# dimensional variants from the MGH paper's tables (battery breadth)
_EXTENDED: List[MGHSpec] = [
    MGHSpec("watson_9", _P(watson, 9), 1.39976e-6),
    MGHSpec("watson_12", _P(watson, 12), 4.72238e-10),
    MGHSpec("penalty1_4", _P(penalty1, 4), 2.24997e-5),
    MGHSpec("penalty2_4", _P(penalty2, 4), 9.37629e-6),
    MGHSpec("chebyquad_8", _P(chebyquad, 8), 3.51687e-3),
    MGHSpec("chebyquad_9", _P(chebyquad, 9), 0.0),
    MGHSpec("ext_rosenbrock_50", _P(extended_rosenbrock, 50), 0.0),
    MGHSpec("ext_powell_20", _P(extended_powell, 20), 0.0),
    MGHSpec("trigonometric_20", _P(trigonometric, 20), 0.0),
    MGHSpec("broyden_tridiagonal_50", _P(broyden_tridiagonal, 50), 0.0),
    MGHSpec("broyden_banded_50", _P(broyden_banded, 50), 0.0),
    MGHSpec("brown_almost_linear_25", _P(brown_almost_linear, 25), 0.0),
    MGHSpec("disc_boundary_50", _P(discrete_boundary_value, 50), 0.0),
    MGHSpec("disc_integral_50", _P(discrete_integral, 50), 0.0),
    MGHSpec("vardim_20", _P(variably_dimensioned, 20), 0.0),
    MGHSpec("linear_full_rank_40_60", _P(linear_full_rank, 40, 60), 20.0),
    MGHSpec("jennrich_sampson_2_10", _P(jennrich_sampson, 10), 124.362),
    MGHSpec("box3d_20", _P(box3d, 20), 0.0),
    MGHSpec("gulf_10", _P(gulf, 10), 0.0),
    MGHSpec("biggs_exp6_24", _P(biggs_exp6, 24), 0.0),
]
for _s in _EXTENDED:
    _BY_NAME[_s.name] = _s


def mgh_problem(name: str, *, dtype=None, device=None) -> NLSProblem:
    return _BY_NAME[name].make(dtype=dtype, device=device)


def mgh_suite(extended: bool = False) -> List[MGHSpec]:
    """The 35 standard specs in MGH order; ``extended=True`` appends 20
    dimensional variants from the paper's tables."""
    return list(_SUITE) + (list(_EXTENDED) if extended else [])
