"""Problem library: basic fixtures, the Moré–Garbow–Hillstrom battery, the
Hock–Schittkowski and Lukšan–Vlček constrained batteries, and the
parameterized families."""

from .basic import (
    chained_rosenbrock,
    constrained,
    hs6,
    linear_nls,
    mgh01,
    mgh01con,
    mgh01_nofhess,
    readme_example,
    rosenbrock_nls,
    underdetermined,
)
from .families import bundle_adjustment, curve_fit_family
from .hs import HS_NAMES, HSSpec, hs_problem, hs_suite
from .lvcon import LVCON_NAMES, LVConSpec, lvcon_problem, lvcon_suite
from .mgh import MGH_NAMES, MGHSpec, mgh_problem, mgh_suite

__all__ = [
    "readme_example",
    "mgh01",
    "mgh01con",
    "mgh01_nofhess",
    "hs6",
    "linear_nls",
    "rosenbrock_nls",
    "chained_rosenbrock",
    "underdetermined",
    "constrained",
    "MGH_NAMES",
    "MGHSpec",
    "mgh_problem",
    "mgh_suite",
    "HS_NAMES",
    "HSSpec",
    "hs_problem",
    "hs_suite",
    "LVCON_NAMES",
    "LVConSpec",
    "lvcon_problem",
    "lvcon_suite",
    "bundle_adjustment",
    "curve_fit_family",
]
