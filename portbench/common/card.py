"""The card a run uses: the check for the chips a cell asks for, the
card's name and power limit, and the seconds since a process started (for
``setup_s``: a rank of a cell on several cards counts from the start of the
process that started it)."""

from __future__ import annotations

import os
import subprocess

import torch

__all__ = ["NoCard", "require", "kind", "power_limit", "process_start_s", "since"]


class NoCard(RuntimeError):
    """Fewer CUDA devices than the cell asks for."""


def require(chips: int) -> torch.device:
    """The first card, or ``NoCard`` where CUDA is not available or has
    fewer than ``chips`` devices."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards and torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def kind(device: torch.device) -> str:
    """The card's name as ``torch.cuda.get_device_name`` gives it; ``cpu``
    off the card."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit(device: torch.device):
    """The card's power limit as ``nvidia-smi`` reads it, or None.  It takes
    up to seconds, so a run asks once its window has closed."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return out.stdout.strip().splitlines()[device.index or 0].strip()


def _uptime_s() -> float:
    with open("/proc/uptime") as f:
        return float(f.read().split()[0])


def process_start_s() -> float:
    """When this process started, in seconds of the system's uptime, from
    ``/proc``: the kernel's start time of the process, to its clock tick."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return start_ticks / os.sysconf("SC_CLK_TCK")


def since(start_s: float) -> float:
    """Seconds from ``start_s`` (a ``process_start_s()``, also another
    process's) to now."""
    return _uptime_s() - start_s
