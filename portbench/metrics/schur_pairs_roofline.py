"""schur_pairs_roofline (``schur_pairs_roofline.bal``): the pair
accumulation's share of its roofline in the traced slice, in percent.

The least time of the slice's camera-system assemblies over the device time
of the pair kernel's launches in the slice (the profiler's operations named
in ``KERNELS``).  The work is counted from the scene's observation structure
(``structure``: the observations, the pairs of observations of one point
with cam_i >= cam_j, and the lower-triangle camera blocks with a shared
point), so that it reads the same whatever implements the assembly: bytes
count X and W read once (n_obs x 2 x 3cd items), the pair list read once
(two 32-bit indices a pair, one a block) and each lower block written once
(cd^2 items); operations 2 cd^2 3 a pair.  The least time is the larger of
bytes over the card's HBM bandwidth and operations over its float32 peak
(``common/peaks.py``), times the assemblies that the entry's returned
``("schur", "assemble")`` deltas count; the reading says on stderr which
bounds it.  It reads nothing where the slice has no such kernel or the
program no such counter.
"""

import torch

UNIT = "%"
SOURCE = "device_trace"
LAYER = "sparse Schur assembly (ops/schur_pairs.py, csrc/schur_pairs.cu)"
KERNELS = ("schur_pairs_kernel",)


def structure(cam_idx, pt_idx, n_cams: int, cd: int) -> dict:
    """The counts of an observation list: ``n_obs``, ``pairs`` (sum over the
    points of k(k + 1)/2, k a point's observations), ``blocks`` (the pairs
    cam_i >= cam_j of cameras that share a point) and ``cd``."""
    k = torch.bincount(pt_idx).to(torch.int64)
    vis = torch.zeros((n_cams, int(pt_idx.max()) + 1), dtype=torch.float32, device=cam_idx.device)
    vis[cam_idx, pt_idx] = 1.0
    shared = vis @ vis.T > 0
    return {"n_obs": int(cam_idx.shape[0]), "pairs": int((k * (k + 1) // 2).sum()),
            "blocks": int(torch.tril(shared).sum()), "cd": int(cd)}


def work(scene: dict, item: int = 4):
    """(bytes, operations) of one assembly of ``scene`` (``structure``)."""
    cd = scene["cd"]
    items = scene["n_obs"] * 2 * 3 * cd + scene["blocks"] * cd * cd
    nbytes = items * item + (2 * scene["pairs"] + scene["blocks"] + 1) * 4
    return nbytes, 2 * cd * cd * 3 * scene["pairs"]


def read(ctx):
    sl, peaks = ctx.slice, ctx.peaks
    if sl is None or peaks is None or not sl.outputs:
        return None
    kernel_s = sum(e - s for name, s, e in sl.device_ops if any(k in name for k in KERNELS)) / 1e6
    counts = [out.get("assemble") for out in sl.outputs]
    scene = sl.outputs[0].get("scene")
    if kernel_s <= 0 or scene is None or any(c is None for c in counts) or sum(counts) == 0:
        return None
    item = 8 if ctx.config["dtype"] == "float64" else 4
    nbytes, flops = work(scene, item)
    t_bytes = nbytes / peaks["hbm_bytes_s"]
    t_flops = flops / peaks[f"{ctx.config['dtype']}_flop_s"]
    least = sum(counts) * max(t_bytes, t_flops)
    ctx.log(f"# schur_pairs_roofline: {sum(counts)} assemblies of {scene['pairs']} pairs, {scene['blocks']} blocks; "
            f"kernel {kernel_s:.6f} s, bound {'bytes' if t_bytes >= t_flops else 'operations'} {least:.3e} s")
    return 100.0 * least / kernel_s
