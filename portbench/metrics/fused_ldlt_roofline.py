"""fused_ldlt_roofline: the fused LDL^T kernel's share of its roofline in
the traced slice, in percent.

The least time for the work the inputs needed, over the device time of the
kernel's launches in the slice (the profiler's operations named in
``KERNELS``).  The work is one N x N factor-solve per factorization that the
returned lanes count (``nfact``, summed over the slice's outputs and over
the lanes that rank 0 solved, ``ctx.lanes``: every lane on one card, the
first of k blocks on k; N = n + m + p for the full KKT system, n + p for
the condensed one): bytes count the
matrix and the right-hand side read once and the solution and the pivots
written once, (N^2 + 3N) items; operations N^3 / 3 + 2 N^2.  The least time
is the larger of bytes over the card's HBM bandwidth and operations over its
peak in the configuration's dtype (``common/peaks.py``); the reading says on
stderr which bounds it.  Lanes that the kernel runs after they have finished, and a rescued
lane's first run, count as no work.
"""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernel (ops/fused_ldlt.py, csrc/fused_ldlt.cu)"
KERNELS = ("ldlt_thread_per_system", "ldlt_block_per_system")


def work(cfg):
    """(bytes, operations) of one factor-solve of the configuration."""
    n, m, p = cfg["nvar"], cfg["nequ"], cfg["ncon"]
    N = n + p if cfg["solver"]["kkt"] == "condensed" else n + m + p
    item = 8 if cfg["dtype"] == "float64" else 4
    return (N * N + 3 * N) * item, N ** 3 / 3 + 2 * N ** 2


def read(ctx):
    sl, peaks = ctx.slice, ctx.peaks
    if sl is None or peaks is None:
        return None
    kernel_s = sum(e - s for name, s, e in sl.device_ops if any(k in name for k in KERNELS)) / 1e6
    nfact = sum(int(out["nfact"][ctx.lanes].sum()) for out in sl.outputs)
    if kernel_s <= 0 or nfact == 0:
        return None
    nbytes, flops = work(ctx.config)
    t_bytes = nfact * nbytes / peaks["hbm_bytes_s"]
    t_flops = nfact * flops / peaks[f"{ctx.config['dtype']}_flop_s"]
    ctx.log(f"# fused_ldlt_roofline: {nfact} factor-solves, kernel {kernel_s:.6f} s, "
            f"bound {'bytes' if t_bytes >= t_flops else 'operations'} {max(t_bytes, t_flops):.3e} s")
    return 100.0 * max(t_bytes, t_flops) / kernel_s
