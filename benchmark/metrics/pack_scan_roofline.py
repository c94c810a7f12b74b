"""K2 (`pack_scan`)'s share of its roofline over the window: the least
time the card could take for the launches' bytes and operations
(`roofline.k2_cost` of one launch, counted on a warm solve in set-up, times
the launches in the profiler's trace) over their device time."""

from benchmark.roofline import bound_s


def read(ctx):
    per = ctx.get("k2_launch")
    names = [k for k in ctx.get("kernels", {}) if "pack_scan_kernel" in k]
    t = sum(ctx["kernels"][k] for k in names)
    n = sum(ctx.get("launches", {}).get(k, 0) for k in names)
    if not per or not t or not n:
        return None
    return 100.0 * bound_s(per[0] * n, per[1] * n) / t
