"""The card's idle share of the burst window: the window minus the union
of device operations in the profiler's trace."""


def read(ctx):
    if ctx.get("cell") != "burst" or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
