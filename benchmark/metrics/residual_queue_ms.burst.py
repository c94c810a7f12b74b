"""The host residual's queue loop per burst solve (each pod tried on the
existing nodes, the in-flight claims, then a new claim): the mean of the
program's `ffd_queue` span, over the solves that have one."""


def read(ctx):
    v = [s["ffd_queue"] for s in ctx.get("stages", []) if "ffd_queue" in s]
    return sum(v) / len(v) if v else None
