"""The host's first-fit-decreasing residual per burst solve (the pods the
program's hybrid partition keeps off the device): the mean of the
program's `residual` span, over the solves that have one."""


def read(ctx):
    v = [s["residual"] for s in ctx.get("stages", []) if "residual" in s]
    return sum(v) / len(v) if v else None
