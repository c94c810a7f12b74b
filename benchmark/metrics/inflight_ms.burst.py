"""The residual queue loop's probes of the in-flight claims per burst
solve: the mean of the program's `ffd.inflight` total (summed per pod
inside the loop), over the solves that have one."""


def read(ctx):
    v = [s["ffd.inflight"] for s in ctx.get("stages", []) if "ffd.inflight" in s]
    return sum(v) / len(v) if v else None
