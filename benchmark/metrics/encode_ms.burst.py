"""The encoder's time per burst solve: the mean of the program's `encode`
span (`GPUSolver.last_stages`, device synchronised at span edges)."""


def read(ctx):
    v = [s["encode"] for s in ctx.get("stages", []) if "encode" in s]
    return sum(v) / len(v) if v else None
