"""Decode into NodeClaims per burst solve: the mean of the program's
`decode` span."""


def read(ctx):
    v = [s["decode"] for s in ctx.get("stages", []) if "decode" in s]
    return sum(v) / len(v) if v else None
