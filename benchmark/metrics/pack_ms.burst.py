"""Items, tensors, K1-K3 and validation per burst solve: the mean of the
program's `pack` span less the `decode` span inside it."""


def read(ctx):
    v = [s["pack"] - s.get("decode", 0.0) for s in ctx.get("stages", []) if "pack" in s]
    return sum(v) / len(v) if v else None
