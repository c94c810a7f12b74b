"""The residual queue loop's new claims per burst solve (a claim opened
over the catalog's types for a pod no in-flight claim took): the mean of
the program's `ffd.new_claim` total, over the solves that have one."""


def read(ctx):
    v = [s["ffd.new_claim"] for s in ctx.get("stages", []) if "ffd.new_claim" in s]
    return sum(v) / len(v) if v else None
