"""The host residual's set-up per burst solve: the mean, over the solves
that have them, of the program's `seam_records` (the device side's
placements exported across the partition seam), `ffd_adopt` (the residual
scheduler built with the device's placements adopted and the seam recorded)
and `ffd_prepare` (topology groups, per-pod data, the queue) spans."""

PARTS = ("seam_records", "ffd_adopt", "ffd_prepare")


def read(ctx):
    v = [sum(s.get(k, 0.0) for k in PARTS) for s in ctx.get("stages", []) if any(k in s for k in PARTS)]
    return sum(v) / len(v) if v else None
