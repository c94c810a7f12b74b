"""The cyclic collector's pauses per burst solve: the mean of the
program's `gc0` + `gc1` + `gc2` totals over every solve, a solve with no
pause counting 0. None when no solve has any (a program that does not
record them)."""

PARTS = ("gc0", "gc1", "gc2")


def read(ctx):
    stages = ctx.get("stages", [])
    if not any(k in s for s in stages for k in PARTS):
        return None
    return sum(s.get(k, 0.0) for s in stages for k in PARTS) / len(stages)
