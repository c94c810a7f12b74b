"""Go-style duration strings ("1h30m", "10s", "Never") and a minimal
standard-cron engine for disruption-budget schedules (nodepool.go:406-421).
"""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone

_DUR_RE = re.compile(r"(\d+)(h|m|s)")

NEVER = float("inf")


def parse_duration(s: str | float | int | None) -> float | None:
    """Parse "1h30m10s" to seconds; "Never" -> inf; None passes through."""
    if s is None:
        return None
    if isinstance(s, (int, float)):
        return float(s)
    if s == "Never":
        return NEVER
    total = 0.0
    pos = 0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        n, unit = int(m.group(1)), m.group(2)
        total += n * {"h": 3600, "m": 60, "s": 1}[unit]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ValueError(f"invalid duration {s!r}")
    return total


_MACROS = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
    "@annually": "0 0 1 1 *",
    "@yearly": "0 0 1 1 *",
}


class Cron:
    """Standard 5-field cron matcher (UTC), enough for budget schedules."""

    def __init__(self, expr: str):
        expr = _MACROS.get(expr.strip(), expr.strip())
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"invalid cron {expr!r}")
        ranges = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]
        self.sets = [self._parse_field(f, lo_, hi_) for f, (lo_, hi_) in zip(fields, ranges)]
        self.dom_star = fields[2] == "*"
        self.dow_star = fields[4] == "*"

    @staticmethod
    def _parse_field(field: str, lo_: int, hi_: int) -> set[int]:
        out: set[int] = set()
        for part in field.split(","):
            step = 1
            if "/" in part:
                part, step_s = part.split("/", 1)
                step = int(step_s)
            if part in ("*", ""):
                a, b = lo_, hi_
            elif "-" in part:
                a_s, b_s = part.split("-", 1)
                a, b = int(a_s), int(b_s)
            else:
                a = b = int(part)
            for v in range(a, b + 1, step):
                if v == 7 and lo_ == 0 and hi_ == 6:
                    v = 0  # Sunday may be 7
                if lo_ <= v <= hi_:
                    out.add(v)
        if not out:
            raise ValueError(f"empty cron field {field!r}")
        return out

    def matches(self, t: datetime) -> bool:
        minute, hour, dom, month, dow = self.sets
        if t.minute not in minute or t.hour not in hour or t.month not in month:
            return False
        dom_ok = t.day in dom
        dow_ok = t.isoweekday() % 7 in dow
        # standard cron: if both dom and dow are restricted, either may match
        if not self.dom_star and not self.dow_star:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def active_within(self, now: float, duration_s: float) -> bool:
        """True if any schedule hit occurred in [now - duration, now] (UTC).

        Mirrors Budget.IsActive (nodepool.go:412-430): walk back the duration
        and check whether the schedule fired inside the window.
        """
        end = datetime.fromtimestamp(now, tz=timezone.utc).replace(second=0, microsecond=0)
        steps = int(duration_s // 60) + 1
        t = end
        for _ in range(steps):
            if self.matches(t):
                return True
            t -= timedelta(minutes=1)
        return False
