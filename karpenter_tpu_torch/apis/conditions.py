"""Status-condition machinery (reference: operatorpkg status conditions used by
NodeClaim/NodePool, pkg/apis/v1/nodeclaim_status.go).

Conditions are the durable checkpoints of the system — every controller is an
idempotent reconciler over them (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

from dataclasses import dataclass, field

TRUE = "True"
FALSE = "False"
UNKNOWN = "Unknown"


@dataclass
class Condition:
    type: str
    status: str = UNKNOWN
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class ConditionSet:
    conditions: list[Condition] = field(default_factory=list)

    def get(self, ctype: str) -> Condition | None:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    def set(self, ctype: str, status: str, reason: str = "", message: str = "", now: float = 0.0) -> bool:
        """Returns True if the condition transitioned."""
        c = self.get(ctype)
        if c is None:
            self.conditions.append(Condition(ctype, status, reason, message, now))
            return True
        changed = c.status != status
        if changed:
            c.last_transition_time = now
        c.status = status
        c.reason = reason
        c.message = message
        return changed

    def set_true(self, ctype: str, reason: str = "", now: float = 0.0) -> bool:
        return self.set(ctype, TRUE, reason or ctype, now=now)

    def set_false(self, ctype: str, reason: str, message: str = "", now: float = 0.0) -> bool:
        return self.set(ctype, FALSE, reason, message, now=now)

    def clear(self, ctype: str) -> bool:
        c = self.get(ctype)
        if c is not None:
            self.conditions.remove(c)
            return True
        return False

    def is_true(self, ctype: str) -> bool:
        c = self.get(ctype)
        return c is not None and c.status == TRUE

    def is_false(self, ctype: str) -> bool:
        c = self.get(ctype)
        return c is not None and c.status == FALSE

    def transitioned_since(self, ctype: str, now: float) -> float:
        c = self.get(ctype)
        return now - c.last_transition_time if c else 0.0
