"""Dedup-cached event recorder (reference: pkg/events/recorder.go:40-90).

Events involving the same object/reason within the dedupe window collapse to
one. Events are retained in-process (the Store has no Event kind); tests and
the monitor read recorder.events.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..obs.racecheck import make_rlock

DEFAULT_DEDUPE_TIMEOUT = 120.0


@dataclass
class Event:
    involved_kind: str
    involved_name: str
    type: str  # Normal | Warning
    reason: str
    message: str
    timestamp: float = 0.0
    dedupe_values: tuple = ()
    dedupe_timeout: float = DEFAULT_DEDUPE_TIMEOUT

    def dedupe_key(self) -> str:
        return "-".join([self.reason.lower(), *map(str, self.dedupe_values or (self.involved_kind, self.involved_name))])


class Recorder:
    GUARDED_FIELDS = {"events": "_lock", "_seen": "_lock"}

    def __init__(self, clock, max_events: int = 2000):
        self.clock = clock
        self.events: list[Event] = []
        self._max = max_events
        self._lock = make_rlock("events")
        self._seen: dict[str, float] = {}  # dedupe key -> last publish time

    def publish(self, obj, reason: str, message: str, type_: str = "Normal", dedupe_values: tuple = (), dedupe_timeout: float = DEFAULT_DEDUPE_TIMEOUT) -> bool:
        ev = Event(
            involved_kind=getattr(obj, "kind", type(obj).__name__),
            involved_name=obj.metadata.name if hasattr(obj, "metadata") else str(obj),
            type=type_,
            reason=reason,
            message=message,
            timestamp=self.clock.now(),
            dedupe_values=tuple(dedupe_values),
            dedupe_timeout=dedupe_timeout,
        )
        key = ev.dedupe_key()
        with self._lock:
            last = self._seen.get(key)
            if last is not None and self.clock.now() - last < ev.dedupe_timeout:
                return False
            self._seen[key] = self.clock.now()
            self.events.append(ev)
            if len(self.events) > self._max:
                del self.events[: len(self.events) - self._max]
        return True

    def for_object(self, name: str) -> list[Event]:
        with self._lock:
            return [e for e in self.events if e.involved_name == name]

    def reasons(self) -> list[str]:
        with self._lock:
            return [e.reason for e in self.events]
