"""Object-churn watcher: record and pretty-print store activity during e2e.

Reference: test/pkg/debug/ — the e2e environment watches pods, nodes,
nodeclaims, and events, timestamping every create/update/delete so failing
specs dump the cluster's recent history instead of a bare assertion error.
Here the watcher subscribes to kube.Store watches (the same fan-out the
informers use) and renders a bounded, ordered churn log.
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass

DEFAULT_KINDS = ("Pod", "Node", "NodeClaim", "NodePool")


@dataclass
class ChurnEvent:
    timestamp: float
    event: str  # ADDED | MODIFIED | DELETED
    kind: str
    key: str
    resource_version: int


class ObjectChurnWatcher:
    """Subscribes to store watches for the given kinds and keeps a bounded
    event log. Use as a context manager around a spec body to dump the churn
    history when it raises (test/pkg/debug setup.go semantics)."""

    def __init__(self, store, kinds: tuple = DEFAULT_KINDS, clock=None, max_events: int = 2000, sink=None):
        self.store = store
        self.kinds = kinds
        self.clock = clock
        self.max_events = max_events
        self.sink = sink  # callable(str) on failure; default print
        self.events: list[ChurnEvent] = []
        self._recorders: list[tuple[str, object]] = []
        for kind in kinds:
            fn = self._make_recorder(kind)
            self._recorders.append((kind, fn))
            store.watch(kind, fn)

    def close(self) -> None:
        """Unsubscribe from the store (dead watchers must not keep paying a
        per-event deepcopy on a long-lived suite store)."""
        for kind, fn in self._recorders:
            self.store.unwatch(kind, fn)
        self._recorders.clear()

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.monotonic()

    def _make_recorder(self, kind: str):
        def record(event, obj):
            if len(self.events) >= self.max_events:
                del self.events[: self.max_events // 2]  # keep the recent half
            key = getattr(obj, "key", None)
            self.events.append(
                ChurnEvent(
                    timestamp=self._now(),
                    event=event,
                    kind=kind,
                    key=key() if callable(key) else obj.metadata.name,
                    resource_version=obj.metadata.resource_version,
                )
            )

        return record

    def counts(self) -> dict[tuple, int]:
        out: dict[tuple, int] = {}
        for e in self.events:
            k = (e.kind, e.event)
            out[k] = out.get(k, 0) + 1
        return out

    def dump(self, limit: int = 50) -> str:
        """The most recent `limit` events as an aligned table."""
        buf = io.StringIO()
        buf.write(f"--- object churn (last {min(limit, len(self.events))} of {len(self.events)} events) ---\n")
        for e in self.events[-limit:]:
            buf.write(f"{e.timestamp:14.3f}  {e.event:<8}  {e.kind:<10}  rv={e.resource_version:<6}  {e.key}\n")
        return buf.getvalue()

    # -- context manager: dump on failure (debug/setup.go) ---------------------
    def __enter__(self) -> "ObjectChurnWatcher":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            (self.sink or print)(self.dump())
        self.close()
        return False  # never swallow the failure
