"""Per-NodePool registration-health tracking.

Reference: pkg/state/nodepoolhealth/tracker.go — a 4-slot ring buffer of
launch/registration outcomes per NodePool UID; >=50% failures within the
window flips the pool's NodeRegistrationHealthy condition False.
"""

from __future__ import annotations

from ..obs.racecheck import make_rlock
from ..utils.ringbuffer import RingBuffer

BUFFER_SIZE = 4
THRESHOLD_FALSE = 0.5  # fraction of failures for StatusUnhealthy

STATUS_UNKNOWN = "Unknown"
STATUS_HEALTHY = "Healthy"
STATUS_UNHEALTHY = "Unhealthy"


class Tracker:
    GUARDED_FIELDS = {"_buffer": "_lock"}

    def __init__(self, capacity: int = BUFFER_SIZE):
        self._lock = make_rlock("nodepool-health")
        self._capacity = capacity
        self._buffer: RingBuffer[bool] = RingBuffer(capacity)

    def update(self, success: bool) -> None:
        with self._lock:
            self._buffer.insert(success)

    def reset(self) -> None:
        with self._lock:
            self._buffer.reset()

    def status(self) -> str:
        with self._lock:
            if len(self._buffer) == 0:
                return STATUS_UNKNOWN
            failures = sum(1 for v in self._buffer.items() if not v)
            if failures / self._capacity >= THRESHOLD_FALSE:
                return STATUS_UNHEALTHY
            return STATUS_HEALTHY

    def set_status(self, status: str) -> None:
        with self._lock:
            self._buffer.reset()
            if status == STATUS_HEALTHY:
                self._buffer.insert(True)
            elif status == STATUS_UNHEALTHY:
                for _ in range(int(self._capacity * THRESHOLD_FALSE)):
                    self._buffer.insert(False)

class NodePoolHealthState:
    """Map of NodePool UID -> Tracker (reference: tracker.go State)."""

    GUARDED_FIELDS = {"_trackers": "_lock"}

    def __init__(self):
        self._lock = make_rlock("nodepool-health")
        self._trackers: dict[str, Tracker] = {}

    def _tracker(self, uid: str) -> Tracker:
        with self._lock:
            return self._trackers.setdefault(uid, Tracker())

    def status(self, uid: str) -> str:
        return self._tracker(uid).status()

    def update(self, uid: str, success: bool) -> None:
        self._tracker(uid).update(success)

    def set_status(self, uid: str, status: str) -> None:
        self._tracker(uid).set_status(status)

    def prune(self, live_uids: set[str]) -> None:
        """Drop trackers for deleted pools so pool churn doesn't leak memory."""
        with self._lock:
            for uid in list(self._trackers):
                if uid not in live_uids:
                    del self._trackers[uid]
