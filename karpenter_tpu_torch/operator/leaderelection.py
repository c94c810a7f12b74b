"""Lease-based leader election: exactly-one-active controller semantics.

Reference: operator.go:171-202 — controller-runtime's leases resource lock
with release-on-cancel, a dedicated low-QPS leader client (here: the store's
optimistic concurrency IS the rate-independent path), and controller warmup:
informers populate caches before leadership is won so failover is fast.
"""

from __future__ import annotations

from ..kube import Lease, NotFound, ObjectMeta
from ..kube.store import AlreadyExists, Conflict
from ..obs.racecheck import make_lock

DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_DEADLINE = 10.0
DEFAULT_RETRY_PERIOD = 2.0


class LeaderElector:
    # racecheck guarded-field registry: the renew loop runs on its own
    # thread while the controller round reads is_leader() — the pair must
    # change together or a leader can act on a renewed flag with a stale
    # renew timestamp (or vice versa)
    GUARDED_FIELDS = {"_leading": "_lock", "_last_renew": "_lock"}

    def __init__(
        self,
        store,
        clock,
        identity: str,
        lease_name: str = "karpenter-leader-election",
        namespace: str = "kube-system",
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_deadline: float = DEFAULT_RENEW_DEADLINE,
        retry_period: float = DEFAULT_RETRY_PERIOD,
    ):
        self.store = store
        self.clock = clock
        self.identity = identity
        self.lease_name = lease_name
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._lock = make_lock("leader")
        self._last_renew = 0.0
        self._leading = False

    def is_leader(self) -> bool:
        """Leading AND renewed within the renew deadline — a leader whose
        renewals have been failing must stop acting before a standby can
        legitimately take over (client-go renewDeadline semantics)."""
        now = self.clock.now()
        with self._lock:
            if not self._leading:
                return False
            return now - self._last_renew <= self.renew_deadline

    def renew_loop(self, stop_event) -> None:
        """Background renewal every retry_period, decoupled from controller
        rounds so a long reconcile can't starve the lease into a takeover
        (client-go renews on its own goroutine)."""
        while not stop_event.is_set():
            self.try_acquire_or_renew()
            stop_event.wait(self.retry_period)

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns whether this instance now leads
        (client-go leaderelection tryAcquireOrRenew semantics)."""
        now = self.clock.now()
        try:
            lease = self.store.get("Lease", self.lease_name, self.namespace)
        except NotFound:
            lease = Lease(
                metadata=ObjectMeta(name=self.lease_name, namespace=self.namespace),
                holder_identity=self.identity,
                lease_duration_seconds=int(self.lease_duration),
                acquire_time=now,
                renew_time=now,
            )
            try:
                self.store.create(lease)
                self._set_leading(True, now)
                return True
            except AlreadyExists:  # lost the creation race
                return self._retry_observe()

        expired = now - lease.renew_time > self.lease_duration
        if lease.holder_identity == self.identity:
            return self._renew(lease, now)
        if not expired:
            self._set_leading(False)
            return False
        # takeover: the previous holder's lease lapsed
        def apply(obj):
            if obj.holder_identity != lease.holder_identity or obj.renew_time != lease.renew_time:
                raise Conflict("lease changed under takeover")
            obj.holder_identity = self.identity
            obj.acquire_time = now
            obj.renew_time = now
            obj.lease_transitions += 1

        try:
            self.store.patch("Lease", self.lease_name, apply, namespace=self.namespace, retries=1)
            self._set_leading(True, now)
            return True
        except (Conflict, NotFound):
            self._set_leading(False)
            return False

    def _set_leading(self, leading: bool, renewed_at: float | None = None) -> None:
        with self._lock:
            self._leading = leading
            if renewed_at is not None:
                self._last_renew = renewed_at

    def _renew(self, lease, now: float) -> bool:
        def apply(obj):
            if obj.holder_identity != self.identity:
                raise Conflict("lost leadership")
            obj.renew_time = now

        try:
            self.store.patch("Lease", self.lease_name, apply, namespace=self.namespace, retries=1)
            self._set_leading(True, now)
            return True
        except (Conflict, NotFound):
            self._set_leading(False)
            return False

    def _retry_observe(self) -> bool:
        lease = self.store.try_get("Lease", self.lease_name, self.namespace)
        leading = lease is not None and lease.holder_identity == self.identity
        self._set_leading(leading)
        return leading

    def release(self) -> None:
        """ReleaseOnCancel: fast failover on graceful shutdown. Writes only
        when this instance still holds the lease — a stale loser patching the
        lease could Conflict the new leader's renewal."""
        with self._lock:
            if not self._leading:
                return
            self._leading = False
        current = self.store.try_get("Lease", self.lease_name, self.namespace)
        if current is None or current.holder_identity != self.identity:
            return

        def apply(obj):
            if obj.holder_identity != self.identity:
                raise Conflict("no longer the holder")
            obj.holder_identity = ""
            obj.renew_time = 0.0

        try:
            self.store.patch("Lease", self.lease_name, apply, namespace=self.namespace, retries=1)
        except (Conflict, NotFound):
            pass
