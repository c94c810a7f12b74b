"""Reserved-offering capacity accounting for one scheduling solve.

Reference: scheduling/reservationmanager.go:29-120 — reserved offerings
(`karpenter.sh/capacity-type: reserved`) carry a finite ReservationCapacity;
during a single solve every in-flight NodeClaim pessimistically reserves all
compatible reserved offerings so that two claims can never oversubscribe one
reservation, and releases reservations that later requirement-narrowing (or
relaxation re-runs) filtered out.

Used by the host FFD scheduler per claim (nodeclaim.go:303-350
offeringsToReserve) and by the TPU decode as the host-side cap over device
placements (SURVEY.md §7 "Reserved offerings ... keep host-side").
"""

from __future__ import annotations

from ....apis import labels as wk


class ReservationManager:
    def __init__(self, instance_types: dict[str, list]):
        capacity: dict[str, int] = {}
        for its in instance_types.values():
            for it in its:
                for o in it.offerings:
                    if o.capacity_type() != wk.CAPACITY_TYPE_RESERVED:
                        continue
                    rid = o.reservation_id()
                    # multiple nodepools can reference one reservation with the
                    # capacity updated between GetInstanceTypes calls: track
                    # the smallest (reservationmanager.go:40-45)
                    cur = capacity.get(rid)
                    if cur is None or cur > o.reservation_capacity:
                        capacity[rid] = o.reservation_capacity
        self.capacity = capacity
        self.reservations: dict[str, set[str]] = {}  # hostname -> reservation ids

    def can_reserve(self, hostname: str, offering) -> bool:
        """Idempotent: True if this hostname already holds the reservation or
        capacity remains."""
        rid = offering.reservation_id()
        held = self.reservations.get(hostname)
        if held and rid in held:
            return True
        return self.capacity.get(rid, 0) > 0

    def reserve(self, hostname: str, *offerings) -> None:
        """Idempotent per (hostname, reservation id)."""
        for o in offerings:
            rid = o.reservation_id()
            held = self.reservations.setdefault(hostname, set())
            if rid in held:
                continue
            remaining = self.capacity.get(rid, 0)
            if remaining <= 0:
                raise RuntimeError(f"attempted to over-reserve offering with reservation id {rid!r}")
            self.capacity[rid] = remaining - 1
            held.add(rid)

    def release(self, hostname: str, *offerings) -> None:
        """No-op for offerings the hostname never reserved."""
        held = self.reservations.get(hostname)
        if not held:
            return
        for o in offerings:
            rid = o.reservation_id()
            if rid in held:
                held.discard(rid)
                self.capacity[rid] = self.capacity.get(rid, 0) + 1

    def has_reservation(self, hostname: str, offering) -> bool:
        held = self.reservations.get(hostname)
        return bool(held) and offering.reservation_id() in held

    def remaining_capacity(self, offering) -> int:
        return self.capacity.get(offering.reservation_id(), 0)
