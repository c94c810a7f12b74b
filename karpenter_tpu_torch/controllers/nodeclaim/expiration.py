"""NodeClaim expiration controller.

Reference: pkg/controllers/nodeclaim/expiration/controller.go — forcefully
deletes NodeClaims older than spec.expireAfter. Expiration is absolute: it
does not wait for replacement capacity (the provisioner reprovisions for the
evicted pods afterwards).
"""

from __future__ import annotations

import math


class ExpirationController:
    def __init__(self, store, clock, metrics=None):
        self.store = store
        self.clock = clock
        self.metrics = metrics

    def reconcile(self) -> None:
        for nc in self.store.list("NodeClaim"):
            if nc.metadata.deletion_timestamp is not None:
                continue
            expire_after = nc.spec.expire_after
            if expire_after is None or expire_after == math.inf:
                continue
            if self.clock.now() < nc.metadata.creation_timestamp + expire_after:
                continue
            self.store.try_delete("NodeClaim", nc.metadata.name)
            if self.metrics is not None:
                from ... import metrics as m
                from ...apis import labels as wk

                self.metrics.counter(m.NODECLAIMS_DISRUPTED_TOTAL).inc(
                    reason="expired",
                    nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                    capacity_type=nc.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY, ""),
                )
