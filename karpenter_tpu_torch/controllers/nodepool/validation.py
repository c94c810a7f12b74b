"""NodePool runtime-validation controller.

Reference: pkg/controllers/nodepool/validation/controller.go:59-82 — runs
RuntimeValidate on each NodePool and sets the ValidationSucceeded condition.
The provisioner skips pools that fail validation.
"""

from __future__ import annotations

from ...apis.nodepool import COND_NODEPOOL_VALIDATION_SUCCEEDED
from ...apis.validation import runtime_validate


class NodePoolValidationController:
    def __init__(self, store, clock):
        self.store = store
        self.clock = clock

    def reconcile(self) -> None:
        for np in self.store.list("NodePool"):
            errs = runtime_validate(np)
            conds = np.status.conditions
            if errs:
                changed = conds.set_false(
                    COND_NODEPOOL_VALIDATION_SUCCEEDED, "NodePoolValidationFailed", "; ".join(errs), now=self.clock.now()
                )
            else:
                changed = conds.set_true(COND_NODEPOOL_VALIDATION_SUCCEEDED, now=self.clock.now())
            if changed:
                self.store.update_status(np)
