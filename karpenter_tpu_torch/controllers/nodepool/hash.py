"""NodePool drift-hash controller.

Reference: pkg/controllers/nodepool/hash/controller.go:66-129 — stamps the
static-drift hash + hash-version annotations on each NodePool, and when the
hash *version* changes (a breaking change to the hash computation), re-stamps
every non-drifted NodeClaim of the pool so stale hashes don't read as drift.
"""

from __future__ import annotations

from ...apis import labels as wk
from ...apis.nodeclaim import COND_DRIFTED

# Bump when the fields included in NodePool.hash() change incompatibly
# (reference: nodepool.go:334 NodePoolHashVersion).
NODEPOOL_HASH_VERSION = "v1"


class NodePoolHashController:
    def __init__(self, store):
        self.store = store

    def reconcile(self) -> None:
        for np in self.store.list("NodePool"):
            if np.metadata.annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY) != NODEPOOL_HASH_VERSION:
                self._update_node_claim_hashes(np)
            want = {
                wk.NODEPOOL_HASH_ANNOTATION_KEY: np.hash(),
                wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY: NODEPOOL_HASH_VERSION,
            }
            if any(np.metadata.annotations.get(k) != v for k, v in want.items()):
                def apply(obj, want=want):
                    obj.metadata.annotations.update(want)

                self.store.patch("NodePool", np.metadata.name, apply)

    def _update_node_claim_hashes(self, np) -> None:
        """hash/controller.go:96-129: on hash-version change, adopt the pool's
        new hash onto claims — except claims already Drifted, which stay
        drifted (we can no longer tell whether they've un-drifted)."""
        for nc in self.store.list("NodeClaim"):
            if nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY) != np.metadata.name:
                continue
            if nc.metadata.annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY) == NODEPOOL_HASH_VERSION:
                continue

            def apply(obj, np=np):
                obj.metadata.annotations[wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = NODEPOOL_HASH_VERSION
                if obj.status.conditions.get(COND_DRIFTED) is None:
                    obj.metadata.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = np.hash()

            self.store.patch("NodeClaim", nc.metadata.name, apply)
