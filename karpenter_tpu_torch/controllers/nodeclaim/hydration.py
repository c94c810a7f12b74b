"""NodeClaim hydration controller.

Reference: pkg/controllers/nodeclaim/hydration/controller.go — backfills
fields added in newer versions onto pre-existing NodeClaims after an upgrade.
Currently: the node-class label (<group>/<kind-lowercase> = class name).
"""

from __future__ import annotations


def node_class_label_key(group: str, kind: str) -> str:
    return f"{group}/{kind.lower()}"


class HydrationController:
    def __init__(self, store):
        self.store = store

    def reconcile(self) -> None:
        for nc in self.store.list("NodeClaim"):
            ref = nc.spec.node_class_ref
            key = node_class_label_key(ref.group, ref.kind)
            if nc.metadata.labels.get(key) == ref.name:
                continue

            def apply(obj, key=key, name=ref.name):
                obj.metadata.labels[key] = name

            self.store.patch("NodeClaim", nc.metadata.name, apply)
