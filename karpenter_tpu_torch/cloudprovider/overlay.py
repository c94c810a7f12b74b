"""Overlay CloudProvider decorator.

Reference: pkg/cloudprovider/overlay/cloudprovider.go:30-55 — wraps any
CloudProvider and rewrites GetInstanceTypes results through the published
InstanceTypeStore when the NodeOverlay feature gate is on. An unevaluated
pool returns no instance types (the overlay controller will publish shortly
and the provisioner retries), never un-overlaid prices.
"""

from __future__ import annotations


class OverlayCloudProvider:
    def __init__(self, inner, instance_type_store, options):
        self.inner = inner
        self.instance_type_store = instance_type_store
        self.options = options

    def get_instance_types(self, node_pool=None) -> list:
        its = self.inner.get_instance_types(node_pool)
        if node_pool is None or not self.options.feature_gates.node_overlay:
            return its
        from ..controllers.nodeoverlay.store import UnevaluatedNodePoolError

        try:
            return self.instance_type_store.apply_all(node_pool.metadata.name, its)
        except UnevaluatedNodePoolError:
            return []

    # -- pure delegation for the other 8 methods -------------------------------
    def create(self, node_claim):
        return self.inner.create(node_claim)

    def delete(self, node_claim) -> None:
        return self.inner.delete(node_claim)

    def get(self, provider_id: str):
        return self.inner.get(provider_id)

    def list(self) -> list:
        return self.inner.list()

    def is_drifted(self, node_claim) -> str:
        return self.inner.is_drifted(node_claim)

    def repair_policies(self) -> list:
        return self.inner.repair_policies()

    def name(self) -> str:
        return self.inner.name()

    def get_supported_node_classes(self) -> list:
        return self.inner.get_supported_node_classes()

    def __getattr__(self, item):
        # provider-specific extras (e.g. KWOK's flush_pending, instance_types)
        return getattr(self.inner, item)
