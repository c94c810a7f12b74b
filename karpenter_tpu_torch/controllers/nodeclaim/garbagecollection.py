"""NodeClaim garbage collection (reference: nodeclaim/garbagecollection):
deletes claims whose cloud instance disappeared, and cloud instances with no
claim (leak protection).
"""

from __future__ import annotations

from ...cloudprovider.errors import NodeClaimNotFoundError
from .lifecycle import _node_ready


class GarbageCollectionController:
    def __init__(self, store, cluster, cloud_provider, clock):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock

    def reconcile(self) -> None:
        claims = self.store.list("NodeClaim")
        by_pid = {nc.status.provider_id: nc for nc in claims if nc.status.provider_id}
        nodes_by_pid = {n.spec.provider_id: n for n in self.store.list("Node") if n.spec.provider_id}

        # claims whose instance is gone -> delete claim, UNLESS the node is
        # there and Ready (controller.go:97-100: a Ready node means the
        # kubelet still runs, so "instance gone" is a transient cloud blip).
        # Unregistered claims are the liveness controller's case and are
        # filtered above, matching the registered-only scan.
        for nc in claims:
            if not nc.status.provider_id or not nc.is_registered():
                continue
            if nc.metadata.deletion_timestamp is not None:
                continue
            node = nodes_by_pid.get(nc.status.provider_id)
            if node is not None and _node_ready(node):
                continue
            try:
                self.cloud_provider.get(nc.status.provider_id)
            except NodeClaimNotFoundError:
                self.store.try_delete("NodeClaim", nc.metadata.name)

        # cloud instances with no claim -> delete instance (leaked)
        for cloud_nc in self.cloud_provider.list():
            if cloud_nc.status.provider_id not in by_pid:
                try:
                    self.cloud_provider.delete(cloud_nc)
                except NodeClaimNotFoundError:
                    pass
