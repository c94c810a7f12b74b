"""Informer wiring: store watch events -> Cluster state updates.

Reference: pkg/controllers/state/informer/{pod,node,nodeclaim,nodepool,
daemonset}.go — each is a tiny reconciler keeping the Cluster mirror fresh.
"""

from __future__ import annotations

from .cluster import Cluster


def start_informers(store, cluster: Cluster) -> None:
    """Subscribe the cluster mirror to all relevant kinds."""

    def on_node(event: str, node) -> None:
        if event == "DELETED":
            cluster.delete_node(node.metadata.name)
        else:
            cluster.update_node(node)

    def on_node_claim(event: str, nc) -> None:
        if event == "DELETED":
            cluster.delete_node_claim(nc.metadata.name)
        else:
            cluster.update_node_claim(nc)

    def on_pod(event: str, pod) -> None:
        if event == "DELETED":
            cluster.delete_pod(pod.key())
        else:
            cluster.update_pod(pod)

    def on_change(event: str, obj) -> None:
        cluster.mark_unconsolidated()

    def on_csi_node(event: str, csi) -> None:
        # CSI drivers typically publish limits AFTER the node registers;
        # re-apply on every CSINode event so late/updated limits take effect
        if event != "DELETED":
            cluster.apply_csi_node(csi)

    store.watch("Node", on_node)
    store.watch("NodeClaim", on_node_claim)
    store.watch("Pod", on_pod)
    store.watch("NodePool", on_change)
    store.watch("DaemonSet", on_change)
    store.watch("CSINode", on_csi_node)

    # replay current contents so late-started informers converge (cluster.Reset)
    for nc in store.list("NodeClaim"):
        cluster.update_node_claim(nc)
    for node in store.list("Node"):
        cluster.update_node(node)
    for pod in store.list("Pod"):
        cluster.update_pod(pod)
