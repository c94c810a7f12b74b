"""Fake DRA driver: publish ResourceSlices for nodes from a DRAConfig.

Reference: dra-kwok-driver/ — a standalone binary watching a DRAConfig CRD and
creating ResourceSlices for matching (KWOK) nodes so DRA flows can run without
real device plugins. Here it's an in-process controller: each registered node
matching a config's node selector gets one slice per config; slices for gone
nodes are garbage-collected.
"""

from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass, field

from ...apis import labels as wk
from ...kube.objects import ObjectMeta, ResourceSlice, match_label_selector


@dataclass
class DRAConfig:
    """Which devices to fake onto which nodes
    (dra-kwok-driver/pkg/apis DRAConfig)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    driver: str = "fake.dra.karpenter.sh"
    node_selector: dict | None = None  # metav1 label selector; None = all nodes
    devices: list = field(default_factory=list)  # [kube.objects.Device]
    kind: str = "DRAConfig"


class DRAKwokDriver:
    def __init__(self, store):
        self.store = store

    def reconcile(self) -> None:
        configs = self.store.list("DRAConfig")
        nodes = [
            n
            for n in self.store.list("Node")
            if n.metadata.labels.get(wk.NODE_REGISTERED_LABEL_KEY) == "true"
            and n.metadata.deletion_timestamp is None
        ]
        # key on the (node, config) PAIR, not the joined name: names built as
        # f"{node}-{config}" collide across distinct pairs when the parts
        # contain dashes ("a-b"+"c" vs "a"+"b-c"); the pair rides in labels
        # and a short digest keeps the object name unique
        want: dict[tuple[str, str], tuple] = {}
        for cfg in configs:
            for node in nodes:
                if cfg.node_selector is not None and not match_label_selector(cfg.node_selector, node.metadata.labels):
                    continue
                want[(node.metadata.name, cfg.metadata.name)] = (cfg, node)
        have: dict[tuple[str, str], ResourceSlice] = {}
        for sl in self.store.list("ResourceSlice"):
            cfg_name = sl.metadata.labels.get("dra.karpenter.sh/config")
            if cfg_name:
                have[(sl.metadata.labels.get("dra.karpenter.sh/node", sl.node_name), cfg_name)] = sl
        for (node_name, cfg_name), (cfg, node) in want.items():
            existing = have.get((node_name, cfg_name))
            if existing is None:
                digest = hashlib.sha1(f"{node_name}\x00{cfg_name}".encode()).hexdigest()[:8]
                self.store.create(
                    ResourceSlice(
                        metadata=ObjectMeta(
                            name=f"{node_name}-{cfg_name}-{digest}",
                            labels={"dra.karpenter.sh/config": cfg_name, "dra.karpenter.sh/node": node_name},
                        ),
                        driver=cfg.driver,
                        pool_name=node.metadata.name,
                        node_name=node.metadata.name,
                        devices=copy.deepcopy(cfg.devices),
                    )
                )
            elif existing.devices != cfg.devices or existing.driver != cfg.driver:
                # config edits must reach already-published slices

                def apply(sl, cfg=cfg):
                    sl.driver = cfg.driver
                    sl.devices = copy.deepcopy(cfg.devices)
                    sl.pool_generation += 1

                self.store.patch("ResourceSlice", existing.metadata.name, apply)
        for key, sl in have.items():
            if key not in want:
                self.store.try_delete("ResourceSlice", sl.metadata.name)
