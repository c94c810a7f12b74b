"""PodDisruptionBudget limits (reference: pkg/utils/pdb): can a pod be
evicted without violating any covering PDB?"""

from __future__ import annotations

from ..kube.objects import match_label_selector
from ..utils import pods as pod_utils


class PDBLimits:
    """Stateful like the eviction API: each allowed eviction consumes budget,
    so a drain loop cannot evict a whole priority group past the PDB."""

    def __init__(self, store):
        self.store = store
        self.pdbs = store.list("PodDisruptionBudget")
        self._pods = None
        self._consumed: dict[str, int] = {}  # pdb key -> evictions granted

    def _healthy_matching(self, pdb) -> list:
        if self._pods is None:
            self._pods = [p for p in self.store.list("Pod") if pod_utils.is_active(p)]
        return [
            p
            for p in self._pods
            if p.metadata.namespace == pdb.metadata.namespace and match_label_selector(pdb.selector, p.metadata.labels)
        ]

    def _allowed_disruptions(self, pdb) -> int:
        total = len(self._healthy_matching(pdb))
        allowed = total
        if pdb.min_available is not None:
            allowed = min(allowed, total - _scaled(pdb.min_available, total))
        if pdb.max_unavailable is not None:
            allowed = min(allowed, _scaled(pdb.max_unavailable, total))
        return max(0, allowed)

    def can_evict(self, pod) -> tuple[bool, str | None]:
        """(allowed, blocking pdb name). Does NOT consume budget — callers
        actually evicting must call note_eviction()."""
        for pdb in self.pdbs:
            if pdb.metadata.namespace != pod.metadata.namespace:
                continue
            if not match_label_selector(pdb.selector, pod.metadata.labels):
                continue
            key = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
            if self._allowed_disruptions(pdb) - self._consumed.get(key, 0) < 1:
                return False, pdb.metadata.name
        return True, None

    def note_eviction(self, pod) -> None:
        for pdb in self.pdbs:
            if pdb.metadata.namespace != pod.metadata.namespace:
                continue
            if not match_label_selector(pdb.selector, pod.metadata.labels):
                continue
            key = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
            self._consumed[key] = self._consumed.get(key, 0) + 1


def _scaled(value, total: int) -> int:
    if isinstance(value, str) and value.endswith("%"):
        import math

        return math.ceil(int(value[:-1]) * total / 100)
    return int(value)
