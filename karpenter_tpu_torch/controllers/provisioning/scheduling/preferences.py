"""Preference relaxation (reference: scheduling/preferences.go:30-140).

When a pod fails to schedule, soft constraints are peeled off one per attempt,
in order: required node-affinity OR-terms (beyond the first), preferred pod
affinity, preferred pod anti-affinity, preferred node affinity, ScheduleAnyway
topology spreads, and optionally PreferNoSchedule tolerations.
"""

from __future__ import annotations

from ....scheduling.taints import PREFER_NO_SCHEDULE, Toleration


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod) -> bool:
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity,
            self._remove_preferred_pod_anti_affinity,
            self._remove_preferred_node_affinity,
            self._remove_schedule_anyway_spread,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule)
        for fn in relaxations:
            if fn(pod):
                return True
        return False

    @staticmethod
    def _remove_required_node_affinity_term(pod) -> bool:
        aff = pod.spec.affinity.node_affinity if pod.spec.affinity else None
        if aff is None or len(aff.required) <= 1:
            return False  # OR-terms: can drop all but the last
        aff.required = aff.required[1:]
        return True

    @staticmethod
    def _remove_preferred_node_affinity(pod) -> bool:
        aff = pod.spec.affinity.node_affinity if pod.spec.affinity else None
        if aff is None or not aff.preferred:
            return False
        aff.preferred = sorted(aff.preferred, key=lambda t: -t.weight)[1:]
        return True

    @staticmethod
    def _remove_preferred_pod_affinity(pod) -> bool:
        aff = pod.spec.affinity
        if aff is None or not aff.pod_affinity_preferred:
            return False
        aff.pod_affinity_preferred = sorted(aff.pod_affinity_preferred, key=lambda t: -t.weight)[1:]
        return True

    @staticmethod
    def _remove_preferred_pod_anti_affinity(pod) -> bool:
        aff = pod.spec.affinity
        if aff is None or not aff.pod_anti_affinity_preferred:
            return False
        aff.pod_anti_affinity_preferred = sorted(aff.pod_anti_affinity_preferred, key=lambda t: -t.weight)[1:]
        return True

    @staticmethod
    def _remove_schedule_anyway_spread(pod) -> bool:
        for i, tsc in enumerate(pod.spec.topology_spread_constraints):
            if tsc.when_unsatisfiable == "ScheduleAnyway":
                pod.spec.topology_spread_constraints.pop(i)
                return True
        return False

    @staticmethod
    def _tolerate_prefer_no_schedule(pod) -> bool:
        tol = Toleration(operator="Exists", effect=PREFER_NO_SCHEDULE)
        existing = [t if isinstance(t, Toleration) else Toleration.from_dict(t) for t in pod.spec.tolerations or []]
        if any(t.operator == "Exists" and t.effect == PREFER_NO_SCHEDULE and not t.key for t in existing):
            return False
        pod.spec.tolerations = list(pod.spec.tolerations or []) + [tol]
        return True
