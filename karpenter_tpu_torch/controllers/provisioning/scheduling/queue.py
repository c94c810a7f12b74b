"""FFD pod queue (reference: scheduling/queue.go:31-108).

Pods are sorted CPU-descending then memory-descending (first-fit-decreasing);
Pop stops when the queue cycles without progress.

Cycle detection keys `_last_len` by pod uid. The scheduler's relaxation loop
(`Scheduler._try_schedule`) deep-copies the pod before mutating its spec and
REQUEUES THE CALLER'S ORIGINAL — `copy.deepcopy` preserves `metadata.uid`, so
either object maps to the same `_last_len` slot and a pod that exhausts every
relaxation (twice-relaxed or more) still terminates the queue: its re-push
records the queue length, and the next pop at an unchanged length returns
None instead of spinning (regression: tests/test_ffd_batch.py).
"""

from __future__ import annotations


from collections import deque


class Queue:
    def __init__(self, pods: list, pod_data: dict):
        self.pods = deque(sorted(pods, key=lambda p: _sort_key(p, pod_data)))
        self._last_len: dict[str, int] = {}

    def pop(self):
        if not self.pods:
            return None
        p = self.pods[0]
        if self._last_len.get(p.metadata.uid) == len(self.pods):
            return None  # cycled through with no progress
        self.pods.popleft()
        return p

    def push(self, pod) -> None:
        self.pods.append(pod)
        self._last_len[pod.metadata.uid] = len(self.pods)

    def list(self) -> list:
        return list(self.pods)


def _sort_key(pod, pod_data):
    req = pod_data[pod.metadata.uid].requests
    cpu = req.get("cpu")
    mem = req.get("memory")
    return (
        -(cpu.milli if cpu else 0),
        -(mem.milli if mem else 0),
        pod.metadata.creation_timestamp,
        pod.metadata.uid,
    )
