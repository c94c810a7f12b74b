"""solverlint fixture for the port: lock-order over torch. Never imported —
parsed only.

Seeds the torch device syncs made while a lock is held (a blocking call,
like a solve): `torch.cuda.synchronize()` and a stream's or event's
`synchronize()`. The sync after the lock is released and the pragma'd twin
must NOT be flagged.
"""

import threading

import torch


class FixtureSync:
    def __init__(self):
        self._lock = threading.Lock()  # solverlint: ok(bare-thread-primitive): fixture — raw locks keep this file self-contained

    def bad_device_sync(self):
        with self._lock:
            torch.cuda.synchronize()

    def bad_event_sync(self, event):
        with self._lock:
            event.synchronize()

    def ok_sync_outside(self):
        with self._lock:
            pass
        torch.cuda.synchronize()

    def ok_pragma(self):
        with self._lock:
            torch.cuda.synchronize()  # solverlint: ok(lock-order): fixture — proves the pragma form suppresses
