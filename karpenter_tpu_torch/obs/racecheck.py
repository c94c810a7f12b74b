"""Lock factories of the host object model.

The store, the cluster mirror and the fake clock construct their locks
through `make_lock` / `make_rlock`. The reference's runtime concurrency
sanitizer (an instrumented lock behind KARPENTER_SOLVER_RACECHECK=1) is not
part of the port: these return the plain `threading` locks, which is what
the reference returns with the sanitizer off.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A mutex for the named lock class."""
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of `make_lock`."""
    return threading.RLock()
