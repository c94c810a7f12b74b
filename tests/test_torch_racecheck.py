"""The port's concurrency sanitizer (`karpenter_tpu_torch/obs/racecheck.py`),
the reference's runtime arm copied: `tests/test_racecheck.py`'s cases with
no serving or operator in them, on the port's module — off-mode parity
(plain `threading` primitives), the instrumented lock, the dynamic
lock-order graph, guarded-field touches, wait and hold observability — and
the port's own host stack under the sanitizer (the suite runs with
KARPENTER_SOLVER_RACECHECK=1): a provisioning pass and a disruption round
record no violation, and the port's named locks were observed.
"""

from __future__ import annotations

import threading
import time

import pytest

from karpenter_tpu_torch.obs import racecheck
from karpenter_tpu_torch.obs.racecheck import (
    InstrumentedLock,
    RaceCheckError,
    make_event,
    make_lock,
    make_rlock,
    racecheck_enabled,
    spawn_thread,
    touch,
)


@pytest.fixture(autouse=True)
def _clean_graph():
    # each test starts from an empty order graph; the suite-wide graph the
    # other suites accumulate is not this file's subject
    racecheck.reset()
    yield
    racecheck.reset()


class TestFactoryParity:
    def test_off_mode_returns_plain_primitives(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_SOLVER_RACECHECK", "0")
        racecheck._refresh()
        try:
            assert isinstance(make_lock("x"), type(threading.Lock()))
            assert isinstance(make_rlock("x"), type(threading.RLock()))
        finally:
            racecheck._refresh()

    def test_on_mode_returns_instrumented(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_SOLVER_RACECHECK", "1")
        racecheck._refresh()
        try:
            lk = make_lock("x")
            assert isinstance(lk, InstrumentedLock)
            with lk:
                assert lk.held_by_me and lk.locked()
            assert not lk.locked()
        finally:
            racecheck._refresh()

    def test_event_and_thread_wrappers(self):
        ev = make_event()
        hits = []
        t = spawn_thread(lambda: (ev.wait(5), hits.append(1)), name="racecheck-test")
        ev.set()
        t.join(timeout=5)
        assert hits == [1]

    def test_conftest_enables_sanitizer(self):
        assert racecheck_enabled()


class TestInstrumentedLock:
    def test_with_and_acquire_release(self):
        lk = InstrumentedLock("t-basic")
        with lk:
            assert lk.held_by_me
        assert lk.acquire()
        lk.release()

    def test_non_reentrant_relock_raises_instead_of_deadlocking(self):
        lk = InstrumentedLock("t-relock")
        with lk:
            with pytest.raises(RaceCheckError, match="re-acquired"):
                lk.acquire()

    def test_reentrant_rlock_allows_and_records_no_self_edge(self):
        lk = InstrumentedLock("t-rlock", reentrant=True)
        with lk:
            with lk:
                assert lk.held_by_me
        assert not lk.locked()
        assert racecheck.snapshot()["edges"] == {}

    def test_foreign_release_raises(self):
        lk = InstrumentedLock("t-foreign")
        lk.acquire()
        err = []
        t = spawn_thread(lambda: err.append(isinstance(_try_release(lk), RaceCheckError)))
        t.join(timeout=5)
        lk.release()
        assert err == [True]


def _try_release(lk):
    try:
        lk.release()
    except Exception as e:  # noqa: BLE001
        return e
    return None


class TestLockOrder:
    def test_direct_inversion_raises(self):
        a, b = InstrumentedLock("t-a"), InstrumentedLock("t-b")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(RaceCheckError, match="inversion"):
                with a:
                    pass
        assert racecheck.snapshot()["violations"]

    def test_transitive_cycle_raises(self):
        # a->b, b->c, then c->a: no directly reversed edge anywhere, but the
        # closure is a cycle — the reachability check must catch it
        a, b, c = InstrumentedLock("t-x"), InstrumentedLock("t-y"), InstrumentedLock("t-z")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with pytest.raises(RaceCheckError, match="inversion"):
                with a:
                    pass

    def test_consistent_order_is_clean(self):
        a, b = InstrumentedLock("t-c1"), InstrumentedLock("t-c2")
        for _ in range(3):
            with a:
                with b:
                    pass
        snap = racecheck.snapshot()
        assert ("t-c1", "t-c2") in snap["edges"]
        assert snap["violations"] == []

    def test_same_name_nesting_records_no_edge(self):
        # two instances of one lock CLASS share a graph node; nesting them
        # is not an order relation (e.g. two different metric objects)
        a, b = InstrumentedLock("t-same"), InstrumentedLock("t-same")
        with a:
            with b:
                pass
        assert racecheck.snapshot()["edges"] == {}


class TestGuardedFields:
    class Stats:
        GUARDED_FIELDS = {"hits": "_lock"}

        def __init__(self):
            self._lock = InstrumentedLock("t-stats")
            self.hits = 0

    def test_touch_without_lock_raises(self):
        s = self.Stats()
        with pytest.raises(RaceCheckError, match="without holding"):
            touch(s, "hits")

    def test_touch_with_lock_passes(self):
        s = self.Stats()
        with s._lock:
            touch(s, "hits")
            s.hits += 1
        assert racecheck.snapshot()["touch_checks"] >= 1

    def test_undeclared_field_raises(self):
        s = self.Stats()
        with pytest.raises(RaceCheckError, match="not declared"):
            touch(s, "nope")


class TestObservability:
    def test_wait_stats_and_histogram(self):
        from karpenter_tpu_torch import metrics as m

        reg = m.make_registry()
        racecheck.set_metrics_registry(reg)
        try:
            lk = InstrumentedLock("t-wait")
            with lk:
                pass
            snap = racecheck.snapshot()
            assert snap["wait"]["t-wait"][0] >= 1
            assert reg.histogram(m.SOLVER_LOCK_WAIT_SECONDS).count(lock="t-wait") >= 1
        finally:
            racecheck.set_metrics_registry(None)

    def test_hold_outlier_recorded(self, monkeypatch):
        monkeypatch.setattr(racecheck, "_HOLD_OUTLIER_SECONDS", 0.0)
        lk = InstrumentedLock("t-hold")
        with lk:
            time.sleep(0.002)
        outliers = racecheck.snapshot()["hold_outliers"]
        assert outliers and outliers[0][0] == "t-hold" and outliers[0][1] > 0




class TestPortStack:
    def test_provisioning_and_disruption_record_no_violation(self):
        """A provisioning pass with watch delivery on a second thread, and a
        disruption round, on the port's objects under the sanitizer."""
        import torch

        from test_torch_disruption import Pair, fleet_env
        from test_torch_provisioner import Pair as ProvPair
        from test_torch_provisioner import mixed_pods, pool

        torch.set_num_threads(1)
        assert racecheck_enabled()
        pair = ProvPair([pool()] + mixed_pods(), metrics=True)
        side = pair.port
        done = threading.Event()

        def writer():
            for i in range(20):
                side.store.patch("Pod", "p0", lambda p: p.metadata.annotations.__setitem__("n", str(i)))
            done.set()

        t = spawn_thread(writer, name="writer")
        pair.reconcile(force=True)
        t.join(timeout=60)
        assert done.is_set()
        dpair = Pair(fleet_env(4), metrics=True)
        dpair.flip()
        dpair.reconcile()
        snap = racecheck.snapshot()
        assert snap["violations"] == [], snap["violations"]
        assert {"store", "cluster", "batcher", "trace", "metric"} <= set(snap["wait"])
