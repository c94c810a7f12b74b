"""The port's metrics registry and event recorder against the reference's.

`karpenter_tpu_torch.metrics` and `.events` are copies of the reference's
modules: the same operations on both registries give the same values and
the same exposition text, `make_registry()` declares the same families
(names, types, help text, label sets, buckets), and the recorders dedupe
alike (`tests/test_metrics_events.py:23-102`). Exact.

`registry_view` is the comparison the solver, provisioner and disruption
parity tests share: every family's samples, the port's backend label "gpu"
read as the reference's "tpu", histograms by their counts only (their sums
are wall times) and the time-valued gauges and the recompile counter left
out (the port's sentinel counts kernel-library loads, not JIT traces).
"""

from __future__ import annotations

import math

import pytest

from karpenter_tpu import events as ref_events
from karpenter_tpu import metrics as ref_metrics
from karpenter_tpu.metrics import registry as ref_registry
from karpenter_tpu.utils.clock import FakeClock as RefClock
from karpenter_tpu_torch import events as port_events
from karpenter_tpu_torch import metrics as port_metrics
from karpenter_tpu_torch.metrics import registry as port_registry
from karpenter_tpu_torch.utils.clock import FakeClock as PortClock

# families whose values are wall times or JIT-specific: compared by presence only
TIMED_GAUGES = frozenset({ref_metrics.SOLVER_SOLVE_QUANTILE_SECONDS, ref_metrics.SOLVER_EVENT_STAGE_QUANTILE_SECONDS})
NOT_COMPARED = frozenset({ref_metrics.SOLVER_RECOMPILE_TOTAL})


def registry_view(reg, port: bool) -> dict:
    """Every family's samples in a form both packages share (module
    docstring)."""
    out = {}
    with reg._lock:
        metrics = list(reg._metrics.values())
    for mt in sorted(metrics, key=lambda x: x.name):
        if mt.name in NOT_COMPARED or mt.name in TIMED_GAUGES:
            continue
        rows = []
        if mt.TYPE == "histogram":
            for labels, _cum, total, _sum in mt.collect():
                rows.append((_labels(labels, port), total))
        else:
            for labels, value in mt.collect():
                rows.append((_labels(labels, port), value))
        out[mt.name] = (mt.TYPE, sorted(rows))
    return out


def _labels(labels: dict, port: bool) -> tuple:
    if port and labels.get("backend") == "gpu":
        labels = {**labels, "backend": "tpu"}
    return tuple(sorted(labels.items()))


def fresh_default_recorders() -> None:
    """Give each package a fresh process-wide trace recorder (an empty
    ring) before a comparison of registries: otherwise the evictions
    (`karpenter_solver_trace_dropped_total`) that earlier tests in the same
    process left in one package's ring and not in the other's would be
    compared too."""
    from karpenter_tpu.obs import trace as ref_trace
    from karpenter_tpu_torch.obs import trace as port_trace

    ref_trace._DEFAULT = ref_trace.TraceRecorder()
    port_trace._DEFAULT = port_trace.TraceRecorder()


def assert_same_registry(port_reg, ref_reg, what: str = "") -> None:
    got, want = registry_view(port_reg, True), registry_view(ref_reg, False)
    assert set(got) == set(want), f"{what}: families {sorted(set(got) ^ set(want))}"
    for name in sorted(want):
        assert got[name] == want[name], f"{what}: {name}: {got[name]} != reference {want[name]}"


# -- the registry (tests/test_metrics_events.py:23-76) ----------------------------

def _counter(Registry):
    r = Registry()
    c = r.counter("test_total", "help", ("a", "b"))
    c.inc(a="x", b="y")
    c.inc(2, a="x", b="y")
    c.inc(a="z")
    return (c.value(a="x", b="y"), c.value(a="z", b=""), c.total()), r.expose()


def _gauge(Registry):
    r = Registry()
    g = r.gauge("test_gauge", "help", ("k",))
    g.set(5, k="a")
    g.add(2, k="a")
    before = g.value(k="a")
    g.reset()
    return (before, g.value(k="a")), r.expose()


def _histogram(Registry):
    r = Registry()
    h = r.histogram("test_seconds", "help", (), buckets=(0.1, 1, 10))
    for v in (0.05, 0.5, 5, 50):
        h.observe(v)
    empty = r.histogram("empty_seconds", "", ())
    return (h.count(), h.sum(), h.percentile(0.5), math.isnan(empty.percentile(0.5))), r.expose()


def _exposition(Registry):
    r = Registry()
    r.counter("karpenter_things_total", "things", ("kind",)).inc(kind="a")
    r.gauge("karpenter_level", "level", ()).set(3)
    r.histogram("karpenter_dur_seconds", "dur", (), buckets=(1, 2)).observe(1.5)
    return None, r.expose()


def _errors(Registry):
    r = Registry()
    r.counter("x_total", "", ())
    caught = []
    try:
        r.gauge("x_total", "", ())
    except TypeError as e:
        caught.append(("TypeError", str(e)))
    c = r.counter("y_total", "", ("a",))
    try:
        c.inc(b="nope")
    except ValueError as e:
        caught.append(("ValueError", str(e)))
    return caught, r.expose()


@pytest.mark.parametrize("case", [_counter, _gauge, _histogram, _exposition, _errors], ids=lambda f: f.__name__[1:])
def test_registry_semantics_match_reference(case):
    """The reference's registry cases on both registries: equal values and
    byte-equal exposition text."""
    got, want = case(port_registry.Registry), case(ref_registry.Registry)
    assert got == want


def test_registry_reference_assertions_hold_on_the_port():
    (xy, z, total), _ = _counter(port_registry.Registry)
    assert (xy, z, total) == (3, 1, 4)
    (count, total_sum, p50, empty_nan), _ = _histogram(port_registry.Registry)
    assert count == 4 and total_sum == 55.55 and p50 in (0.1, 1) and empty_nan
    _, text = _exposition(port_registry.Registry)
    assert 'karpenter_things_total{kind="a"} 1' in text and "karpenter_level 3" in text
    assert 'karpenter_dur_seconds_bucket{le="2"} 1' in text and "karpenter_dur_seconds_count 1" in text
    assert [kind for kind, _ in _errors(port_registry.Registry)[0]] == ["TypeError", "ValueError"]


def test_make_registry_declares_the_reference_families():
    """Every family of `make_registry()`: name, type, help, labels, buckets,
    and the exposition text of the empty registry."""
    got, want = port_metrics.make_registry(), ref_metrics.make_registry()
    assert got.expose() == want.expose()

    def shape(reg):
        return {name: (mt.TYPE, mt.help, mt.label_names, getattr(mt, "buckets", None))
                for name, mt in reg._metrics.items()}

    assert shape(got) == shape(want)
    assert len(shape(got)) > 60


def test_metric_name_constants_match_reference():
    names = {k: v for k, v in vars(ref_metrics).items() if k.isupper() and isinstance(v, (str, tuple))}
    assert names and {k: getattr(port_metrics, k, None) for k in names} == names


def test_registry_view_maps_the_backend_label():
    a, b = port_metrics.make_registry(), ref_metrics.make_registry()
    a.counter(port_metrics.SOLVER_SOLVE_TOTAL).inc(backend="gpu")
    b.counter(ref_metrics.SOLVER_SOLVE_TOTAL).inc(backend="tpu")
    assert_same_registry(a, b)
    a.counter(port_metrics.SOLVER_SOLVE_TOTAL).inc(backend="hybrid")
    with pytest.raises(AssertionError):
        assert_same_registry(a, b)


# -- the event recorder (tests/test_metrics_events.py:86-102) ----------------------

class _Obj:
    def __init__(self, kind, name):
        self.kind = kind
        self.metadata = type("M", (), {"name": name})()


def _dedupe(events, Clock):
    clock = Clock()
    rec = events.Recorder(clock)
    out = [rec.publish(_Obj("NodeClaim", "nc-1"), "Launched", "msg"),
           rec.publish(_Obj("NodeClaim", "nc-1"), "Launched", "msg")]
    clock.step(121)
    out.append(rec.publish(_Obj("NodeClaim", "nc-1"), "Launched", "msg"))
    out.append(rec.publish(_Obj("Node", "n-1"), "A", "m1"))
    out.append(rec.publish(_Obj("Node", "n-1"), "B", "m2"))
    out.append(rec.publish(_Obj("Node", "n-1"), "B", "m2", dedupe_values=("other",)))
    return out, [(e.involved_kind, e.involved_name, e.type, e.reason, e.message, e.timestamp) for e in rec.events], \
        rec.reasons(), [e.reason for e in rec.for_object("n-1")]


def test_recorder_dedupes_as_the_reference():
    got, want = _dedupe(port_events, PortClock), _dedupe(ref_events, RefClock)
    assert got == want
    published, events, reasons, _ = got
    assert published == [True, False, True, True, True, True]
    assert len(events) == 5 and reasons == ["Launched", "Launched", "A", "B", "B"]


def test_recorder_bounds_its_events():
    for events, Clock in ((port_events, PortClock), (ref_events, RefClock)):
        rec = events.Recorder(Clock(), max_events=3)
        for i in range(5):
            rec.publish(_Obj("Pod", f"p{i}"), "R", "m")
        assert [e.involved_name for e in rec.events] == ["p2", "p3", "p4"]
