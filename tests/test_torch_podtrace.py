"""The port's event-lifecycle tracer (`obs/podtrace.py`) against the
reference's, on the CPU.

The same watch events, dispatches and solve completions go through both
packages' `PodTracer`s under one fake clock (each module's `time` replaced
by a counter the test steps): the dumps — every record with its stage
decomposition, the per-stage quantiles, the SLO budget and its breach
counter, the wake causes — are equal, exactly. Then the reference's own
cases (`tests/test_podtrace.py:73-230, :315-368`) on the port: the additive
decomposition, cancel and bind paths, errored records, the ring, the SLO
burn, the self-time meter, the Perfetto tracks with their flow arrows, the
event dump forms and the CLI. The provisioner's event-batch note is in
`test_torch_provisioner.test_podtracer_stamps_dispatch_and_solve`.
"""

from __future__ import annotations

import json
import time
import types

import pytest

from helpers import make_pod
from karpenter_tpu import metrics as ref_metrics
from karpenter_tpu.obs import podtrace as ref_podtrace
from karpenter_tpu_torch import metrics as m
from karpenter_tpu_torch.obs import podtrace
from karpenter_tpu_torch.obs.export import events_to_trace_events, parse_event_dump
from karpenter_tpu_torch.obs.podtrace import STAGES, PodTracer, reset_tenants
from karpenter_tpu_torch.testing.carry_over import carry_objects
from test_torch_metrics import assert_same_registry


@pytest.fixture(autouse=True)
def _fresh_tenant_surfaces():
    reset_tenants()
    yield
    reset_tenants()


class _Claim:
    def __init__(self, pods):
        self.pods = pods


class _Results:
    def __init__(self, pods, errors=None):
        self.new_node_claims = [_Claim(pods)]
        self.existing_nodes = []
        self.pod_errors = errors or {}


def _deliver(tracer, pod, event: str = "ADDED"):
    now = time.monotonic()
    tracer.on_delivery(event, pod, now, now)


def _complete(tracer, pods, solve_seq: int = 1):
    tracer.on_dispatch(pods)
    tracer.on_solved(_Results(pods), solve_seq=solve_seq)


def _pod(name):
    pod = make_pod(name=name)
    pod.metadata.uid = f"uid-{name}"
    return pod


# -- both packages under one fake clock ----------------------------------------------

class FakeTime:
    """`time` for the podtrace modules: monotonic, perf_counter and wall
    clock all read one counter the scenario steps."""

    def __init__(self):
        self.t = 1000.0

    def step(self, dt: float) -> None:
        self.t += dt

    def module(self):
        return types.SimpleNamespace(monotonic=lambda: self.t, perf_counter=lambda: self.t, time=lambda: self.t)


def _lifecycle(tr, pods, clock):
    a, b, c, gone = pods
    for p in (a, b, c, gone):
        tr.on_delivery("ADDED", p, clock.t, clock.t)
        clock.step(0.01)
    tr.on_prestaged(a.metadata.uid)
    tr.on_delivery("DELETED", gone, clock.t, clock.t)
    clock.step(0.2)
    tr.on_wake("watch-event")
    tr.note_sched_wait(0.05, drr_round=2, credit=1.5, cause="watch-event")
    tr.on_dispatch([a, b, c])
    clock.step(0.3)
    tr.on_solved(_Results([a, b], errors={c.key(): "unschedulable"}), solve_seq=4)
    clock.step(0.1)
    a.spec.node_name = "node-1"
    tr.on_delivery("MODIFIED", a, clock.t, clock.t)
    clock.step(0.4)
    tr.on_dispatch([c])
    tr.on_solved(_Results([c]), solve_seq=5)


def _ring(tr, pods, clock):
    for i, p in enumerate(pods):
        tr.on_delivery("ADDED", p, clock.t, clock.t)
        clock.step(0.1 * (i + 1))
        tr.on_dispatch([p])
        clock.step(0.05)
        tr.on_solved(_Results([p]), solve_seq=i + 1)


SCENARIOS = {"lifecycle": (_lifecycle, 4, {}), "ring": (_ring, 7, dict(capacity=4)),
             "slo": (_ring, 5, dict(slo_seconds=0.2))}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_events_give_the_reference_records(name, monkeypatch):
    """Equal dumps (records, stage quantiles, SLO, wake causes) and equal
    registries from the same events under one fake clock."""
    drive, n, kw = SCENARIOS[name]
    dumps, regs = [], []
    for mod, metrics in ((ref_podtrace, ref_metrics), (podtrace, m)):
        clock = FakeTime()
        monkeypatch.setattr(mod, "time", clock.module())
        reg = metrics.make_registry()
        tracer = mod.PodTracer(enabled=True, registry=reg, **kw)
        pods = [_pod(f"{name}-{i}") for i in range(n)]
        if mod is podtrace:
            pods = carry_objects(pods)
        drive(tracer, pods, clock)
        tracer.publish_quantiles()
        dumps.append(tracer.dump())
        regs.append(reg)
    want, got = dumps
    assert got == want
    assert_same_registry(regs[1], regs[0], name)
    assert got["completed"] >= 1


# -- the reference's cases on the port ---------------------------------------------

class TestEventRecordLifecycle:
    def test_stages_are_additive_to_e2e(self):
        tracer = PodTracer(enabled=True)
        pod = _pod("ev-add")
        _deliver(tracer, pod)
        tracer.on_prestaged("uid-ev-add")
        _complete(tracer, [pod], solve_seq=7)
        (r,) = tracer.events()
        assert r.outcome == "placed" and r.solve_seq == 7 and r.staged
        s = r.stage_seconds()
        assert s["e2e"] == pytest.approx(s["coalesce"] + s["sched_wait"] + s["solve"], abs=1e-9)
        assert set(s) == set(STAGES)

    def test_cancel_and_bind_paths(self):
        tracer = PodTracer(enabled=True)
        gone = _pod("ev-gone")
        _deliver(tracer, gone)
        _deliver(tracer, gone, "DELETED")
        assert tracer.cancelled == 1 and tracer.events() == []
        pod = _pod("ev-bind")
        _deliver(tracer, pod)
        _complete(tracer, [pod])
        pod.spec.node_name = "node-1"
        _deliver(tracer, pod, "MODIFIED")
        r = tracer.events()[0]
        assert r.outcome == "bound" and r.stage_seconds()["decode"] >= 0.0 and r.t_bound >= r.t_solved

    def test_errored_and_absent_records_never_phantom_complete(self):
        tracer = PodTracer(enabled=True)
        pod = _pod("ev-err")
        _deliver(tracer, pod)
        tracer.on_dispatch([pod])
        tracer.on_solved(_Results([], errors={"default/ev-err": "unschedulable"}), solve_seq=1)
        assert tracer.events() == []
        tracer.on_dispatch([])
        tracer.on_solved(_Results([]), solve_seq=2)
        assert tracer.events() == [] and tracer.seq == 0
        tracer.on_dispatch([pod])
        tracer.on_solved(_Results([pod]), solve_seq=3)
        assert [r.solve_seq for r in tracer.events()] == [3]

    def test_disabled_tracer_records_nothing(self):
        tracer = PodTracer(enabled=False)
        pod = _pod("ev-off")
        _deliver(tracer, pod)
        _complete(tracer, [pod])
        assert tracer.events() == [] and tracer.deliveries == 0

    def test_non_pod_kinds_are_ignored(self):
        tracer = PodTracer(enabled=True)
        _deliver(tracer, type("_Node", (), {"kind": "Node"})())
        assert tracer.deliveries == 0


class TestRingAndSlo:
    def test_ring_bounds_and_dropped_counter(self):
        tracer = PodTracer(enabled=True, capacity=4)
        for i in range(7):
            pod = _pod(f"ev-ring-{i}")
            _deliver(tracer, pod)
            _complete(tracer, [pod], solve_seq=i + 1)
        assert len(tracer.events()) == 4 and tracer.dropped == 3 and tracer.seq == 7
        assert [r.seq for r in tracer.events()] == [4, 5, 6, 7]
        assert tracer.events_since(6) == tracer.events()[-1:]

    def test_slo_burn_accounting_and_metric(self):
        registry = m.make_registry()
        tracer = PodTracer(enabled=True, slo_seconds=0.0, registry=registry)
        for i in range(3):
            pod = _pod(f"ev-slo-{i}")
            _deliver(tracer, pod)
            _complete(tracer, [pod])
        slo = tracer.slo.to_dict()
        assert slo["completed"] == 3 and slo["breaches"] == 3
        assert slo["burn_rate"] == 1.0 and slo["budget_remaining"] == 0.0
        assert registry.counter(m.SOLVER_EVENT_SLO_BREACH_TOTAL).value(tenant="") == 3

    def test_selftime_meter_arms_and_disarms(self):
        tracer = PodTracer(enabled=True)
        tracer.start_selftime()
        pod = _pod("ev-st")
        _deliver(tracer, pod)
        _complete(tracer, [pod])
        cost = tracer.stop_selftime()
        assert cost > 0.0 and "on_delivery" not in tracer.__dict__
        _deliver(tracer, _pod("ev-st2"))
        assert tracer.selftime == cost and tracer.seq == 1

    def test_stats_cover_every_stage(self):
        tracer = PodTracer(enabled=True)
        pod = _pod("ev-stats")
        _deliver(tracer, pod)
        _complete(tracer, [pod])
        stats = tracer.stats()
        assert set(stats) == set(STAGES)
        assert all(qs["n"] == 1 and qs["p50"] <= qs["p99"] for qs in stats.values())

    def test_env_switches_default_on(self, monkeypatch):
        monkeypatch.delenv("KARPENTER_PODTRACE", raising=False)
        monkeypatch.delenv("KARPENTER_PODTRACE_SLO", raising=False)
        assert PodTracer().enabled and PodTracer().slo.target_seconds == 0.25
        monkeypatch.setenv("KARPENTER_PODTRACE", "0")
        assert not PodTracer().enabled


class TestPerfettoExport:
    def _records(self, n=3):
        tracer = PodTracer(enabled=True)
        pods = []
        for i in range(n):
            pod = _pod(f"ev-px-{i}")
            _deliver(tracer, pod)
            tracer.on_prestaged(pod.metadata.uid)
            pods.append(pod)
        _complete(tracer, pods, solve_seq=9)
        for pod in pods:
            pod.spec.node_name = "node-1"
            _deliver(tracer, pod, "MODIFIED")
        return tracer.events()

    def test_flow_arrows_round_trip(self):
        recs = self._records()
        events = json.loads(json.dumps(events_to_trace_events(recs)))["traceEvents"]
        assert {e["args"]["name"] for e in events if e.get("ph") == "M"} == {"watch-delivery", "serve-loop",
                                                                             "prestage-worker"}
        flows = [e for e in events if e.get("name") == "event-flow"]
        starts = {e["id"]: e["tid"] for e in flows if e["ph"] == "s"}
        finishes = {e["id"]: e["tid"] for e in flows if e["ph"] == "f"}
        assert set(starts) == set(finishes) and len(starts) == len(recs)
        assert all(tid != finishes[fid] for fid, tid in starts.items())
        assert {"coalesce", "solve", "prestage", "decode"} <= {e["name"].split(":")[0] for e in events
                                                               if e.get("ph") == "X"}

    def test_exports_equal_the_reference_on_the_same_records(self):
        from karpenter_tpu.obs import export as ref_export

        recs = [r.to_dict() for r in self._records(2)]
        assert events_to_trace_events(recs) == ref_export.events_to_trace_events(recs)

    def test_parse_event_dump_forms(self):
        recs = [r.to_dict() for r in self._records(2)]
        jsonl = "\n".join(json.dumps(r) for r in recs)
        assert parse_event_dump(jsonl) == recs
        assert parse_event_dump(json.dumps({"tenants": {"a": {"events": recs}}})) == recs
        assert parse_event_dump(json.dumps({"events": recs})) == recs
        assert parse_event_dump("") == []

    def test_cli_exports_event_tracks(self, tmp_path):
        from karpenter_tpu_torch.obs.__main__ import main

        src = tmp_path / "events.jsonl"
        src.write_text("\n".join(json.dumps(r.to_dict()) for r in self._records(2)))
        out = tmp_path / "events.trace.json"
        assert main([str(src), "--events", "--out", str(out)]) == 0
        assert any(e.get("name") == "event-flow" for e in json.loads(out.read_text())["traceEvents"])
