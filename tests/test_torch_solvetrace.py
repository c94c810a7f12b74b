"""The port's flight recorder (`obs/trace.py`) and GPUSolver's flight record
against the reference's, on the CPU.

For every solve mode — full, delta, hybrid, hybrid-delta, fallback, sim —
the same snapshots go through `TPUSolver()` and `GPUSolver(device="cpu")`,
each with its own registry and enabled recorder, from the same module
state (`test_torch_hybrid_solve.Chain`'s harness). At every step both
traces must agree on the mode, the backend (the port's "gpu" is the
reference's "tpu"), the pod and signature counts, the fallback reasons and
families, every attribution note (`encode_mode`, `row_cache`,
`delta_reject`, `delta_added`, `residual_pods`, `decode_mode`, the FFD memo,
...) and the span tree — the port's with its own finer stages
(`solver.gpu.PORT_SPANS`) taken out — and both registries on every counter
(`test_torch_metrics.registry_view`). Tracing on and off give bit-identical
Results. Then the reference's own cases (`tests/test_solvetrace.py:71-339`)
on the port: the quantile helper, the ring and its dropped counter, the
rolling quantiles, `summary_since`, `dump`, the raising solve's record, the
kernel-library sentinel (rewritten for the port: no load on the CPU, a
load counted once and never on a warm solve), the exports and the CLI,
`explain()`. All exact.
"""

from __future__ import annotations

import json
import sys

import pytest
import torch

from helpers import make_pod
from karpenter_tpu import metrics as ref_metrics
from karpenter_tpu.obs import TraceRecorder as RefRecorder
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch import metrics as port_metrics
from karpenter_tpu_torch.obs import (
    RecompileSentinel,
    RollingQuantiles,
    SolveTrace,
    TraceRecorder,
    default_recorder,
    quantile,
)
from karpenter_tpu_torch.obs.export import parse_dump, to_jsonl, to_trace_events
from karpenter_tpu_torch.solver.ffd import FFDSolver
from karpenter_tpu_torch.solver.gpu import PORT_SPANS, GPUSolver
from karpenter_tpu_torch.testing.carry_over import SnapshotMirror, snapshot_from_reference
from test_solver import make_snapshot
from test_solvetrace import _global_pod, _odd_pod
from test_torch_hybrid_solve import assert_same_carry
from test_torch_metrics import assert_same_registry, registry_view
from test_torch_solve import _fresh_state  # noqa: F401 (autouse)
from test_torch_solve import assert_same, clear_globals, next_start, outcome, same_state

torch.set_num_threads(1)

# notes whose values are wall times
TIMED_NOTES = frozenset({"event_batch"})


def span_tree(spans, port: bool) -> list:
    """(name, attrs, children) per span; the port's own stages left out."""
    out = []
    for s in spans:
        if port and s.name in PORT_SPANS:
            continue
        out.append((s.name, dict(s.attrs), span_tree(s.children, port)))
    return out


def trace_view(tr, port: bool) -> dict:
    backend = {"gpu": "tpu"}.get(tr.backend, tr.backend) if port else tr.backend
    return dict(mode=tr.mode, backend=backend, n_pods=tr.n_pods, n_sigs=tr.n_sigs,
                reasons=list(tr.fallback_reasons), families=tr.families, spans=span_tree(tr.spans, port),
                notes={k: v for k, v in tr.attribution.items() if k not in TIMED_NOTES})


def assert_same_trace(got, want, what: str) -> None:
    g, w = trace_view(got, True), trace_view(want, False)
    for key in w:
        assert g[key] == w[key], f"{what}: trace {key} {g[key]!r}, reference {w[key]!r}"


class TracedChain:
    """A chain of solves over one reference snapshot, mutated in place
    between steps, solved by both flight-recorded solvers side by side."""

    def __init__(self, ref_snap, enabled: bool = True):
        self.ref = ref_snap
        self.mirror = SnapshotMirror()
        self.ref_reg, self.port_reg = ref_metrics.make_registry(), port_metrics.make_registry()
        self.ref_solver = TPUSolver(registry=self.ref_reg, recorder=RefRecorder(enabled=enabled))
        self.gpu = GPUSolver(device="cpu", registry=self.port_reg, recorder=TraceRecorder(enabled=enabled))
        self.results: list = []
        clear_globals()

    def step(self, what: str = "") -> dict:
        what = f"step {len(self.results)} {what}".strip()
        port_snap = self.mirror.snapshot(self.ref)
        start = next_start()
        same_state(start)
        want = outcome(self.ref_solver, self.ref_solver.solve(self.ref), port=False)
        same_state(start)
        results = self.gpu.solve(port_snap)
        got = outcome(self.gpu, results, port=True)
        if not self.gpu.recorder.enabled:
            # the reference's delta reject is read from its trace's notes,
            # which a disabled recorder does not keep
            want["reject"] = got["reject"]
        assert_same(want, got, what)
        assert_same_carry(self.gpu, self.ref_solver, what)
        if self.gpu.recorder.enabled:
            assert_same_trace(self.gpu._trace, self.ref_solver._trace, what)
            assert self.gpu.recorder.last() is self.gpu._trace
        assert_same_registry(self.port_reg, self.ref_reg, what)
        self.results.append(got)
        return got


def _every_mode_steps(snap):
    return [
        ("full", lambda: None),
        ("delta", lambda: snap.pods.append(make_pod(cpu="500m", name="p5"))),
        ("hybrid", lambda: snap.pods.append(_odd_pod())),
        ("hybrid-delta", lambda: snap.pods.append(make_pod(cpu="500m", name="p6"))),
        ("delta", lambda: snap.pods.remove(next(p for p in snap.pods if p.metadata.name == "odd"))),
    ]


def test_every_mode_traces_and_counts_as_the_reference():
    """full -> delta -> hybrid -> hybrid-delta -> delta (the flagged pod
    left), then a whole-snapshot fallback and an empty snapshot: the same
    trace and the same counters at every step."""
    snap = make_snapshot([make_pod(cpu="500m", name=f"p{i}") for i in range(5)])
    chain = TracedChain(snap)
    for expected, mutate in _every_mode_steps(snap):
        mutate()
        got = chain.step(expected)
        assert got["mode"] == expected, (expected, got)
    fb = TracedChain(make_snapshot([_global_pod()] + [make_pod(cpu="1", labels={"app": "other"}, name=f"o{i}")
                                                      for i in range(2)]))
    assert fb.step("fallback")["mode"] == "fallback"
    assert "ffd.new_claim" in fb.gpu._trace.phase_totals and fb.gpu._trace.attribution["ffd_memo"]
    fb.ref.pods = []
    assert fb.step("empty")["reasons"] == ["empty snapshot"]
    text = chain.port_reg.expose()
    assert 'karpenter_solver_solve_total{backend="gpu",tenant=""} 3' in text
    assert 'karpenter_solver_solve_total{backend="hybrid-delta",tenant=""} 1' in text
    assert port_metrics.SOLVER_SOLVE_QUANTILE_SECONDS in text


def test_every_mode_bit_identical_tracing_on_and_off():
    """The same chain with recording off: bit-identical Results at every
    step (and the same counters), the phase totals kept, nothing retained."""
    on_snap = make_snapshot([make_pod(cpu="500m", name=f"p{i}") for i in range(5)])
    on = TracedChain(on_snap)
    for _mode, mutate in _every_mode_steps(on_snap):
        mutate()
        on.step()
    off_snap = make_snapshot([make_pod(cpu="500m", name=f"p{i}") for i in range(5)])
    off = TracedChain(off_snap, enabled=False)
    for _mode, mutate in _every_mode_steps(off_snap):
        mutate()
        off.step()
    assert [r["results"] for r in off.results] == [r["results"] for r in on.results]
    assert [r["mode"] for r in off.results] == [r["mode"] for r in on.results]
    assert off.gpu.recorder.traces() == [] and not off.gpu._trace.enabled
    assert off.gpu.last_phase_seconds["encode"] > 0 and off.gpu.last_stages
    assert registry_view(off.port_reg, True) == registry_view(on.port_reg, True)


@pytest.mark.parametrize("name", ["bench_min_values", "bench_fallback", "bench_reserved", "bench_affinity",
                                  "anti_affinity", "topology_spread", "existing_nodes", "host_ports", "daemonsets"])
def test_scenario_traces_and_counts_as_the_reference(name):
    """The solve scenarios of `test_torch_solve.py`, solved and resubmitted:
    the same traces (minValues repairs, reservations, hybrid residuals,
    delta rejects included) and the same counters."""
    from test_torch_solve import SOLVE_SCENARIOS

    chain = TracedChain(SOLVE_SCENARIOS[name]())
    chain.step(name)
    chain.step(f"{name} resubmit")


def test_sim_probe_traces_as_the_reference():
    """`solve_prepared` (mode "sim") through the consolidation simulator:
    the probe's trace, and the round's counters, equal the reference's."""
    from test_torch_disruption import fleet_env
    from test_torch_simulate import flipped, simulator

    pair = flipped(fleet_env(4))

    def run(side):
        reg = side.m("metrics").make_registry()
        rec = (TraceRecorder if side.port else RefRecorder)(enabled=True)
        side.prov.solver.registry, side.prov.solver.recorder = reg, rec
        sim, cands = simulator(side)
        sim.simulate(cands[:2])
        tr = rec.last()
        return dict(trace=trace_view(tr, side.port), mode=sim.last_mode), reg

    views = []
    start = next_start()
    for side in (pair.ref, pair.port):
        same_state(start)
        clear_globals()
        views.append(run(side))
    (want, ref_reg), (got, port_reg) = views
    assert got == want and got["trace"]["mode"] == "sim" and got["trace"]["notes"]["encode_mode"] == "sim-masked"
    assert_same_registry(port_reg, ref_reg, "sim")


# -- the reference's cases (tests/test_solvetrace.py) on the port ------------------

class TestQuantileHelper:
    def test_nearest_rank_exact_values(self):
        assert quantile([1, 2, 3, 4], 0.50) == 2
        assert quantile([1, 2, 3, 4], 0.95) == 4
        assert quantile(list(range(1, 21)), 0.95) == 19
        assert quantile(list(range(1, 101)), 0.99) == 99
        assert quantile([7.0], 0.5) == 7.0
        assert quantile([], 0.95) == 0.0
        assert quantile(list(range(1, 14)), 0.95) == 13

    def test_sorted_flag_and_rolling_window(self):
        assert quantile([3, 1, 2], 0.5) == 2
        win = RollingQuantiles(capacity=4)
        for v in [10, 20, 30, 40, 50, 60]:  # evicts 10, 20
            win.append(v)
        assert len(win) == 4
        assert win.quantile(0.5) == 40
        assert win.quantile(0.99) == 60


class TestRingAndStats:
    def _commit(self, rec, mode="full", registry=None, n_pods=0):
        t = rec.begin(n_pods=n_pods)
        with t.span("encode", mode="full"):
            pass
        t.mode = mode
        t.backend = "gpu"
        rec.commit(t, registry=registry)
        return t

    def test_ring_bounds_and_dropped_counter(self):
        reg = port_metrics.make_registry()
        rec = TraceRecorder(capacity=4, enabled=True)
        for i in range(10):
            self._commit(rec, registry=reg, n_pods=i)
        assert len(rec.traces()) == 4
        assert [t.n_pods for t in rec.traces()] == [6, 7, 8, 9]
        assert rec.dropped == 6
        assert reg.counter(port_metrics.SOLVER_TRACE_DROPPED_TOTAL).value() == 6

    def test_rolling_quantiles_published(self):
        reg = port_metrics.make_registry()
        rec = TraceRecorder(capacity=8, enabled=True)
        for _ in range(5):
            self._commit(rec, registry=reg)
        g = reg.gauge(port_metrics.SOLVER_SOLVE_QUANTILE_SECONDS)
        for q in ("p50", "p90", "p99"):
            assert g.value(mode="full", phase="total", quantile=q) > 0
        stats = rec.stats()
        assert stats["full/total"]["n"] == 5 and stats["full/total"]["p50"] <= stats["full/total"]["p99"]

    def test_dump_limit_zero_means_none(self):
        rec = TraceRecorder(capacity=4, enabled=True)
        for _ in range(3):
            self._commit(rec)
        assert len(rec.dump()["solves"]) == 3
        assert len(rec.dump(limit=1)["solves"]) == 1
        assert rec.dump(limit=0)["solves"] == [] and rec.dump(limit=-1)["solves"] == []

    def test_raising_solve_commits_empty_attribution(self):
        rec = TraceRecorder(capacity=8, enabled=True)
        solver = GPUSolver(device="cpu", force=True, recorder=rec)
        solver.solve(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name="ok")])))
        assert solver.last_backend == "gpu"
        with pytest.raises(RuntimeError, match="tensor path unsupported"):
            solver.solve(snapshot_from_reference(make_snapshot([_odd_pod()])))
        raised = rec.traces()[-1]
        assert raised.backend == "" and raised.mode == ""
        assert raised.fallback_reasons

    def test_flight_commits_however_the_block_exits(self, monkeypatch):
        """`TraceRecorder.flight` (the one begin/sentinel/commit sequence of
        every flight record): mode and backend set, the trace ambient inside
        the block, committed with the sentinel's delta into the registry on
        a raise as on a return."""
        from karpenter_tpu_torch.kernels import build
        from karpenter_tpu_torch.models import consolidation_model  # noqa: F401 (lp_repack's module, watched)
        from karpenter_tpu_torch.obs.trace import current_trace

        monkeypatch.setattr(build, "LOADS", {})
        reg = port_metrics.make_registry()
        rec = TraceRecorder(capacity=8, enabled=True)
        with pytest.raises(RuntimeError, match="inside"):
            with rec.flight(n_pods=3, mode="consolidate", backend="lp", registry=reg) as t:
                assert current_trace() is t and t.mode == "consolidate" and t.backend == "lp"
                monkeypatch.setitem(build.LOADS, "lp_repack", 1)
                raise RuntimeError("inside")
        assert rec.last() is t and current_trace() is None
        assert t.recompiles == {"lp_repack": 1} and t.n_pods == 3
        assert reg.counter(port_metrics.SOLVER_RECOMPILE_TOTAL).value(fn="lp_repack") == 1
        with rec.flight() as t2:
            pass
        assert rec.last() is t2 and t2.recompiles == {} and t2.mode == ""

    def test_summary_since(self):
        rec = TraceRecorder(capacity=8, enabled=True)
        self._commit(rec, mode="full")
        mark = rec.seq
        self._commit(rec, mode="hybrid")
        s = rec.summary_since(mark)
        assert s["n_solves"] == 1 and s["modes"] == {"hybrid": 1} and "last_phases" in s


class TestKernelLibrarySentinel:
    """The port's recompile sentinel counts builds and loads of the kernel
    library (`kernels.build.LOADS`), never launches."""

    def test_cpu_solves_record_no_load(self):
        reg = port_metrics.make_registry()
        solver = GPUSolver(device="cpu", registry=reg, recorder=TraceRecorder(enabled=True))
        snap = snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"s{i}") for i in range(5)]))
        solver.solve(snap)
        assert solver._trace.recompiles == {}
        solver.solve(snap)
        assert solver.last_solve_mode == "delta" and solver._trace.recompiles == {}
        assert reg.counter(port_metrics.SOLVER_RECOMPILE_TOTAL).total() == 0

    def test_a_load_counts_once_per_label_and_never_warm(self, monkeypatch):
        """A library load made under the full pack's entry point counts once,
        under `pack_full` alone: the recompile counter summed over `fn`
        reads 1 after the cold solve, and a warm solve records none."""
        from karpenter_tpu_torch.kernels import build
        from karpenter_tpu_torch.models import scheduler_model_grouped as smg

        monkeypatch.setattr(build, "LOADS", {})
        solver = GPUSolver(device="cpu", registry=port_metrics.make_registry(), recorder=TraceRecorder(enabled=True))
        snap = snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"s{i}") for i in range(3)]))
        real = smg._pack_flat
        loaded = []

        def pack_flat(*a, **k):
            if not loaded:  # the library load a first CUDA launch pays, inside greedy_pack_grouped_compressed
                loaded.append(1)
                build.count_load()
            return real(*a, **k)

        monkeypatch.setattr(smg, "_pack_flat", pack_flat)
        solver.solve(snap)
        assert solver._trace.recompiles == {"pack_full": 1}
        assert build.LOADS == {"pack_full": 1}
        counter = solver.registry.counter(port_metrics.SOLVER_RECOMPILE_TOTAL)
        assert counter.total() == 1 and counter.value(fn="pack_full") == 1
        solver.solve(snap)
        assert solver._trace.recompiles == {}
        assert "recompiles: none" in solver._trace.explain()
        assert counter.total() == 1

    def test_a_load_outside_an_entry_point_counts_under_no_label(self, monkeypatch):
        """A load made by a direct wrapper call (no watched entry point on
        the stack) is counted under "" and shows under no `fn`."""
        from karpenter_tpu_torch.kernels import build

        monkeypatch.setattr(build, "LOADS", {})
        s = RecompileSentinel()
        before = s.snapshot()
        build.count_load()
        assert build.LOADS == {"": 1} and s.delta(before) == {}

    def test_launches_are_not_recompiles(self, monkeypatch):
        from karpenter_tpu_torch.kernels import build

        s = RecompileSentinel()
        before = s.snapshot()
        monkeypatch.setitem(build.LAUNCHES, "pack_scan", build.LAUNCHES["pack_scan"] + 5)
        assert s.delta(before) == {}

    def test_sentinel_snapshot_is_safe_without_modules(self, monkeypatch):
        s = RecompileSentinel(watchlist=(("ghost", "not.a.module", "fn"),))
        assert s.snapshot() == {} and s.delta(None) == {}
        monkeypatch.delitem(sys.modules, "karpenter_tpu_torch.kernels.build")
        assert RecompileSentinel().snapshot() == {}

    def test_watchlist_keeps_the_reference_labels(self):
        from karpenter_tpu.obs.trace import JIT_WATCHLIST as REF
        from karpenter_tpu_torch.obs.trace import JIT_WATCHLIST

        ref_labels = [label for label, _m, _a in REF if label not in ("pack_sharded", "shard_feas")]
        assert [label for label, _m, _a in JIT_WATCHLIST] == ref_labels
        for _label, mod, attr in JIT_WATCHLIST:
            fn = getattr(__import__(mod, fromlist=[attr]), attr)
            # `build.count_load` finds the entry point by its frame's module and code name
            assert callable(fn) and fn.__module__ == mod and fn.__code__.co_name == attr


class TestExport:
    def _traced_recorder(self):
        rec = TraceRecorder(capacity=8, enabled=True)
        t = rec.begin(n_pods=3)
        with t.span("encode", mode="full"):
            pass
        with t.span("pack", mode="full"):
            with t.span("decode"):
                pass
        t.mode, t.backend = "full", "gpu"
        t.recompiles = {"pack_full": 1}
        rec.commit(t)
        return rec

    def test_perfetto_round_trips_through_json(self):
        ev = json.loads(json.dumps(to_trace_events(self._traced_recorder().traces())))
        names = [e["name"] for e in ev["traceEvents"]]
        assert {"solve#1", "encode", "pack", "decode", "recompile:pack_full"} <= set(names)
        solve_ev = next(e for e in ev["traceEvents"] if e["name"] == "solve#1")
        assert solve_ev["ph"] == "X" and solve_ev["dur"] > 0

    def test_jsonl_round_trip_and_parse_dump(self):
        rec = self._traced_recorder()
        jsonl = to_jsonl(rec.traces())
        rows = [json.loads(line) for line in jsonl.splitlines()]
        assert rows and rows[0]["mode"] == "full"
        assert parse_dump(jsonl)[0]["recompiles"] == {"pack_full": 1}
        assert parse_dump(json.dumps(rec.dump()))[0]["mode"] == "full"

    def test_exports_equal_the_reference_on_the_same_trace(self):
        """The same trace dict through both packages' exporters."""
        from karpenter_tpu.obs import export as ref_export
        from karpenter_tpu_torch.obs import export as port_export

        d = self._traced_recorder().traces()[0].to_dict()
        assert port_export.to_jsonl([d]) == ref_export.to_jsonl([d])
        assert port_export.to_trace_events([d]) == ref_export.to_trace_events([d])
        assert port_export.parse_dump(json.dumps(d)) == ref_export.parse_dump(json.dumps(d))

    def test_cli_exports_perfetto_and_jsonl(self, tmp_path):
        from karpenter_tpu_torch.obs.__main__ import main

        rec = self._traced_recorder()
        src = tmp_path / "solves.jsonl"
        src.write_text(to_jsonl(rec.traces()) + "\n")
        out = tmp_path / "solves.trace.json"
        assert main([str(src), "--out", str(out)]) == 0
        assert json.loads(out.read_text())["traceEvents"]
        out2 = tmp_path / "norm.jsonl"
        assert main([str(src), "--format", "jsonl", "--out", str(out2)]) == 0
        assert json.loads(out2.read_text().splitlines()[0])["mode"] == "full"
        assert main([str(tmp_path / "missing.jsonl"), "--out", str(out)]) == 2

    def test_cli_runs_as_a_module_on_a_solver_dump(self, tmp_path):
        import subprocess

        solver = GPUSolver(device="cpu", recorder=TraceRecorder(enabled=True))
        solver.solve(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name="web")])))
        dump = tmp_path / "dump.json"
        dump.write_text(json.dumps(solver.recorder.dump()))
        out = tmp_path / "out.json"
        proc = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.obs", str(dump), "--out", str(out)],
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
        assert {"encode", "pack", "decode", "build_items", "scan"} <= names

    def test_trace_to_dict_fields(self):
        d = self._traced_recorder().traces()[0].to_dict()
        for key in ("seq", "mode", "backend", "n_pods", "duration_s", "phases", "spans", "cache", "recompiles"):
            assert key in d
        pack = next(s for s in d["spans"] if s["name"] == "pack")
        assert pack["children"][0]["name"] == "decode"


class TestExplainAndAttribution:
    def test_hybrid_explain_names_families_and_residual(self):
        solver = GPUSolver(device="cpu", recorder=TraceRecorder(enabled=True))
        clear_globals()
        solver.solve(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"p{i}")
                                                            for i in range(4)] + [_odd_pod()])))
        assert solver.last_solve_mode == "hybrid"
        tr = solver._trace
        assert tr.families == ["pod-affinity"] and tr.attribution["residual_pods"] == 1
        assert tr.phase_totals["residual"] > 0 and "ffd.new_claim" in tr.phase_totals
        assert "why hybrid" in tr.explain() and "pod-affinity" in tr.explain()
        assert tr.phase_totals["mask_encode"] <= tr.phase_totals["encode"]

    def test_port_spans_nest_inside_the_reference_spans(self):
        solver = GPUSolver(device="cpu", recorder=TraceRecorder(enabled=True))
        clear_globals()
        solver.solve(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"p{i}") for i in range(4)])))
        top = [s.name for s in solver._trace.spans]
        assert top == ["encode", "pack"]
        pack = solver._trace.spans[1]
        assert [c.name for c in pack.children] == ["copy", "build_items", "make_tensors", "scan", "assignment",
                                                   "validate", "decode"]
        stages = solver.last_stages
        assert stages["pack"] >= stages["scan"] and set(stages) == {"encode", "pack", "copy", "build_items",
                                                                     "make_tensors", "scan", "assignment",
                                                                     "validate", "decode"}

    def test_standalone_ffd_solver_records_a_trace(self):
        rec = default_recorder()
        mark = rec.seq
        FFDSolver().solve(snapshot_from_reference(make_snapshot([make_pod(cpu="1", name="solo")])))
        traces = [t for t in rec.traces() if t.seq > mark]
        if rec.enabled:
            assert traces and traces[-1].mode == "ffd" and traces[-1].backend == "ffd"
            assert "ffd.new_claim" in traces[-1].phase_totals

    def test_trace_object_defaults(self):
        t = SolveTrace()
        assert t.mode == "" and t.phase_totals == {} and t.explain()
