"""Disruption controller: the 10s-poll loop running methods in priority order
(reference: disruption/controller.go:101-183).

`metrics` (a `metrics.Registry`) receives the reference's disruption
gauges, counters and decision histogram; `cluster_cost` (a
`state.cost.ClusterCost`) the nodepool totals that balanced scoring reads.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...apis import labels as wk
from ...utils.pdb import PDBLimits
from .helpers import build_disruption_budget_mapping
from .methods import Drift, Emptiness, MultiNodeConsolidation, SingleNodeConsolidation, StaticDrift
from .queue import OrchestrationQueue
from .types import build_candidate

POLL_SECONDS = 10.0


@dataclass
class _Ctx:
    store: object
    cluster: object
    provisioner: object
    clock: object
    options: object
    cluster_cost: object = None
    # per-round candidate set + lazily-memoized balanced-scoring totals
    # (balanced.go computeNodePoolTotals); only consolidation methods touching
    # a Balanced pool ever pay for the totals pass
    round_candidates: list | None = None
    node_pool_totals: dict | None = None
    # live candidate rebuild for the 15s command validator (validation.go)
    get_candidates: object = None
    metrics: object = None

    def balanced_totals(self) -> dict:
        if self.node_pool_totals is None:
            from .balanced import compute_node_pool_totals

            self.node_pool_totals = compute_node_pool_totals(
                self.round_candidates or [], self.cluster.nodes(), self.cluster_cost
            )
        return self.node_pool_totals


class DisruptionController:
    def __init__(self, store, cluster, provisioner, cloud_provider, clock, options, recorder=None, metrics=None, cluster_cost=None):
        self.store = store
        self.cluster = cluster
        self.provisioner = provisioner
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.options = options
        self.cluster_cost = cluster_cost
        ctx = _Ctx(store, cluster, provisioner, clock, options, cluster_cost=cluster_cost, metrics=metrics)
        ctx.get_candidates = self.get_candidates
        self.ctx = ctx
        self.methods = [
            Emptiness(ctx),
            StaticDrift(ctx),
            Drift(ctx),
            MultiNodeConsolidation(ctx),
            SingleNodeConsolidation(ctx),
        ]
        self.queue = OrchestrationQueue(store, cluster, provisioner, clock, recorder)
        self.metrics = metrics
        self._last_run = -1e18

    def reconcile(self, force: bool = False) -> None:
        self.queue.reconcile()
        now = self.clock.now()
        if not force and now - self._last_run < POLL_SECONDS:
            return
        self._last_run = now
        if not self.cluster.synced():
            return
        if self.cluster.consolidated():
            return
        self._cleanup_leftover_taints()
        executed, budget_blocked = self.disrupt()
        if not executed and not budget_blocked:
            # a round that found nothing AND was not budget-limited marks the
            # cluster consolidated; budget-blocked candidates must keep the
            # poll alive — cron budget windows open without any object edit
            # (consolidation_test.go:714-934 "should not mark ... consolidated
            # if the candidates can't be disrupted due to budgets")
            self.cluster.mark_consolidated()

    def disrupt(self) -> tuple[bool, bool]:
        """Run methods in priority order; execute the first command batch
        (controller.go:166-179). Returns (executed, budget_blocked) where
        budget_blocked means a pool with candidates a method would disrupt
        had its budget exhausted this round."""
        import time as _time

        budget_blocked = False
        for method in self.methods:
            ctype = getattr(method, "consolidation_type", "")
            mname = type(method).__name__
            candidates = self.get_candidates()
            if self.metrics is not None:
                from ... import metrics as m

                self.metrics.gauge(m.DISRUPTION_ELIGIBLE_NODES).set(len(candidates), method=mname, consolidation_type=ctype)
            if not candidates:
                return False, budget_blocked
            self.ctx.round_candidates = candidates
            self.ctx.node_pool_totals = None
            budgets = build_disruption_budget_mapping(self.store, self.cluster, self.clock, method.reason)
            # budget-blocked only counts pools whose candidates THIS method
            # would actually disrupt (the reference ties the signal to the
            # method's own filtered set) — a reason-scoped zero budget for a
            # method with nothing to do must not suppress consolidated
            # pacing; the should_disrupt sweep runs only when some budget is
            # actually at zero (rare), never on the common all-positive path
            if not budget_blocked and any(v <= 0 for v in budgets.values()):
                zero_pools = {pool for pool, v in budgets.items() if v <= 0}
                if any(
                    c.node_pool is not None
                    and c.node_pool.metadata.name in zero_pools
                    and method.should_disrupt(c)
                    for c in candidates
                ):
                    budget_blocked = True
            t0 = _time.perf_counter()
            commands = method.compute_commands(candidates, budgets)
            started = False
            for cmd in commands:
                if cmd.candidates and self.queue.start_command(cmd):
                    started = True
            if self.metrics is not None:
                from ... import metrics as m

                self.metrics.histogram(m.DISRUPTION_DECISION_EVAL_DURATION).observe(_time.perf_counter() - t0, method=mname)
                for cmd in commands:
                    if cmd.candidates:
                        decision = "replace" if cmd.replacements else "delete"
                        self.metrics.counter(m.DISRUPTION_DECISIONS_TOTAL).inc(
                            decision=decision, method=mname, consolidation_type=ctype
                        )
            if started:
                return True, budget_blocked
        return False, budget_blocked

    def get_candidates(self) -> list:
        node_pools = {np.metadata.name: np for np in self.store.list("NodePool")}
        instance_types = {
            name: self.cloud_provider.get_instance_types(np) for name, np in node_pools.items()
        }
        pdb = PDBLimits(self.store)
        disrupting = self.queue.disrupting_names()
        out = []
        for sn in self.cluster.nodes_view():
            if sn.name() in disrupting:
                continue
            candidate, err = build_candidate(
                self.cluster, self.store, self.clock, sn, node_pools, instance_types, pdb
            )
            if candidate is not None:
                out.append(candidate)
        return out

    def _cleanup_leftover_taints(self) -> None:
        """Idempotently clear disruption taints on nodes that are not part of
        an in-flight command (controller.go:147-164)."""
        active = self.queue.disrupting_names()
        for node in self.store.list("Node"):
            if node.metadata.name in active or node.metadata.deletion_timestamp is not None:
                continue
            sn = self.cluster.node_for_name(node.metadata.name)
            if sn is not None and (sn.marked_for_deletion or sn.deleted()):
                continue  # mid-teardown nodes keep their taint (controller.go:151)
            if any(t.key == wk.DISRUPTED_TAINT_KEY for t in node.spec.taints):
                def untaint(n):
                    n.spec.taints = [t for t in n.spec.taints if t.key != wk.DISRUPTED_TAINT_KEY]

                self.store.patch("Node", node.metadata.name, untaint)
                sn = self.cluster.node_for_name(node.metadata.name)
                if sn is not None:
                    self.cluster.unmark_for_deletion([sn.provider_id()])
