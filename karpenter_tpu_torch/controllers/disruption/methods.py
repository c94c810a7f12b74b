"""Disruption methods, run in priority order: Emptiness -> Drift ->
MultiNodeConsolidation -> SingleNodeConsolidation.

Reference: disruption/{emptiness,drift,consolidation,multinodeconsolidation,
singlenodeconsolidation}.go. Each method computes Commands from candidates
under budget constraints; the controller executes the first non-empty one.

Multi-node consolidation reads the reference's switches at each round.
With the options' solver backend "gpu" (the port's default),
`KARPENTER_CONSOLIDATE_LP` picks the device proposer: "1" (the default) the
relaxed LP (kernels K5 and K6), "anneal" the annealed subset search over the
100-candidate window (kernel K7's pre-pass and chains), "0", "false" or
"off" none; `KARPENTER_SOLVER_GLOBALPACK=1` tries the global repack (K5 and
K6) first under either proposer. The masked probes pack with K1-K3. The
binary search over the cost-sorted prefix is the in-band fallback when the
device proposer yields no valid command, and the only path with the "ffd"
backend or the switch off. A kernel's failure fails the round in every arm.
The global-repack ladder also serves `serving.churn.ChurnHarness.
repack_savings`. Each LP or global round is flight-recorded on the
provisioner solver's trace recorder (mode "consolidate", backend "lp" or
"globalpack") and counted into the controller's metrics registry as the
reference's is.
"""

from __future__ import annotations

import os

from ...apis import labels as wk
from ...apis.nodeclaim import COND_CONSOLIDATABLE, COND_DRIFTED
from ...apis.nodepool import BALANCED, WHEN_EMPTY
from ...cloudprovider.types import order_by_price
from .helpers import all_non_pending_scheduled, simulate_scheduling
from .types import REASON_DRIFTED, REASON_EMPTY, REASON_UNDERUTILIZED, Command

MULTI_NODE_CONSOLIDATION_CANDIDATE_CAP = 100  # multinodeconsolidation.go:35
# the spellings of the switches' off and on values
SWITCH_OFF = ("0", "false", "off")
SWITCH_ON = ("1", "true", "on")
# compute caps on the deterministic clock: one slow pool must not starve the
# 10s rounds forever (multinodeconsolidation.go:35, singlenodeconsolidation.go:33)
MULTI_NODE_CONSOLIDATION_TIMEOUT_SECONDS = 60.0
SINGLE_NODE_CONSOLIDATION_TIMEOUT_SECONDS = 180.0
# how many ranked proposals the 15s exact Validator may be run against in one
# multi-node round: the winner plus fallbacks pulled lazily from the proposer's
# ladder when validation rejects (each attempt pays the full 15s wait, so the
# cap also bounds wall-clock alongside the shared deadline)
MULTI_NODE_VALIDATION_ATTEMPTS = 3


def _switch(name: str, default: str) -> str:
    """A switch's value as the reference reads it, at each round: stripped,
    lower case."""
    return os.environ.get(name, default).strip().lower()


class Emptiness:
    """Delete nodes with no reschedulable pods (emptiness.go)."""

    reason = REASON_EMPTY
    consolidation_type = "empty"

    def __init__(self, ctx):
        self.ctx = ctx

    def should_disrupt(self, candidate) -> bool:
        # every consolidation policy permits removing empty nodes; the
        # Consolidatable condition (consolidateAfter) is the only gate.
        # Static fleets hold their replica count (emptiness.go:43).
        if candidate.node_claim is None or candidate.owned_by_static_node_pool():
            return False
        if not candidate.node_claim.status.conditions.is_true(COND_CONSOLIDATABLE):
            return False
        # a node hosting virtual buffer pods is not empty: the provisioner put
        # headroom there on purpose (emptiness.go:51-57)
        if self.ctx.cluster.has_buffer_pods(candidate.state_node.provider_id()):
            return False
        return len(candidate.reschedulable_pods) == 0

    def compute_commands(self, candidates, budgets) -> list[Command]:
        empty = [c for c in candidates if self.should_disrupt(c)]
        allowed = dict(budgets)
        chosen = []
        for c in empty:
            pool = c.node_pool.metadata.name
            if allowed.get(pool, 0) > 0:
                chosen.append(c)
                allowed[pool] -= 1
        if not chosen:
            return []
        cmd = Command(reason=REASON_EMPTY, candidates=chosen)
        # 15s wait + live re-check; the command shrinks to surviving nodes
        # (emptiness.go:101, validation.go:134-148)
        from .validation import ValidationError, Validator

        try:
            cmd = Validator(self.ctx, self, mode="subset", metrics=self.ctx.metrics).validate(cmd)
        except ValidationError:
            return []
        return [cmd]


class StaticDrift:
    """Replace drifted static-fleet nodes 1:1 from the pool template
    (staticdrift.go:50-106): no scheduling simulation — the replacement is a
    fresh template claim, created before the drifted one drains."""

    reason = REASON_DRIFTED
    consolidation_type = ""

    def __init__(self, ctx):
        self.ctx = ctx

    def should_disrupt(self, candidate) -> bool:
        return (
            candidate.node_claim is not None
            and candidate.owned_by_static_node_pool()
            and candidate.node_claim.status.conditions.is_true(COND_DRIFTED)
        )

    def compute_commands(self, candidates, budgets) -> list[Command]:
        from ..static.provisioning import build_static_claim, node_limit_headroom

        by_pool: dict[str, list] = {}
        for c in candidates:
            if self.should_disrupt(c):
                by_pool.setdefault(c.node_pool.metadata.name, []).append(c)
        out = []
        for pool_name, cs in by_pool.items():
            np = cs[0].node_pool
            allowed = budgets.get(pool_name, 0)
            if allowed <= 0:
                continue
            # don't churn while the pool is above its replica count — scale
            # down first (staticdrift.go:74-78)
            live = sum(
                1
                for sn in self.ctx.cluster.nodes()
                if sn.labels().get(wk.NODEPOOL_LABEL_KEY) == pool_name and not sn.deleted()
            )
            if live > (np.spec.replicas or 0):
                continue
            max_drifts = min(allowed, len(cs), node_limit_headroom(np, live))
            if max_drifts <= 0:
                continue
            its = self.ctx.provisioner.cloud_provider.get_instance_types(np)
            if not its:
                continue
            for c in cs[:max_drifts]:
                out.append(
                    Command(reason=REASON_DRIFTED, candidates=[c], replacements=[build_static_claim(np, its)])
                )
        return out


class Drift:
    """Replace drifted nodes (drift.go); drift is detected by the nodeclaim
    disruption controller setting the Drifted condition."""

    reason = REASON_DRIFTED
    consolidation_type = "drift"

    def __init__(self, ctx):
        self.ctx = ctx

    def should_disrupt(self, candidate) -> bool:
        return (
            candidate.node_claim is not None
            and not candidate.owned_by_static_node_pool()  # StaticDrift's job (drift.go:59)
            and candidate.node_claim.status.conditions.is_true(COND_DRIFTED)
        )

    def compute_commands(self, candidates, budgets) -> list[Command]:
        drifted = sorted(
            (c for c in candidates if self.should_disrupt(c)),
            key=lambda c: c.disruption_cost,
        )
        allowed = dict(budgets)
        out = []
        for c in drifted:
            pool = c.node_pool.metadata.name
            if allowed.get(pool, 0) <= 0:
                continue
            results = simulate_scheduling(self.ctx.provisioner, self.ctx.cluster, [c], self.ctx.clock)
            if not all_non_pending_scheduled(results, [c]):
                continue
            allowed[pool] -= 1
            out.append(
                Command(
                    reason=REASON_DRIFTED,
                    candidates=[c],
                    replacements=[nc for nc in results.new_node_claims],
                    results=results,
                )
            )
        return out


class _ConsolidationBase:
    reason = REASON_UNDERUTILIZED

    def __init__(self, ctx):
        self.ctx = ctx

    def sort_candidates(self, eligible: list) -> list:
        """Shared consolidation order: highest savings per unit disruption
        first, so budget- and timeout-limited rounds spend themselves on the
        most impactful moves (consolidation.go:140-154 sortCandidates by
        SavingsRatio desc). Single-node layers its NodePool interweave on
        top; multi-node's prefix binary search windows over this order."""
        return sorted(eligible, key=lambda c: c.savings_ratio(), reverse=True)

    def should_disrupt(self, candidate) -> bool:
        if candidate.node_claim is None or candidate.owned_by_static_node_pool():
            return False
        policy = candidate.node_pool.spec.disruption.consolidation_policy
        if policy == WHEN_EMPTY:
            return False  # only emptiness may disrupt
        return candidate.node_claim.status.conditions.is_true(COND_CONSOLIDATABLE)

    def compute_consolidation(self, candidates, reuse=None) -> Command:
        """The consolidation decision (consolidation.go:159-254). `reuse` is
        the round's ConsolidationSimulator: proposal checks inside its
        correctness envelope run as masked sub-encode simulations; the 15s
        Validator never passes one."""
        if not candidates:
            # nothing to consolidate — don't burn a simulation on it
            return Command()
        ctx = self.ctx
        results = simulate_scheduling(ctx.provisioner, ctx.cluster, candidates, ctx.clock, reuse=reuse)
        if not all_non_pending_scheduled(results, candidates):
            return Command()
        if len(results.new_node_claims) == 0:
            return Command(reason=self.reason, candidates=list(candidates), results=results)
        if len(results.new_node_claims) != 1:
            return Command()

        candidate_price = sum(c.price for c in candidates)
        replacement = results.new_node_claims[0]
        replacement.instance_type_options = order_by_price(replacement.instance_type_options, replacement.requirements)

        all_spot = all(c.capacity_type == wk.CAPACITY_TYPE_SPOT for c in candidates)
        ct_req = replacement.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY)
        if all_spot and ct_req.has(wk.CAPACITY_TYPE_SPOT):
            return self._spot_to_spot(candidates, results, candidate_price)

        # keep only strictly cheaper replacement types (nodeclaim.go:411
        # RemoveInstanceTypeOptionsByPriceAndMinValues)
        kept = _filter_by_price(replacement, candidate_price)
        if not kept:
            return Command()
        replacement.instance_type_options = kept

        # if both spot and on-demand survive, force spot so a failed spot
        # launch doesn't fall back to a pricier on-demand node
        ct_req = replacement.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY)
        if ct_req.has(wk.CAPACITY_TYPE_SPOT) and ct_req.has(wk.CAPACITY_TYPE_ON_DEMAND):
            from ...scheduling.requirements import Requirement

            replacement.requirements.add(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [wk.CAPACITY_TYPE_SPOT]))

        return Command(reason=self.reason, candidates=list(candidates), replacements=[replacement], results=results)

    def _spot_to_spot(self, candidates, results, candidate_price) -> Command:
        """Spot-to-spot consolidation (consolidation.go:261-343): gated on the
        feature flag; single-node requires >= 15 cheaper types and the current
        instance NOT among the 15 cheapest to avoid churn."""
        ctx = self.ctx
        if not ctx.options.feature_gates.spot_to_spot_consolidation:
            return Command()
        replacement = results.new_node_claims[0]
        kept = _filter_by_price(replacement, candidate_price)
        if not kept:
            return Command()
        if len(candidates) == 1:
            if len(kept) < 15:
                return Command()
            cheapest_names = {it.name for it in kept[:15]}
            if candidates[0].instance_type is not None and candidates[0].instance_type.name in cheapest_names:
                return Command()
            kept = kept[:15]
        replacement.instance_type_options = kept
        return Command(reason=self.reason, candidates=list(candidates), replacements=[replacement], results=results)

    def _passes_balanced(self, command: Command) -> bool:
        """Balanced policy gate (balanced.go:131-182): every Balanced pool the
        move touches must clear the 1/k score threshold against the per-pool
        totals the controller computed for this round."""
        if not any(c.node_pool.spec.disruption.consolidation_policy == BALANCED for c in command.candidates):
            return True
        from .balanced import evaluate_balanced_move

        return evaluate_balanced_move(command, _replacement_price(command), self.ctx.balanced_totals())

    def _can_pass_threshold(self, candidate) -> bool:
        """Best-case pre-filter (balanced.go:285-299 CanPassThreshold): a full
        DELETE is the upper bound on any move's balanced score — if even that
        fails the 1/k threshold, skip the expensive simulation entirely.
        Non-Balanced pools always pass."""
        if candidate.node_pool.spec.disruption.consolidation_policy != BALANCED:
            return True
        from .balanced import score_move

        totals = self.ctx.balanced_totals().get(candidate.node_pool.metadata.name)
        if totals is None or totals.total_cost <= 0:
            return True
        return score_move(candidate.price, candidate.reschedule_disruption_cost, totals).approved()

    def _count_timeout(self) -> None:
        if self.ctx.metrics is not None:
            from ... import metrics as m

            self.ctx.metrics.counter(m.DISRUPTION_CONSOLIDATION_TIMEOUTS_TOTAL).inc(
                consolidation_type=self.consolidation_type
            )


class SingleNodeConsolidation(_ConsolidationBase):
    """Try candidates one at a time under a 3-minute budget, interweaving
    candidates across NodePools so one big pool cannot starve the rest; pools
    unseen when a round times out go first next round
    (singlenodeconsolidation.go:33-176)."""

    consolidation_type = "single"

    def __init__(self, ctx):
        super().__init__(ctx)
        # cross-round fairness carry-over (PreviouslyUnseenNodePools)
        self.previously_unseen_node_pools: set[str] = set()

    def sort_candidates(self, eligible: list) -> list:
        """The shared SavingsRatio sort, then round-robin interweave by
        NodePool with previously-unseen pools first
        (singlenodeconsolidation.go:141-176 SortCandidates calls the shared
        sortCandidates before shuffleCandidates)."""
        eligible = super().sort_candidates(eligible)
        by_pool: dict[str, list] = {}
        for c in eligible:
            by_pool.setdefault(c.node_pool.metadata.name, []).append(c)
        pool_order = sorted(p for p in self.previously_unseen_node_pools if p in by_pool)
        pool_order += [p for p in by_pool if p not in self.previously_unseen_node_pools]
        out = []
        width = max((len(cs) for cs in by_pool.values()), default=0)
        for i in range(width):
            for pool in pool_order:
                cs = by_pool[pool]
                if i < len(cs):
                    out.append(cs[i])
        return out

    def compute_commands(self, candidates, budgets) -> list[Command]:
        import time as _time

        from .validation import ValidationError, Validator

        eligible = self.sort_candidates([c for c in candidates if self.should_disrupt(c)])
        deadline = self.ctx.clock.now() + SINGLE_NODE_CONSOLIDATION_TIMEOUT_SECONDS
        # the reference's 3-minute budget is measured on a REAL clock; the
        # injected deterministic clock doesn't advance during compute, so the
        # wall bound must also apply or a large fleet makes one round unbounded
        wall_deadline = _time.monotonic() + SINGLE_NODE_CONSOLIDATION_TIMEOUT_SECONDS
        unseen = {c.node_pool.metadata.name for c in eligible}
        allowed = dict(budgets)
        for c in eligible:
            if self.ctx.clock.now() > deadline or _time.monotonic() > wall_deadline:
                # abandon the round; pools not yet reached get priority next
                # time (singlenodeconsolidation.go:61-74)
                self._count_timeout()
                self.previously_unseen_node_pools = unseen
                return []
            pool = c.node_pool.metadata.name
            unseen.discard(pool)
            if allowed.get(pool, 0) <= 0:
                continue
            # skip candidates that can't clear the balanced threshold even as
            # a pure delete (singlenodeconsolidation.go:88-90)
            if not self._can_pass_threshold(c):
                continue
            cmd = self.compute_consolidation([c])
            if cmd.candidates and self._passes_balanced(cmd):
                # 15s wait + re-simulation before execution
                # (singlenodeconsolidation.go:105, validation.go:192-263)
                # the reference persists unseen pools only on timeout and on a
                # full pass; a command or validation failure leaves the prior
                # set untouched (singlenodeconsolidation.go:61-74,105-115)
                try:
                    Validator(self.ctx, self, mode="strict", metrics=self.ctx.metrics).validate(cmd)
                except ValidationError:
                    return []
                return [cmd]
        self.previously_unseen_node_pools = unseen
        return []


class MultiNodeConsolidation(_ConsolidationBase):
    """Multi-node consolidation. DEFAULT ("gpu" backend): the relaxed-LP
    repack proposes candidate subsets on the device over the FULL eligible
    fleet (`solver/consolidation.propose_subsets_lp`), each exact-validated
    through the scheduling simulation, served per round as masked
    sub-encodes of one base encode (`solver/simulate.ConsolidationSimulator`).
    Escape hatches: `KARPENTER_CONSOLIDATE_LP=0` runs only the reference's
    binary search over the cost-sorted prefix
    (multinodeconsolidation.go:52-191), `KARPENTER_CONSOLIDATE_LP=anneal`
    the annealed subset search (`_annealed_option`); the binary search also
    remains the in-band fallback whenever the device proposer produces no
    valid command, and is the only path with the "ffd" backend. Opt-in
    global repack (`KARPENTER_SOLVER_GLOBALPACK=1`): the global proposer
    runs first, and the two-phase ladder when it yields no valid command.

    When a device proposer fails, the binary search answers only for a
    refusal of the input, never for a broken kernel or device; the arms
    tell the two apart in two ways. The LP and global arms catch the
    reference's ValueError, TypeError and RuntimeError around the whole
    proposer, whose host stages (encode, rounding, ladder) interleave with
    K5 and K6, and re-raise what `kernels.build.device_fault` names a kernel
    or device fault. The anneal arm departs from the reference, which
    catches the same three around `propose_subsets`: it catches them around
    the encoder alone, which runs before K7, so every error from K7's build,
    launch or ladder propagates and no message test is needed.

    Each LP round is one `SolveTrace` (mode "consolidate", backend "lp") on
    the provisioner solver's recorder: the reference's spans
    `encode_candidates`, `lp_repack` and `round` from the proposer (the
    port's stages inside them) and one `validate` per exact probe, with the
    simulator's "sim base", "sim_mask_encode", "solve_prepared" and "sim
    scratch" inside. `last_round` is a view of the newest round's trace."""

    consolidation_type = "multi"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.round_trace = None

    @property
    def last_round(self) -> dict:
        """The newest LP round: its spans' ms by name ("stages"), the number
        of proposals, the accepted subset's size and the probe counts (the
        trace's notes)."""
        tr = self.round_trace
        if tr is None:
            return {}
        a = tr.attribution
        return dict(stages={k: v * 1e3 for k, v in tr.phase_totals.items()}, proposals=a.get("proposals", 0),
                    accepted_subset=a.get("accepted_subset"), sim_masked=a.get("sim_masked", 0),
                    sim_scratch=a.get("sim_scratch", 0), sim_why_scratch=a.get("sim_why_scratch", ""),
                    sched_seed_rejects=a.get("sched_seed_rejects", 0))

    def compute_commands(self, candidates, budgets) -> list[Command]:
        eligible = self.sort_candidates([c for c in candidates if self.should_disrupt(c)])
        # budget filter up-front: take at most allowed per pool
        allowed = dict(budgets)
        filtered = []
        for c in eligible:
            pool = c.node_pool.metadata.name
            if allowed.get(pool, 0) > 0:
                filtered.append(c)
                allowed[pool] -= 1
        # the binary search and the annealed search window over a
        # 100-candidate prefix (multinodeconsolidation.go:35); the LP
        # proposer's device solve scales past the whole fleet and sees every
        # budget-eligible candidate
        filtered_bs = filtered[:MULTI_NODE_CONSOLIDATION_CANDIDATE_CAP]
        if len(filtered_bs) < 2:
            return []
        # ONE 1-minute budget covers the whole multi-node compute — the
        # device search and the binary-search fallback share it
        deadline = self.ctx.clock.now() + MULTI_NODE_CONSOLIDATION_TIMEOUT_SECONDS
        # the device proposers hand back a LAZY ranked ladder — `producer`
        # holds the suspended continuation so a 15s-validation failure can
        # pull the next accepted proposal instead of abandoning the round
        cmd = Command()
        producer = None
        lp_mode = _switch("KARPENTER_CONSOLIDATE_LP", "1")
        gp_mode = _switch("KARPENTER_SOLVER_GLOBALPACK", "0")
        try:
            if getattr(self.ctx.options, "solver_backend", "ffd") == "gpu" and lp_mode not in SWITCH_OFF:
                if gp_mode in SWITCH_ON:
                    producer = self._globalpack_option_iter(filtered, deadline)
                    cmd = next(producer, Command())
                    if not (cmd.candidates and self._passes_balanced(cmd)):
                        cmd = Command()
                        producer.close()
                        producer = None
                if not cmd.candidates:
                    if lp_mode == "anneal":
                        cmd = self._annealed_option(filtered_bs, deadline)
                        if not (cmd.candidates and self._passes_balanced(cmd)):
                            cmd = Command()
                    else:
                        producer = self._lp_option_iter(filtered, deadline)
                        cmd = next(producer, Command())
                        if not (cmd.candidates and self._passes_balanced(cmd)):
                            cmd = Command()
                            producer.close()
                            producer = None
            if not cmd.candidates:
                if self.ctx.clock.now() > deadline:
                    # the device stage consumed the whole budget — don't
                    # start the binary search, and never hand an empty
                    # command to the 15s validator
                    return []
                cmd = self._first_n_consolidation_option(filtered_bs, deadline)
                if not (cmd.candidates and self._passes_balanced(cmd)):
                    return []
            # 15s wait + re-simulation before execution
            # (multinodeconsolidation.go:103, validation.go:192-263). Every
            # emitted command passes this exact gate; when a ranked ladder is
            # live, a rejection falls back to the next accepted proposal
            # (bounded by MULTI_NODE_VALIDATION_ATTEMPTS and the deadline)
            # rather than ending the round empty-handed.
            from .validation import ValidationError, Validator

            validator = Validator(self.ctx, self, mode="strict", metrics=self.ctx.metrics)
            for _attempt in range(MULTI_NODE_VALIDATION_ATTEMPTS):
                try:
                    validator.validate(cmd)
                    return [cmd]
                except ValidationError:
                    if producer is None or self.ctx.clock.now() > deadline:
                        return []
                    cmd = next(producer, Command())
                    if not (cmd.candidates and self._passes_balanced(cmd)):
                        return []
            return []
        finally:
            if producer is not None:
                producer.close()

    def _annealed_option(self, candidates, deadline: float) -> Command:
        """The annealed subset search (`KARPENTER_CONSOLIDATE_LP=anneal`,
        kernel K7 on the provisioner solver's device) + host exact
        validation, under the shared 1-minute compute budget. It is
        `solver.consolidation.propose_subsets` split at the encoder, so that
        only the encoder's refusal falls back (the class docstring gives the
        arms' failure policies)."""
        import logging

        from ... import metrics as m
        from ...solver.consolidation import encode_problem, propose_problem_anneal

        device = getattr(self.ctx.provisioner.solver, "device", None)  # None: the CUDA device
        its = self._candidate_instance_types(candidates)
        try:
            problem = encode_problem(candidates, its)
        except (ValueError, TypeError, RuntimeError) as e:
            logging.getLogger("karpenter.disruption").warning("annealed consolidation search failed, falling back: %s", e)
            return Command()
        proposals = propose_problem_anneal(problem, device)
        if self.ctx.metrics is not None and proposals:
            self.ctx.metrics.counter(m.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).inc(len(proposals), proposer="anneal")
        for subset in proposals:
            if self.ctx.clock.now() > deadline:
                self._count_timeout()
                return Command()
            chosen = [candidates[i] for i in subset]
            cmd = self.compute_consolidation(chosen)
            if cmd.candidates:
                if self._is_pointless_churn(cmd):
                    continue
                if self.ctx.metrics is not None:
                    self.ctx.metrics.gauge(m.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).set(
                        _command_savings_per_hour(cmd), proposer="anneal"
                    )
                return cmd
        return Command()

    def _candidate_instance_types(self, candidates) -> list:
        pools = {c.node_pool.metadata.name: c.node_pool for c in candidates}
        its = []
        for name in pools:
            its.extend(self.ctx.provisioner.cloud_provider.get_instance_types(pools[name]))
        return its

    def _lp_option(self, candidates, deadline: float) -> Command:
        """Best accepted command from the ranked LP ladder (the surface over
        `_lp_option_iter` for callers that want exactly one proposal)."""
        it = self._lp_option_iter(candidates, deadline)
        try:
            for cmd in it:
                return cmd
            return Command()
        finally:
            it.close()

    def _lp_option_iter(self, candidates, deadline: float):
        """The relaxed-LP repack proposer as a lazy ladder: yields every
        exactly-simulated ACCEPTED command in the proposer's ranked
        (best-first) order. The happy path pulls ONE command, hands it to
        the 15s exact Validator, and never simulates the rest; a validation
        failure resumes the generator to pull the next accepted proposal.
        The proposer runs on the provisioner solver's device. The whole
        round is flight-recorded as one mode="consolidate" SolveTrace
        (`encode_candidates` / `lp_repack` / `round` inside
        `propose_subsets_lp`, one "validate" span per exact probe — NOT
        around the yields, so the Validator's 15s wait while the generator
        is suspended never accrues into the phase split), and every
        proposal's simulation runs through the round's
        ConsolidationSimulator (masked sub-encodes where its envelope
        allows, from scratch otherwise) and its shared SchedulerRoundSeed."""
        import logging

        from ... import metrics as m
        from ...kernels.build import device_fault
        from ...obs.trace import default_recorder
        from ...solver.consolidation import LP_SOLVE_ITERATIONS, propose_subsets_lp
        from ...solver.simulate import ConsolidationSimulator

        ctx = self.ctx
        solver = ctx.provisioner.solver
        device = getattr(solver, "device", None)  # None: the CUDA device
        sync = bool(getattr(solver, "stage_times", False))
        recorder = getattr(solver, "recorder", None) or default_recorder()
        n_pods = sum(len(c.reschedulable_pods) for c in candidates)
        with recorder.flight(n_pods=n_pods, mode="consolidate", backend="lp", registry=ctx.metrics) as trace:
            self.round_trace = trace
            reuse = ConsolidationSimulator(ctx.provisioner, ctx.cluster, ctx.clock, candidates, trace=trace)
            try:
                its = self._candidate_instance_types(candidates)
                try:
                    proposals = propose_subsets_lp(candidates, its, device=device, trace=trace, sync=sync)
                except (ValueError, TypeError, RuntimeError) as e:
                    # a kernel's or the device's failure fails the round: the
                    # binary search never answers for a broken K5 or K6
                    if device_fault(e, device or "cuda"):
                        raise
                    logging.getLogger("karpenter.disruption").warning(
                        "LP consolidation repack failed, falling back: %s", e
                    )
                    return
                if ctx.metrics is not None and proposals:
                    ctx.metrics.counter(m.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).inc(len(proposals), proposer="lp")
                    ctx.metrics.counter(m.SOLVER_CONSOLIDATION_LP_ITERATIONS_TOTAL).inc(LP_SOLVE_ITERATIONS)
                trace.note(proposals=len(proposals))
                for subset in proposals:
                    if ctx.clock.now() > deadline:
                        self._count_timeout()
                        return
                    chosen = [candidates[i] for i in subset]
                    with trace.span("validate"):
                        cmd = self.compute_consolidation(chosen, reuse=reuse)
                        accepted = bool(cmd.candidates) and not self._is_pointless_churn(cmd)
                    if ctx.metrics is not None:
                        ctx.metrics.counter(m.SOLVER_CONSOLIDATION_VALIDATION_TOTAL).inc(
                            decision="accept" if accepted else "reject"
                        )
                    if accepted:
                        if ctx.metrics is not None:
                            ctx.metrics.gauge(m.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).set(
                                _command_savings_per_hour(cmd), proposer="lp"
                            )
                        trace.note(accepted_subset=len(subset))
                        yield cmd
            finally:
                trace.note(
                    sim_masked=reuse.masked_probes,
                    sim_scratch=reuse.scratch_probes,
                    sim_why_scratch=reuse.why_scratch,
                    sched_seed_rejects=len(reuse.sched_seed.static_rejects) if reuse.sched_seed is not None else 0,
                )

    def _globalpack_option(self, candidates, deadline: float) -> Command:
        """Best accepted command from the global-repack ladder (compat
        surface over `_globalpack_option_iter`, mirrors `_lp_option`)."""
        it = self._globalpack_option_iter(candidates, deadline)
        try:
            for cmd in it:
                return cmd
            return Command()
        finally:
            it.close()

    def _globalpack_option_iter(self, candidates, deadline: float):
        """The GLOBAL repack proposer as the same lazy accepted-command
        ladder as `_lp_option_iter`: one relaxed solve over pending
        placement + retirement on the provisioner solver's device (K5, K6),
        then exact simulation per pulled proposal only — the round's
        ConsolidationSimulator already carries the pending pods in every
        probe, so a yielded command is exact for BOTH sides of the joint
        objective. Flight-recorded as one mode="consolidate" SolveTrace with
        backend "globalpack"; publishes the bounded karpenter_solver_
        globalpack_* family and rides the proposer="globalpack" enum value.
        A kernel's or the device's failure fails the round."""
        import logging

        from ... import metrics as m
        from ...kernels.build import device_fault
        from ...obs.trace import default_recorder
        from ...solver.consolidation import LP_SOLVE_ITERATIONS, propose_subsets_global
        from ...solver.simulate import ConsolidationSimulator

        ctx = self.ctx
        solver = ctx.provisioner.solver
        device = getattr(solver, "device", None)  # None: the CUDA device
        sync = bool(getattr(solver, "stage_times", False))
        recorder = getattr(solver, "recorder", None) or default_recorder()
        n_pods = sum(len(c.reschedulable_pods) for c in candidates)
        with recorder.flight(n_pods=n_pods, mode="consolidate", backend="globalpack", registry=ctx.metrics) as trace:
            self.round_trace = trace
            reuse = ConsolidationSimulator(ctx.provisioner, ctx.cluster, ctx.clock, candidates, trace=trace)
            try:
                its = self._candidate_instance_types(candidates)
                pending = ctx.provisioner.get_pending_pods()
                try:
                    proposals, info = propose_subsets_global(candidates, its, pending_pods=pending, device=device,
                                                             trace=trace, sync=sync)
                except (ValueError, TypeError, RuntimeError) as e:
                    if device_fault(e, device or "cuda"):
                        raise
                    logging.getLogger("karpenter.disruption").warning(
                        "global repack failed, falling back to two-phase: %s", e
                    )
                    return
                if ctx.metrics is not None:
                    ctx.metrics.counter(m.SOLVER_GLOBALPACK_ROUNDS_TOTAL).inc()
                    ctx.metrics.counter(m.SOLVER_GLOBALPACK_ITERATIONS_TOTAL).inc(LP_SOLVE_ITERATIONS)
                    ctx.metrics.gauge(m.SOLVER_GLOBALPACK_OBJECTIVE_IMPROVEMENT).set(info["objective_improvement"])
                    if proposals:
                        ctx.metrics.counter(m.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).inc(
                            len(proposals), proposer="globalpack"
                        )
                trace.note(proposals=len(proposals))
                for subset in proposals:
                    if ctx.clock.now() > deadline:
                        self._count_timeout()
                        return
                    chosen = [candidates[i] for i in subset]
                    with trace.span("validate"):
                        cmd = self.compute_consolidation(chosen, reuse=reuse)
                        accepted = bool(cmd.candidates) and not self._is_pointless_churn(cmd)
                    if ctx.metrics is not None:
                        ctx.metrics.counter(m.SOLVER_CONSOLIDATION_VALIDATION_TOTAL).inc(
                            decision="accept" if accepted else "reject"
                        )
                    if accepted:
                        if ctx.metrics is not None:
                            ctx.metrics.gauge(m.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).set(
                                _command_savings_per_hour(cmd), proposer="globalpack"
                            )
                        trace.note(accepted_subset=len(subset))
                        yield cmd
            finally:
                trace.note(
                    sim_masked=reuse.masked_probes,
                    sim_scratch=reuse.scratch_probes,
                    sim_why_scratch=reuse.why_scratch,
                    sched_seed_rejects=len(reuse.sched_seed.static_rejects) if reuse.sched_seed is not None else 0,
                )

    @staticmethod
    def _is_pointless_churn(cmd: Command) -> bool:
        """Replacing with a node priced equal to one being removed is churn
        (multinodeconsolidation.go:150-170)."""
        if not cmd.replacements:
            return False
        rep = _replacement_price(cmd)
        return any(abs(c.price - rep) < 1e-9 for c in cmd.candidates)

    def _first_n_consolidation_option(self, candidates, deadline: float | None = None) -> Command:
        """firstNConsolidationOption (multinodeconsolidation.go:117-191): binary
        search on batch size under a 1-minute budget — on timeout return the
        last valid command found (or nothing)."""
        from ... import metrics as m

        min_n, max_n = 1, len(candidates)
        last_valid = Command()
        if deadline is None:
            deadline = self.ctx.clock.now() + MULTI_NODE_CONSOLIDATION_TIMEOUT_SECONDS
        while min_n <= max_n:
            if self.ctx.clock.now() > deadline:
                self._count_timeout()
                return last_valid
            mid = (min_n + max_n) // 2
            if self.ctx.metrics is not None:
                self.ctx.metrics.counter(m.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).inc(proposer="binary-search")
            cmd = self.compute_consolidation(candidates[: mid + 1])
            if not cmd.candidates:
                max_n = mid - 1
                continue
            if self._is_pointless_churn(cmd):
                max_n = mid - 1
                continue
            last_valid = cmd
            min_n = mid + 1
        if last_valid.candidates and self.ctx.metrics is not None:
            self.ctx.metrics.gauge(m.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).set(
                _command_savings_per_hour(last_valid), proposer="binary-search"
            )
        return last_valid


def _filter_by_price(replacement, max_price: float):
    """Instance types strictly cheaper than max_price, preserving minValues
    satisfiability; returns [] when impossible."""
    from ...cloudprovider.types import satisfies_min_values

    kept = []
    for it in replacement.instance_type_options:
        compat = [
            o
            for o in it.offerings
            if o.available and replacement.requirements.intersects(o.requirements) is None
        ]
        if compat and min(o.price for o in compat) < max_price:
            kept.append(it)
    if kept and replacement.requirements.has_min_values():
        _, unsat = satisfies_min_values(kept, replacement.requirements)
        if unsat:
            return []
    return kept


def _command_savings_per_hour(command: Command) -> float:
    """Hourly price removed minus the replacement's cheapest launch price
    (the reference's `karpenter_solver_consolidation_savings_per_hour`)."""
    if not command.candidates:
        return 0.0
    removed = sum(c.price for c in command.candidates)
    return removed - (_replacement_price(command) if command.replacements else 0.0)


def _replacement_price(command: Command) -> float:
    total = 0.0
    for nc in command.replacements:
        best = float("inf")
        for it in nc.instance_type_options:
            for o in it.offerings:
                if o.available and nc.requirements.intersects(o.requirements) is None and o.price < best:
                    best = o.price
        if best < float("inf"):
            total += best
    return total
