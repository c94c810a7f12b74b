"""Disruption command validation: wait, rebuild, re-simulate, re-check.

Reference: disruption/validation.go:116-355 + consolidation.go:45
(commandValidationDelay = 15s). Before any consolidation/emptiness command
executes, the validator waits out the validation window, then:

  a. rebuilds candidates from live cluster state and re-applies the method's
     filter — churn (a pod scheduled to a candidate, a condition cleared)
     invalidates it;
  b. re-checks pod nominations and disruption budgets, consuming budget per
     candidate;
  c. (consolidation only) re-runs the scheduling simulation and requires the
     same shape of result: every reschedulable pod placed, the same number of
     replacement nodes, and the command's replacement instance types a subset
     of what the fresh simulation allows (the simulation does no price
     filtering, so subset == still at-most-as-expensive);
  d. re-validates candidates once more after the simulation (reference
     mitigation for kubernetes-sigs/karpenter#1167).

The wait is `clock.sleep`: wall-clock in production, a deterministic step on
the FakeClock (tests interleave churn by subclassing sleep()).
"""

from __future__ import annotations

from .helpers import all_non_pending_scheduled, build_disruption_budget_mapping, simulate_scheduling
from .types import Command

VALIDATION_DELAY_SECONDS = 15.0  # consolidation.go:45


class ValidationError(Exception):
    """kind: churn | nominated | budget | scheduling (validation.go:358-380)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


class Validator:
    """mode="strict": every candidate must re-validate and the command is
    re-simulated (consolidation, validation.go:192-263). mode="subset": the
    command shrinks to the candidates that survive (emptiness,
    validation.go:134-148,223-252)."""

    def __init__(self, ctx, method, mode: str, metrics=None):
        self.ctx = ctx
        self.method = method
        self.mode = mode
        self.metrics = metrics

    def _count_failure(self, n: int = 1) -> None:
        if self.metrics is not None:
            from ... import metrics as m

            self.metrics.counter(m.DISRUPTION_FAILED_VALIDATIONS_TOTAL).inc(
                n, method=getattr(self.method, "consolidation_type", "") or type(self.method).__name__
            )

    def validate(self, cmd: Command, delay_seconds: float = VALIDATION_DELAY_SECONDS) -> Command:
        """Returns the validated command or raises ValidationError."""
        if not cmd.candidates:
            # a commandless validate can only ever raise — don't pay the 15s
            # wait to learn it. Same outcome (_count_failure bump + churn
            # raise) that _validate_candidates([]) produces after the sleep.
            self._count_failure(0)
            raise ValidationError("churn", "0 candidates are no longer valid")
        if delay_seconds > 0:
            self.ctx.clock.sleep(delay_seconds)
        validated = self._validate_candidates(cmd.candidates)
        if self.mode == "strict":
            self._validate_command(cmd, validated)
            # re-validate after the simulation (validation.go:215-219)
            validated = self._validate_candidates(validated)
            return cmd
        return Command(reason=cmd.reason, candidates=validated, replacements=cmd.replacements, results=cmd.results)

    def _validate_candidates(self, candidates: list) -> list:
        fresh = {c.name(): c for c in self.ctx.get_candidates() if self.method.should_disrupt(c)}
        mapped = [fresh[c.name()] for c in candidates if c.name() in fresh]
        if self.mode == "strict" and len(mapped) != len(candidates):
            self._count_failure(len(candidates))
            raise ValidationError("churn", f"{len(candidates) - len(mapped)} candidates are no longer valid")
        if not mapped:
            self._count_failure(len(candidates))
            raise ValidationError("churn", f"{len(candidates)} candidates are no longer valid")
        budgets = build_disruption_budget_mapping(self.ctx.store, self.ctx.cluster, self.ctx.clock, self.method.reason)
        now = self.ctx.clock.now()
        valid = []
        for c in mapped:
            sn = c.state_node
            if sn.nominated(now):
                if self.mode == "strict":
                    self._count_failure(len(candidates))
                    raise ValidationError("nominated", f"candidate {c.name()} was nominated during validation")
                self._count_failure()
                continue
            pool = c.node_pool.metadata.name
            if budgets.get(pool, 0) <= 0:
                if self.mode == "strict":
                    self._count_failure(len(candidates))
                    raise ValidationError("budget", f"disrupting {c.name()} would violate {pool}'s budget")
                self._count_failure()
                continue
            budgets[pool] -= 1
            valid.append(c)
        if not valid:
            self._count_failure(len(candidates))
            raise ValidationError("budget", "no candidate can be disrupted within budgets")
        return valid

    def _validate_command(self, cmd: Command, candidates: list) -> None:
        """Re-simulate against CURRENT state; the result must still justify
        the command (validation.go:297-355)."""
        if not candidates:
            raise ValidationError("churn", "no candidates")
        results = simulate_scheduling(self.ctx.provisioner, self.ctx.cluster, candidates, self.ctx.clock)
        if not all_non_pending_scheduled(results, candidates):
            self._count_failure(len(cmd.candidates))
            raise ValidationError("scheduling", results.non_pending_pod_scheduling_errors())
        n_new = len(results.new_node_claims)
        if n_new == 0:
            if not cmd.replacements:
                return  # delete-only command still needs no replacement: valid
            self._count_failure(len(cmd.candidates))
            raise ValidationError("scheduling", "simulation no longer needs a replacement node")
        if n_new > 1 or not cmd.replacements:
            self._count_failure(len(cmd.candidates))
            raise ValidationError("scheduling", "scheduling simulation produced new results")
        # the command's launchable types must be a subset of what the fresh
        # simulation allows — subset == no pricier than planned
        sim_names = {it.name for it in results.new_node_claims[0].instance_type_options}
        if not all(it.name in sim_names for it in cmd.replacements[0].instance_type_options):
            self._count_failure(len(cmd.candidates))
            raise ValidationError("scheduling", "scheduling simulation produced new results")
