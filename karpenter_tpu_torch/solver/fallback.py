"""Fallback-reason families and their hybrid-solve tiers.

Every reason string `check_capability` (and the solver's own validation /
relaxation exits) can emit maps to exactly one FAMILY — a stable,
low-cardinality label for metrics — and every family maps to a TIER that
tells `TPUSolver.solve` how much of the snapshot the reason poisons:

- ``pod-local``: the constraint is attributable to the offending pod's spec
  signature alone (preferred affinity, multi-term affinity, explicit
  namespaces, multi-domain-key spreads, ...). The snapshot can be
  PARTITIONED: the tensor pack handles the majority and the exact host FFD
  solves just the flagged residual against the tensor result's node state.
  The per-signature attribution also powers the hybrid-delta mode (the
  tensor side is `encode.mask_encode` over the unflagged signatures, and a
  removal delta that vacates every flagged signature re-derives the reason
  set as empty) — see TPUSolver._solve_masked_delta.
- ``global``: the reason invalidates tensor semantics for the whole snapshot
  (kernel validation failures, asymmetric (anti-)affinity memberships,
  relaxation exits, store-less PVC snapshots, ...) — the entire solve runs
  on the host FFD.

Families that used to be global and are now pod-local-or-better:

- ``min-values`` no longer demotes anything: NodePool minValues is fully
  tensorized as a DECODE-TIME relaxation (TPUSolver._enforce_min_values) —
  the pack runs unconstrained, each produced NodeClaim re-checks
  ``satisfies_min_values`` over its post-filter instance types, widens
  decode-pinned domain keys when that restores flexibility, relaxes under
  the BestEffort policy, and routes the (rare) irreparable claims' pods
  through a bounded host repair (ffd.solve_residual).
- ``asymmetric-spread-membership`` carries per-signature attribution: the
  encode flags every signature the asymmetric selector matches OR declares,
  so the whole coupled membership set routes to the host residual together.
- ``strict-reserved-offering`` flags only the signatures whose requirements
  can reach reserved capacity; signatures pinned away from it ride the
  tensor path (decode's reservation cap never touches them).
- in-window topology SPREAD groups may span the hybrid seam: the solver
  exports the tensor side's per-(key, domain) occupancy into the residual
  scheduler's Topology (tpu._seam_records), so coupled spreads split
  cleanly instead of forcing the whole-snapshot FFD.

This module is import-cycle-free on purpose: both the encode layer (which
attributes reasons to signatures) and the solver core (which partitions and
labels metrics) read it.

Registry integrity — every family tiered, every GLOBAL entry justified by a
comment, no stale entries — is machine-checked by solverlint's
``reason-family-tiers`` rule (``python -m karpenter_tpu.analysis``, gated in
tier-1 by tests/test_solverlint.py; tests/test_solve_modes.py keeps only the
behavior pins). Edit this table and the analyzer tells you what you forgot.
"""

from __future__ import annotations

POD_LOCAL = "pod-local"
GLOBAL = "global"

# fixed enum of fallback families: metric labels must be bounded, and reasons
# embed pod keys / topology keys. Needles are matched IN ORDER — keep the
# more specific needle ("asymmetric pod affinity") before its substring
# family ("pod affinity").
REASON_FAMILIES = (
    ("validation", "validation"),
    ("relaxation required", "relaxation"),
    ("minValues", "min-values"),
    ("asymmetric pod affinity", "asymmetric-pod-affinity"),
    ("asymmetric anti-affinity", "asymmetric-anti-affinity"),
    ("asymmetric spread membership", "asymmetric-spread-membership"),
    ("pod affinity", "pod-affinity"),
    ("combined keyed anti-affinity", "combined-keyed-anti-affinity"),
    ("anti-affinity with explicit namespaces", "anti-affinity-namespaces"),
    ("preferred anti-affinity", "preferred-anti-affinity"),
    ("relaxable node affinity", "relaxable-node-affinity"),
    ("ScheduleAnyway", "schedule-anyway-spread"),
    ("multiple domain keys", "multi-domain-keys"),
    ("spread taint policy", "spread-taint-policy"),
    ("node-filtered spread", "node-filtered-spread"),
    ("pvc multi-alternative topology", "pvc-multi-alternative"),
    ("volume topology overlaps spread key", "pvc-spread-overlap"),
    ("shared with", "pvc-shared-claim"),
    ("already attached", "pvc-already-attached"),
    ("PVC-backed volumes", "pvc-volumes"),
    ("dynamic resource claims", "dra-claims"),
    ("running pods with required anti-affinity", "running-anti-affinity"),
    ("strict reserved-offering", "strict-reserved-offering"),
    ("empty", "empty"),
)

# tier per family. "other" (an unrecognized reason) is deliberately GLOBAL:
# an unattributable reason must take the conservative whole-snapshot path.
# Every GLOBAL entry carries a one-line justification (enforced by
# tests/test_solve_modes.py's mechanical walker).
FAMILY_TIERS: dict[str, str] = {
    # a failed kernel self-check taints the whole device placement
    "validation": GLOBAL,
    # relaxation peels constraints pod-by-pod in a stateful host loop
    "relaxation": GLOBAL,
    # tensorized: decode-time relaxation + bounded host repair
    # (TPUSolver._enforce_min_values) — no reason is emitted anymore
    "min-values": POD_LOCAL,
    # an uncommitted declarer blocks matched pods via inverse semantics the
    # per-signature masks cannot express mid-solve
    "asymmetric-pod-affinity": GLOBAL,
    "asymmetric-anti-affinity": GLOBAL,
    # attribution flags the full matched+declaring membership set, so the
    # host residual sees every coupled pod
    "asymmetric-spread-membership": POD_LOCAL,
    "pod-affinity": POD_LOCAL,
    "combined-keyed-anti-affinity": POD_LOCAL,
    "anti-affinity-namespaces": POD_LOCAL,
    "preferred-anti-affinity": POD_LOCAL,
    "relaxable-node-affinity": POD_LOCAL,
    "schedule-anyway-spread": POD_LOCAL,
    "multi-domain-keys": POD_LOCAL,
    "spread-taint-policy": POD_LOCAL,
    "node-filtered-spread": POD_LOCAL,
    "pvc-multi-alternative": POD_LOCAL,
    "pvc-spread-overlap": POD_LOCAL,
    # cross-pod claim sharing / attachment dedupe needs the host's
    # count-distinct semantics for EVERY holder of the claim; the encode
    # attributes the reason to every holder's signature, so routing those
    # signatures (all of them) to the host residual is sound
    "pvc-shared-claim": POD_LOCAL,
    "pvc-already-attached": POD_LOCAL,
    # no store: the snapshot cannot resolve any volume component
    "pvc-volumes": GLOBAL,
    "dra-claims": POD_LOCAL,
    # running-pod anti-affinity reported as a REASON means the static
    # blocked-mask lowering could not express it for the whole snapshot
    "running-anti-affinity": GLOBAL,
    # flags only signatures whose requirements can reach reserved capacity;
    # the sequential reservation accounting runs host-side on those alone
    "strict-reserved-offering": POD_LOCAL,
    # nothing to partition in an empty snapshot
    "empty": GLOBAL,
    # an unattributable reason must take the conservative whole-snapshot path
    "other": GLOBAL,
}


def reason_family(reason: str) -> str:
    """Stable low-cardinality label for a fallback reason."""
    for needle, family in REASON_FAMILIES:
        if needle in reason:
            return family
    return "other"


def is_pod_local(family: str) -> bool:
    return FAMILY_TIERS.get(family, GLOBAL) == POD_LOCAL
