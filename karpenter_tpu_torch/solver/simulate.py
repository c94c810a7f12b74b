"""Consolidation simulation reuse: one base encode per round, one masked
sub-encode per candidate batch.

Every consolidation probe — the LP proposer's per-proposal exact check, the
binary search's per-step check — is a full scheduling simulation
(`controllers/disruption/helpers.simulate_scheduling`): clone state minus
the candidates, add their reschedulable pods to the pending set, Solve. At
fleet scale the dominant cost of each probe is the HOST ENCODE (the row side
re-interns every surviving node because the row cache keys on the exact
state-node set), paid from scratch per probe even though probes within one
round differ only in which candidate rows vanish and which evicted pods
appear.

`ConsolidationSimulator` hoists that cost to once per round: it encodes the
ROUND-BASE snapshot (every eligible node INCLUDING all candidates as rows;
pending + deleting + every candidate's reschedulable pods as the solve set),
then serves each probe as `encode.sim_mask_encode` — a pod-level mask of the
base's per-signature tensors plus a capacity block on the batch's candidate
rows — handed to `GPUSolver.solve_prepared`: the hybrid solve's trick
(mask the encode, re-pack only what differs), applied to the disruption
controller's hot loop.

TOPOLOGY AND INVERSE ANTI-AFFINITY are probe-dependent (a surviving
candidate's bound pods count toward group skews and block anti-affinity
peers; a deleted one's don't). The per-node decomposition handles them: at
base time the
round decomposes every candidate's bound-pod contribution to each group's
counts (`encode.sim_group_count_contrib`) and each reschedulable
required-anti pod into inverse blocking entries
(`encode.sim_inverse_entries_for`); per probe the simulator assembles the
EXACT from-scratch group counts / registries / inverse blocks by
adding the surviving candidates' contributions and dropping the batch's
(including the deleted nodes' domains from each registry), handing them to
`sim_mask_encode` as overrides.

CORRECTNESS ENVELOPE — the masked path engages only when it is placement-
equivalent to the from-scratch simulation, checked once per round on the
base encode:

  * clean capability report (no fallback reasons: no flagged families whose
    host handling could depend on the probe's node set),
  * no HOSTNAME-spread groups (a blocked row is an extra zero-count
    hostname domain the from-scratch probe never sees, which skews the
    spread minimum),
  * no candidate-only topology domains while groups exist (a from-scratch
    probe without that candidate never interns the domain, so bound pods
    counted into it would diverge),
  * the provisioner's solver exposes the tensor path (`solve_prepared`).

Anything outside the envelope — and any probe whose masked solve falls off
the tensor path — takes `simulate_scheduling` from scratch, which remains
the exact authority (`last_mode` records which path served each probe). The
15s command Validator ALWAYS re-simulates from live state without a
simulator, so executed commands never depend on this reuse at all.
"""

from __future__ import annotations

import os

import numpy as np

from ..controllers.provisioning.scheduling.scheduler import SchedulerRoundSeed
from ..utils import pods as pod_utils


def _shared_sched_enabled() -> bool:
    """KARPENTER_SIM_SHARED_SCHED (default on), read at each round's
    simulator: "0", "false" or "off" builds every scratch probe's scheduler
    from nothing (`sched_seed` None)."""
    return os.environ.get("KARPENTER_SIM_SHARED_SCHED", "1").strip().lower() not in ("0", "false", "off")


def _pending_and_deleting(provisioner, cluster, exclude_names: set) -> tuple[list, list, list]:
    """The probe-invariant parts of simulate_scheduling's snapshot: pending
    pods, pods on OTHER deleting nodes, and the eligible state nodes
    (every not-deleting node, candidates included)."""
    all_nodes = cluster.nodes_view()
    state_nodes = [n for n in all_nodes if not n.marked_for_deletion and not n.deleted()]
    pending = provisioner.get_pending_pods()
    deleting_pods = []
    for n in all_nodes:
        if (n.marked_for_deletion or n.deleted()) and n.name() not in exclude_names:
            for key in n.pod_requests:
                ns, name = key.split("/", 1)
                pod = provisioner.store.try_get("Pod", name, ns)
                if pod is not None and pod_utils.is_reschedulable(pod):
                    deleting_pods.append(pod)
    return pending, deleting_pods, state_nodes


class ConsolidationSimulator:
    """Per-round masked-sub-encode scheduling simulations (module docstring).

    Build one per consolidation round over the round's candidate set; call
    `simulate(batch)` for each probe (batch must be a subset of the round's
    candidates — anything else routes to the from-scratch path). With a
    `trace` (the round's `obs.trace.SolveTrace`) its stages are spans there:
    "sim base" (the round-base encode), "sim_mask_encode" and
    "solve_prepared" per masked probe (each `solve_prepared` also records
    its own trace, mode "sim"), "sim scratch" per from-scratch one; the
    solver's `stage_times` synchronises its device at their edges."""

    def __init__(self, provisioner, cluster, clock, candidates, trace=None):
        from .consolidation import Stages

        solver = provisioner.solver
        self._stage = Stages(trace, getattr(solver, "device", None), bool(getattr(solver, "stage_times", False)))
        self.provisioner = provisioner
        self.cluster = cluster
        self.clock = clock
        self.candidates = list(candidates)
        self._names = {c.name() for c in self.candidates}
        self._base = None  # lazily: dict | False (ineligible)
        self._why = ""  # why the masked path disengaged
        self.last_mode = ""  # "masked" | "scratch" — per-probe attribution
        self.masked_probes = 0
        self.scratch_probes = 0
        # one SchedulerRoundSeed shared by every scratch probe of this round:
        # probe-invariant host-scheduler layers (PodData, signatures, and
        # version-0 static rejects) carry across builds instead of being
        # re-derived per probe. KARPENTER_SIM_SHARED_SCHED=0 is the exact-
        # reference escape hatch (placements are identical either way — the
        # carry only skips re-deriving verdicts that cannot differ).
        self.sched_seed = SchedulerRoundSeed() if _shared_sched_enabled() else None

    @property
    def why_scratch(self) -> str:
        return self._why

    # -- round-base construction ----------------------------------------------
    def _ineligible(self, why: str):
        self._base = False
        self._why = why
        return False

    def _build_base(self):
        if self._base is not None:
            return self._base
        with self._stage("sim base"):
            return self._build_base_inner()

    def _build_base_inner(self):
        solver = self.provisioner.solver
        if not hasattr(solver, "solve_prepared") or not hasattr(solver, "encode_cache"):
            return self._ineligible("solver has no tensor path")
        pending, deleting_pods, state_nodes = _pending_and_deleting(
            self.provisioner, self.cluster, self._names
        )
        evicted = [p for c in self.candidates for p in c.reschedulable_pods]
        base_pods = pending + deleting_pods + evicted
        if not base_pods:
            return self._ineligible("no pods to simulate")
        snap = self.provisioner.make_snapshot(base_pods, state_nodes=state_nodes)
        snap.enforce_consolidate_after = True
        snap.reserved_offering_mode = "strict"
        snap.collect_zone_metrics = False
        from .encode import EncodeCache, encode

        try:
            enc = encode(snap, cache=EncodeCache())  # private: never disturbs the live delta slot
        except (ValueError, TypeError, RuntimeError) as e:
            return self._ineligible(f"base encode failed: {e}")
        if enc.fallback_reasons:
            return self._ineligible(f"base encode flagged: {enc.fallback_reasons[:2]}")
        if enc.n_rows == 0 or enc.n_pods == 0:
            return self._ineligible("empty base encode")

        row_of = {}
        for j in range(enc.n_existing):
            if enc.row_meta[j][0] == "existing":
                row_of[enc.row_meta[j][1].name()] = j
        cand_rows = {}
        for c in self.candidates:
            j = row_of.get(c.name())
            if j is None:
                return self._ineligible("candidate node missing from base rows")
            cand_rows[c.name()] = j

        group_state = self._decompose_groups(enc, cand_rows)
        if group_state is False:
            return False  # _decompose_groups already recorded why

        # surviving candidates' reschedulable required-anti pods are RUNNING
        # inverse blockers in every probe that keeps them (solve pods in the
        # base, so the base encode carries no entry for them)
        from .encode import sim_inverse_entries_for

        cand_inverse = {}
        for c in self.candidates:
            anti = [
                p
                for p in c.reschedulable_pods
                if p.spec.affinity is not None and getattr(p.spec.affinity, "pod_anti_affinity_required", None)
            ]
            if anti:
                cand_inverse[c.name()] = sim_inverse_entries_for(
                    self.provisioner.store, anti, c.state_node.labels(), c.name()
                )

        idx_of = {id(p): i for i, p in enumerate(enc.pods)}
        if len(idx_of) != len(enc.pods):
            return self._ineligible("duplicate pod objects in base")
        self._base = dict(
            snap=snap,
            enc=enc,
            idx_of=idx_of,
            invariant_idx=[idx_of[id(p)] for p in pending + deleting_pods if id(p) in idx_of],
            cand_rows=cand_rows,
            group_state=group_state,
            cand_inverse=cand_inverse,
        )
        return self._base

    def _decompose_groups(self, enc, cand_rows):
        """Per-candidate decomposition of bound-pod group counts (module
        docstring): returns None (no groups), False (ineligible — reason
        recorded), or the dict of base totals + per-candidate contributions
        `simulate` assembles probe counts from."""
        if not enc.n_groups:
            return None
        from .encode import KIND_HOST_SPREAD, sim_group_count_contrib

        if (np.asarray(enc.group_kind) == KIND_HOST_SPREAD).any():
            return self._ineligible("hostname spread groups present")
        if enc.universe_dom is None:
            return self._ineligible("base encode lacks a domain universe")
        Kd = len(enc.dom_key_names)
        D = enc.universe_dom.shape[0]
        dom_occ = np.zeros(D, dtype=np.int64)
        row_doms: dict[int, np.ndarray] = {}
        for j in range(enc.n_existing):
            if enc.row_meta[j][0] != "existing":
                continue
            ds = np.unique(enc.row_dom[j])
            ds = ds[ds >= Kd]  # ids < Kd are the per-key absent sentinels
            row_doms[j] = ds
            dom_occ[ds] += 1
        for name, j in cand_rows.items():
            ds = row_doms.get(j)
            if ds is not None and ds.size and ((dom_occ[ds] == 1) & ~enc.universe_dom[ds]).any():
                return self._ineligible("candidate-only topology domain")
        # "every candidate survives" totals; probes subtract the batch's
        cdi_all = np.array(enc.counts_dom_init, dtype=np.int64)
        che_all = np.array(enc.counts_host_existing, dtype=np.int64)
        cand_dom: dict[str, list] = {}
        cand_host: dict[str, list] = {}
        for c in self.candidates:
            j = cand_rows[c.name()]
            dom_list, host_list = sim_group_count_contrib(enc, c.reschedulable_pods, j)
            cand_dom[c.name()] = dom_list
            cand_host[c.name()] = host_list
            for g, did, n in dom_list:
                cdi_all[g, did] += n
            for g, n in host_list:
                che_all[g, j] += n
        return dict(
            cdi_all=cdi_all,
            che_all=che_all,
            dom_occ=dom_occ,
            row_doms=row_doms,
            cand_dom=cand_dom,
            cand_host=cand_host,
        )

    def _probe_group_counts(self, enc, base, batch_names):
        """Assemble the EXACT from-scratch group state for one probe: counts
        include surviving candidates' bound pods and not the batch's; the
        registry loses the batch nodes' existing-node domains (and keeps
        every domain that still counts pods)."""
        gs = base["group_state"]
        if gs is None:
            return None
        cdi = gs["cdi_all"].copy()
        che = gs["che_all"].copy()
        occ = gs["dom_occ"].copy()
        for name in batch_names:
            j = base["cand_rows"][name]
            for g, did, n in gs["cand_dom"][name]:
                cdi[g, did] -= n
            che[:, j] = 0  # the blocked row is absent from-scratch
            ds = gs["row_doms"].get(j)
            if ds is not None:
                occ[ds] -= 1
        existing_dom = occ > 0
        dko = np.asarray(enc.dom_key_of)
        G = enc.n_groups
        reg = np.zeros((G, existing_dom.shape[0]), dtype=bool)
        for g in range(G):
            dk = int(enc.group_dom_key[g])
            if dk >= 0:
                reg[g] = (enc.universe_dom | existing_dom) & (dko == dk)
        reg |= cdi > 0
        return (cdi.astype(np.int32), che.astype(np.int32), reg)

    # -- probes ----------------------------------------------------------------
    def _scratch(self, batch):
        from ..controllers.disruption.helpers import simulate_scheduling

        self.last_mode = "scratch"
        self.scratch_probes += 1
        with self._stage("sim scratch"):
            return simulate_scheduling(self.provisioner, self.cluster, batch, self.clock, sched_seed=self.sched_seed)

    def simulate(self, batch):
        base = self._build_base()
        if not base or any(c.name() not in self._names for c in batch):
            return self._scratch(batch)
        enc = base["enc"]
        idx_of = base["idx_of"]
        keep = list(base["invariant_idx"])
        ok = True
        for c in batch:
            for p in c.reschedulable_pods:
                i = idx_of.get(id(p))
                if i is None:
                    ok = False
                    break
                keep.append(i)
        if not ok or not keep:
            return self._scratch(batch)
        batch_names = {c.name() for c in batch}
        from .encode import sim_mask_encode

        entries = []
        for name, es in base["cand_inverse"].items():
            if name not in batch_names:  # surviving candidates block; deleted ones evict
                entries.extend(es)
        try:
            with self._stage("sim_mask_encode"):
                sim_enc = sim_mask_encode(
                    enc,
                    keep,
                    batch_names,
                    group_counts=self._probe_group_counts(enc, base, batch_names),
                    inverse_entries=entries or None,
                )
        except (ValueError, TypeError):  # flagged sig / out-of-range: exact path decides
            return self._scratch(batch)

        # the TRUE probe snapshot — identical to simulate_scheduling's; any
        # fallback from the masked solve re-solves THIS from scratch
        probe_nodes = [sn for sn in base["snap"].state_nodes if sn.name() not in batch_names]
        probe_snap = base["snap"].with_pods(sim_enc.pods)
        import dataclasses

        probe_snap = dataclasses.replace(probe_snap, state_nodes=probe_nodes)
        probe_snap.enforce_consolidate_after = True
        probe_snap.reserved_offering_mode = "strict"
        probe_snap.collect_zone_metrics = False
        probe_snap.deleting_node_names = batch_names

        solver = self.provisioner.solver
        with self._stage("solve_prepared"):
            results = solver.solve_prepared(probe_snap, sim_enc)
        if solver.last_backend != "gpu":
            # the masked pack couldn't stand (validation/relaxation): the
            # result IS the exact from-scratch solve of the true probe
            # snapshot — correct, just not served from the mask. Apply the
            # same empty-claim prune every simulate_scheduling exit applies.
            results.new_node_claims = [nc for nc in results.new_node_claims if nc.pods]
            self.last_mode = "scratch"
            self.scratch_probes += 1
            return results
        # blocked rows must be pod-free and vanish from the results exactly
        # like from-scratch's absent rows; a pod landing there means the
        # block failed — distrust the whole masked solve
        kept_existing = []
        for en in results.existing_nodes:
            if en.state_node.name() in batch_names:
                if en.pods:
                    return self._scratch(batch)
                continue
            kept_existing.append(en)
        results.existing_nodes = kept_existing
        results.new_node_claims = [nc for nc in results.new_node_claims if nc.pods]
        self.last_mode = "masked"
        self.masked_probes += 1
        return results
