"""Snapshot -> tensor lowering for the TPU solver.

The critical insight (SURVEY.md §7 stage 1): a Requirement's set/complement/
integer-bound representation (reference requirement.go:36-110) is exactly
encodable as a fixed-width membership bitmask over an interned (label, value)
vocabulary. This module builds that vocabulary and lowers:

- candidate "rows" (existing nodes + (template x instance type x offering))
  to label-value-id vectors, allocatable vectors, prices, taint classes;
- pods to request vectors and packed requirement bitmasks;
- the supported topology constraint families (keyed topology spread over any
  non-hostname label — zone, capacity-type, custom keys — hostname spread,
  hostname and keyed required anti-affinity) to group membership matrices and
  count tensors over a KEYED DOMAIN axis: each domain is an interned
  (topology key, value) pair with a per-key "absent" sentinel, and every
  group carries its registered-domain universe discovered from
  NodePool x InstanceType requirements exactly like the host oracle
  (topology.py _build_domain_groups; reference topology.go:105-143).

Pods are grouped by SPEC SIGNATURE before any heavy work: real pending sets
are deployment replicas, so the expensive per-pod lowering (Quantity
arithmetic, Requirements algebra, selector matching, mask building) runs once
per unique signature and broadcasts by index. The per-signature arrays are
the primary representation — the grouped device kernel consumes them
directly — and the per-pod views used by the per-pod scan path materialize
lazily. This is what turns the 50k-pod encode from seconds of Python loops
into milliseconds of numpy (reference hot path scheduler.go:440 is wall-clock
end-to-end; so is ours).

Pods/snapshots outside the supported subset report a fallback reason and the
solve is handled by the host FFD path (the reference-behavior oracle).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from operator import attrgetter

import numpy as np

from ..apis import labels as wk
from ..controllers.provisioning.scheduling.nodeclaim import NodeClaimTemplate
from ..controllers.provisioning.scheduling.scheduler import (
    _compute_daemon_overhead_groups,
    _daemon_compatible_with_node,
    _template_compatible,
)
from ..kube.objects import match_label_selector
from ..ops.bitset import pack_bool_masks, words_for
from ..scheduling.requirements import Operator, Requirements
from ..scheduling.taints import pools_taint_prefer_no_schedule, taints_tolerate_pod
from ..utils import pods as pod_utils
from ..utils import resources as res
from ..utils.quantity import Quantity
from .contracts import maybe_check_encoded

ABSENT = 0  # reserved value id per key: "row does not define this label"

# EncodedSnapshot array fields that derived encodes share BY REFERENCE with
# their base: `mask_encode` passes the whole row/offering side through
# untouched, and `_try_delta_encode` reuses every per-signature tensor of the
# EncodeCache's previous encode wholesale. An in-place write to any of these
# after construction silently corrupts the cached base (the hybrid masked
# carry and the delta slot alike). This registry is the single source of
# truth for that contract: solverlint's shared-array-mutation rule flags
# writes to these names statically (python -m karpenter_tpu.analysis), and
# `mask_encode` freezes the reference-shared ones (setflags(write=False)) so
# a mutation the linter misses raises at runtime instead. Fields built and
# mutated DURING encode (local names before EncodedSnapshot construction)
# are exempt by construction — the rule keys on attribute access.
SHARED_ENCODE_FIELDS = frozenset(
    {
        # row/offering side (shared by mask_encode AND across solves via
        # _RowArtifacts; `row_labels0` is the artifact-side name of row_labels)
        "row_alloc",
        "row_price",
        "row_labels",
        "row_labels0",
        "row_dom",
        "row_pool_rank",
        "row_taint_class",
        "rank_domset",
        "dom_key_of",
        "universe_dom",
        "existing_port_any",
        "existing_port_wild",
        "existing_port_spec",
        "row_port_any",
        "row_port_wild",
        "row_port_spec",
        # per-signature side (shared by _try_delta_encode's wholesale reuse)
        "sig_req",
        "sig_mask",
        "sig_taint_ok",
        "sig_dom_allowed",
        "sig_member",
        "sig_owner",
        "sig_host_blocked",
        "sig_port_any",
        "sig_port_wild",
        "sig_port_spec",
        "sig_relaxable",
        "req_class_of_sig",
        # topology-group side (delta reuse; mask_encode slices copies)
        "group_kind",
        "group_skew",
        "group_dom_key",
        "group_min_domains",
        "group_registered",
        "counts_dom_init",
        "counts_host_existing",
    }
)

KIND_DOM_SPREAD = 0  # spread over a keyed domain axis (zone, capacity-type, ...)
KIND_HOST_SPREAD = 1
KIND_HOST_ANTI = 2
KIND_DOM_ANTI = 3  # required anti-affinity over a non-hostname topology key
KIND_DOM_AFF = 4  # required pod affinity over a non-hostname topology key
KIND_HOST_AFF = 5  # required pod affinity over hostname (co-location)

# legacy alias: zone is dom-key 0, so zone spread is the kind-0 special case
KIND_ZONE_SPREAD = KIND_DOM_SPREAD

_Q0 = Quantity(0)

# columnar extraction: dotted attrgetters run the per-pod loop in C
_SPEC_OF = attrgetter("spec")
_META_OF = attrgetter("metadata")
_UID_OF = attrgetter("metadata.uid")
_CREATED_OF = attrgetter("metadata.creation_timestamp")
_RV_OF = attrgetter("metadata.resource_version")
_STAMP_OF = attrgetter("_sig_stamp")
_ST_RV = attrgetter("rv")
_ST_SIG = attrgetter("sig")
# stale-rv sentinel for pods with no (or a deepcopy-killed) stamp: never
# equal to a real resource_version, so the churn branch restamps exactly
# the missing subset instead of the whole pod axis
_RV_MISSING = object()


class Vocabulary:
    """Interning of label keys and per-key values (value id 0 = absent)."""

    def __init__(self):
        self.keys: dict[str, int] = {}
        self.values: list[dict[str, int]] = []  # per key: value -> id (>=1)

    def key_id(self, key: str) -> int:
        kid = self.keys.get(key)
        if kid is None:
            kid = len(self.keys)
            self.keys[key] = kid
            self.values.append({})
        return kid

    def value_id(self, key: str, value: str) -> int:
        kid = self.key_id(key)
        vals = self.values[kid]
        vid = vals.get(value)
        if vid is None:
            vid = len(vals) + 1  # 0 is reserved for absent
            vals[value] = vid
        return vid

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    def max_values(self) -> int:
        return max((len(v) + 1 for v in self.values), default=1)


@dataclass
class EncodedSnapshot:
    """All tensors the device solver consumes (numpy, host-built).

    Per-pod tensors exist in two forms: the primary per-SIGNATURE arrays
    (`sig_*`, S unique pod shapes) plus `sig_of_pod` [P] mapping each pod (in
    FFD queue order) to its signature, and lazily-materialized per-pod views
    (`pod_*` properties) for the per-pod scan path and validation tooling.
    """

    resource_names: list[str]
    vocab: Vocabulary

    # rows: existing nodes [0, n_existing) then offerings
    n_existing: int
    row_alloc: np.ndarray  # [Nrows, R] f32
    row_price: np.ndarray  # [Nrows] f32
    row_labels: np.ndarray  # [Nrows, K] i32 (value id, ABSENT=0)
    row_dom: np.ndarray  # [Nrows, Kd] i32 domain id per dom key (sentinel if absent)
    row_pool_rank: np.ndarray  # [Nrows] i32 (0 = highest weight; existing = -1)
    row_taint_class: np.ndarray  # [Nrows] i32
    row_meta: list  # per row: ("existing", state_node) | ("offering", template, it, offering)

    # pods (already FFD-sorted) and their signature grouping
    pods: list
    sig_of_pod: np.ndarray  # [P] i32 -> signature index
    sig_req: np.ndarray  # [S, R] f32
    sig_mask: np.ndarray  # [S, K, W] uint32
    sig_taint_ok: np.ndarray  # [S, C] bool
    sig_dom_allowed: np.ndarray  # [S, D] bool
    sig_member: np.ndarray  # [S, G] bool — COUNTED by the group (selector match)
    sig_owner: np.ndarray  # [S, G] bool — CONSTRAINED by the group (declares it)
    sig_requirements: list  # [S] Requirements (strict, for decode)
    sig_requests: list  # [S] ResourceList (for decode)
    req_class_of_sig: np.ndarray  # [S] i32 — sigs sharing a Requirements class
    # inverse anti-affinity from running pods (hostname terms): signature may
    # never land on these existing nodes (topology.go:476-508)
    sig_host_blocked: np.ndarray  # [S, max(n_existing, 1)] bool

    # host ports (hostportusage.go, tensorized as per-slot bitmasks over an
    # interned port vocabulary): P1 = (port, proto) keys, P2 = specific-IP
    # (ip, port, proto) keys. Conflict(a on slot) iff slot_any & a.wild, or
    # slot_wild & a.any, or slot_spec & a.spec.
    sig_port_any: np.ndarray  # [S, P1] bool — all of the sig's ports
    sig_port_wild: np.ndarray  # [S, P1] bool — wildcard-IP ports
    sig_port_spec: np.ndarray  # [S, P2] bool — specific-IP ports
    existing_port_any: np.ndarray  # [n_existing, P1]
    existing_port_wild: np.ndarray  # [n_existing, P1]
    existing_port_spec: np.ndarray  # [n_existing, P2]
    # daemon-reserved ports per row: fresh slots open with these ports held.
    # Existing rows carry their PHANTOM daemon ports here too (they are also
    # merged into existing_port_*); consumers must read exactly one of the
    # two for existing rows — the kernel/validator index row ports only for
    # offering rows
    row_port_any: np.ndarray  # [Nrows, P1]
    row_port_wild: np.ndarray  # [Nrows, P1]
    row_port_spec: np.ndarray  # [Nrows, P2]

    # keyed domain axis: each domain is an interned (dom key, value) pair;
    # dom key 0 is always the zone label; the first Kd ids are the per-key
    # "absent" sentinels (so NO_ZONE == 0 when zone is the only key)
    n_doms: int
    dom_values: list[str]  # [D] value string ("" for sentinels)
    dom_key_of: np.ndarray  # [D] i32 dom-key index
    dom_key_names: list[str]  # [Kd] label key per dom key
    dom_vocab_keys: tuple  # [Kd] vocab key id per dom key (-1 if never interned)
    rank_domset: np.ndarray  # [Q, D] bool — domains a template rank can produce
    # topology groups
    group_kind: np.ndarray  # [G] i32
    group_skew: np.ndarray  # [G] i32
    group_dom_key: np.ndarray  # [G] i32 dom-key index (-1 for hostname kinds)
    group_min_domains: np.ndarray  # [G] i32 (0 = unset)
    group_registered: np.ndarray  # [G, D] bool — the group's domain universe
    counts_dom_init: np.ndarray  # [G, D] i32
    counts_host_existing: np.ndarray  # [G, n_existing] i32

    fallback_reasons: list[str] = field(default_factory=list)
    # hybrid-partition attribution (solver/fallback.py tiers): signature ids
    # flagged by POD-LOCAL reasons, and whether any snapshot-GLOBAL reason
    # fired. A snapshot with reasons, no global flag, and a proper subset of
    # signatures flagged is a hybrid candidate (hybrid_partition).
    fallback_sig_local: frozenset = frozenset()
    fallback_has_global: bool = False
    # True when any pod carries relaxable soft constraints the pack honored
    # tier-0; an unplaced pod then re-solves via the host relaxation loop
    has_relaxable: bool = False
    # content tuple per requirement class (pod_signature key[0]) — a STABLE
    # cross-solve cache key for decode's per-class work, unlike the
    # solve-local integer class ids
    req_class_keys: list = field(default_factory=list)
    # cross-solve decode memo owned by the row artifacts (same lifetime as
    # the template objects its keys reference)
    decode_cache: dict = field(default_factory=dict)
    # per-signature relaxability (already AND'ed with the Respect policy) and
    # the pool-level PreferNoSchedule flag — kept split so `mask_encode` can
    # recompute `has_relaxable` for a pod subset without re-reading pod specs
    sig_relaxable: np.ndarray | None = None  # [S] bool
    pools_prefer: bool = False
    # encode-time metadata retained so the delta path can GROW the signature
    # axis (`_grow_signatures`) and refresh the volatile row side
    # (`_try_row_refresh`) without a full re-encode: the topology groups'
    # identity/selector records (parallel to the group axis), the host-port
    # vocabularies, and whether inverse anti-affinity blocks were applied
    # (those lower from RUNNING pods, which no row-key component can see)
    group_meta: list | None = None  # [G] dicts: ident/kind/dom_key/selector/ns
    port_key_ids: dict | None = None  # (port, proto) -> P1 column
    port_spec_ids: dict | None = None  # (ip, port, proto) -> P2 column
    inverse_blocked: bool = False
    # the NodePool x IT discovered domain universe ([D] bool, the row
    # artifacts' `universe_dom` shared BY REFERENCE): the consolidation
    # simulator's per-probe group-registry recompute and inverse-anti
    # lowering read it (inverse registries never count existing nodes)
    universe_dom: np.ndarray | None = None

    @property
    def n_rows(self) -> int:
        return self.row_alloc.shape[0]

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    @property
    def n_sigs(self) -> int:
        return self.sig_req.shape[0]

    @property
    def n_groups(self) -> int:
        return self.group_kind.shape[0]

    # -- lazy per-pod views (per-pod scan path, sharded path, tests) -----------
    @property
    def pod_req(self) -> np.ndarray:  # [P, R]
        return self.sig_req[self.sig_of_pod]

    @property
    def pod_mask(self) -> np.ndarray:  # [P, K, W]
        return self.sig_mask[self.sig_of_pod]

    @property
    def pod_taint_ok(self) -> np.ndarray:  # [P, C]
        return self.sig_taint_ok[self.sig_of_pod]

    @property
    def pod_dom_allowed(self) -> np.ndarray:  # [P, D]
        return self.sig_dom_allowed[self.sig_of_pod]

    @property
    def member(self) -> np.ndarray:  # [P, G]
        return self.sig_member[self.sig_of_pod]

    @property
    def owner(self) -> np.ndarray:  # [P, G]
        return self.sig_owner[self.sig_of_pod]

    @property
    def sig_restrict(self) -> np.ndarray:
        """[S, Kd] bool: signature constrains dom key k (some k-domain, incl.
        the sentinel, is disallowed). Computed once per encode and shared by
        make_tensors, build_items, and fast_validate."""
        cached = getattr(self, "_sig_restrict", None)
        if cached is None:
            Kd = len(self.dom_key_names)
            dko = np.asarray(self.dom_key_of)
            cached = np.stack([~self.sig_dom_allowed[:, dko == k].all(axis=1) for k in range(Kd)], axis=1)
            object.__setattr__(self, "_sig_restrict", cached)
        return cached


# -- pod spec signatures -------------------------------------------------------


def _term_key(t) -> tuple:
    return (_sel_key(t.label_selector), t.topology_key, tuple(t.namespaces), _sel_key(t.namespace_selector))


def _nst_key(term) -> tuple:
    # one node-selector term: list of {key, operator, values}
    return tuple((e["key"], e["operator"], tuple(e.get("values", ()))) for e in term)


def _requests_key(c) -> tuple:
    req = c.resources.get("requests")
    if not req:
        return ()
    items = [(k, q.milli) for k, q in req.items()]
    if len(items) > 1:
        items.sort()
    return tuple(items)


def _ports_key(c) -> tuple:
    ports = c.ports
    if not ports:
        return ()
    return tuple((p.get("hostPort"), p.get("hostIP", ""), p.get("protocol", "TCP")) for p in ports if p.get("hostPort"))


def pod_signature(pod) -> tuple:
    """Cheap structural key over every spec field the encoder (and capability
    check) reads. Two pods with equal signatures lower to identical tensors —
    deployment replicas collapse to one signature. This is the only O(pods)
    Python pass on the solve hot path, so the dominant shapes take columnar
    fast paths: plain pods (no affinity/spread/tolerations/init/overhead/
    volumes/claims — the deployment-replica majority) and affinity-free
    spread pods build their tuples with everything inlined, and only rare
    shapes fall through to `_pod_signature_reference` (the structure-literal
    reference implementation; tests pin byte equality against it).

    The FIRST element is the signature's REQUIREMENT CLASS — exactly the
    fields Requirements.from_pod reads (node_selector + affinity) — so decode
    can cache per-Requirements work on `key[0]` without positional coupling
    to the rest of the tuple."""
    spec = pod.spec
    md = pod.metadata
    if (
        spec.affinity is None
        and not spec.tolerations
        and not spec.init_containers
        and not spec.overhead
        and not spec.volumes
        and not spec.resource_claims
    ):
        nsel = spec.node_selector
        labels = md.labels
        tscs = spec.topology_spread_constraints
        return (
            (tuple(sorted(nsel.items())) if nsel else (), None),
            md.namespace,
            tuple(sorted(labels.items())) if labels else (),
            _containers_key(spec.containers),
            (),
            (),
            (),
            tuple(
                (
                    t.max_skew,
                    t.topology_key,
                    t.when_unsatisfiable,
                    _sel_key(t.label_selector),
                    t.min_domains,
                    t.node_affinity_policy,
                    t.node_taints_policy,
                    tuple(getattr(t, "match_label_keys", None) or ()),
                )
                for t in tscs
            )
            if tscs
            else (),
            (),
            False,
        )
    return _pod_signature_reference(pod)


def _containers_key(containers) -> tuple:
    """The per-container (requests, host-ports) column of the signature —
    one definition shared with the reference builder, so the two can never
    drift (only `_batch_stamp`'s prekey inlines a copy, and it must stay in
    sync; see the warning there)."""
    return tuple((_requests_key(c), _ports_key(c)) for c in containers)


def _sig_has_claims(vol_col: tuple) -> bool:
    """Whether a signature's volume column says the pod carries claim-backed
    volumes — PVC-backed OR generic-ephemeral, exactly the set
    `volumes.has_pvc_volumes` matches (both kinds resolve through
    VolumeLowering and extend the signature key with the volume component)."""
    return "pvc" in vol_col or "eph" in vol_col


class _SigStamp:
    """A pod-object signature stamp: `(resource_version, signature, has-pvc)`
    cached across solves on the Pod itself (the EncodeCache's old (uid, rv)
    dict, moved onto the object so it survives solver restarts and cache
    clears). Invalidation: the Store bumps `resource_version` on every
    update, and the stamp deliberately does NOT survive `deepcopy` — the
    host relaxation loop deep-copies a pod and then mutates the copy's spec
    IN PLACE (preferences.py), which no version stamp can see; a deep-copied
    pod therefore always recomputes. (A SHALLOW pod copy shares the spec
    object itself, so a surviving stamp there has exactly the old
    (uid, rv)-keyed cache's semantics.)"""

    __slots__ = ("rv", "sig", "pvc")

    def __init__(self, rv, sig, pvc=None):
        self.rv = rv
        self.sig = sig
        # pvc is a pure function of the (interned) signature: batch stamping
        # computes it once per unique signature and passes it in, so replica
        # fleets don't re-derive it per pod
        self.pvc = _sig_has_claims(sig[8]) if pvc is None else pvc

    def __copy__(self):
        return None

    def __deepcopy__(self, memo):
        return None


# global signature intern table: stamps hold the INTERNED tuple, so equal
# signatures across pods (deployment replicas) are the same object and the
# encode's grouping dict can probe on id() — a pointer hash instead of a
# nested-tuple hash per pod. Bounded; a clear mid-stream only de-dedupes
# grouping (two reps with equal tensors), never changes placements.
_SIG_INTERN: dict[tuple, tuple] = {}

# content-addressed row artifacts shared across EncodeCache instances: a
# fresh solver on an unchanged cluster generation reuses the row side the
# same way stamped pods reuse signatures (populated/consulted only on the
# columnar path; keyed by _row_cache_key, growth-guarded at the use site)
_ROW_GLOBAL: dict[tuple, "_RowArtifacts"] = {}


class _GroupMemo:
    """Cross-solver memo of the last grouping + FFD-order artifacts,
    content-addressed by the pod axis itself: the per-pod `id()` vector
    (object identity) plus the per-pod `resource_version` vector. A hit
    proves every pod OBJECT and every pod VERSION is unchanged since the
    memo was written, so the grouping, the creation/uid columns, and the
    FFD lexsort order — all deterministic functions of exactly that state —
    are reused wholesale; the per-solve rv guarantee is identical to the
    stamp path's (both see only store-mediated updates, which bump rv).
    `pods_ref` keeps the memoized pods strongly referenced so a recycled
    `id()` can never alias a dead pod. One entry: consecutive solves over
    one live cluster are the case that pays (fresh solvers re-encoding an
    unchanged pod set); anything else just misses into the normal path."""

    __slots__ = ("ids", "rvs", "pods_ref", "grouped", "arts")

    def __init__(self, ids, rvs, pods, grouped):
        self.ids = ids
        self.rvs = rvs
        self.pods_ref = list(pods)
        self.grouped = grouped
        self.arts: dict = {}  # encode()-owned: cached FFD order artifacts


_GROUP_MEMO: _GroupMemo | None = None

# the OUTGOING memo generation, held alive between a memo miss and the next
# FFD lexsort: while it is referenced, none of its pod ids can recycle, so an
# id() match against `prev.ids` proves object identity and the already-
# materialized uid-bytes column (`arts["uid_raw"]`) can be copied instead of
# re-extracting P Python strings (`_uid_column`). Consumed (and released) by
# the first lexsort that runs after the miss — retention is one transient
# generation, not the indefinite pinning the early release in
# `_columnar_group` exists to avoid.
_PREV_GROUP_MEMO: _GroupMemo | None = None


def clear_encode_globals() -> None:
    """Release the process-global columnar-encode caches: the grouping memo
    (which strongly pins the last cold-encoded snapshot's pods via
    `pods_ref`), the uid-handoff generation, the signature intern table, and
    the shared row artifacts. Placement-neutral — the next cold encode just
    repopulates them; for operators that tear a cluster down and keep the
    process alive."""
    global _GROUP_MEMO, _PREV_GROUP_MEMO
    _GROUP_MEMO = None
    _PREV_GROUP_MEMO = None
    _SIG_INTERN.clear()
    _ROW_GLOBAL.clear()


def _intern_sig(sig: tuple) -> tuple:
    if len(_SIG_INTERN) > 200_000:
        _SIG_INTERN.clear()  # bound memory; repopulates as stamps refresh
    return _SIG_INTERN.setdefault(sig, sig)


def pod_signature_cached(pod) -> tuple:
    """`pod_signature` with the cross-solve pod-object stamp (see _SigStamp).
    The cached read is ~0.3us vs ~5-10us for a tuple build, which is what
    keeps a warm-cluster 100k/1M-pod encode's signature pass near-free. The
    returned tuple is interned (_SIG_INTERN) even when stamping fails."""
    md = pod.metadata
    st = getattr(pod, "_sig_stamp", None)
    if st is not None and st.rv == md.resource_version:
        return st.sig
    sig = _intern_sig(pod_signature(pod))
    try:
        pod._sig_stamp = _SigStamp(md.resource_version, sig)
    except (AttributeError, TypeError):  # frozen/slotted pod doubles
        pass
    return sig


def _batch_stamp(pods: list) -> list:
    """First-contact columnar stamping: the dominant pod shapes group under a
    cheap CONTENT-FAITHFUL prekey — equal prekey implies equal
    `pod_signature` output, by construction of each component below — so the
    full signature tuple is built once per UNIQUE prekey instead of once per
    pod (~3us vs ~8us per pod on a cold 100k/1M encode). Over-splitting
    (equal signatures reached under different prekeys, e.g. two label dicts
    with the same content in different insertion order) is harmless: stamps
    hold the INTERNED signature, so such groups merge on the sig object in
    `_columnar_group`.

    Returns the interned signature per pod (a list parallel to `pods`), so a
    cold `_columnar_group` proceeds directly on the return value without
    re-reading the stamps it just wrote — and pods that cannot hold a stamp
    (frozen/slotted doubles) still group, they just restamp every encode.

    Faithfulness per component: namespace is a sig component verbatim;
    `tuple(d.items())` equality implies dict equality (so the sig's SORTED
    items are equal); the requests prekey fixes (key, milli) in insertion
    order, which determines the sig's sorted form; the ports prekey IS the
    sig's port component; the spread prekey relies on `repr` being injective
    over selector structures (str/int/list/dict manifest data — true for
    plain k8s selector content). Any pod outside the single-container plain
    shape builds its full signature directly (rare shapes; the prekey only
    has to cover the deployment-replica majority to win)."""
    sigs: list = []
    append = sigs.append
    entry_by_prekey: dict = {}  # prekey -> (interned sig, has-pvc)
    get = entry_by_prekey.get
    intern, psig, stamp_cls, has_claims = _intern_sig, pod_signature, _SigStamp, _sig_has_claims
    # previous-entry memo: first contacts arrive in replica RUNS (a
    # deployment's pods are created back-to-back, and churn arrivals cycle a
    # small shape alphabet), so the previous pod's raw components usually
    # compare equal — a C-level equality chain over the dicts is several
    # times cheaper than building + hashing the nested prekey tuple.
    # Soundness: dict equality implies equal SORTED items (the sig's form),
    # Quantity equality is by milli, and the spread list is reused only on
    # object identity (or both empty) — so equal components imply an equal
    # pod_signature output, the same contract the prekey itself carries.
    prev_ns = prev_nsel = prev_lb = prev_rq = prev_pt = prev_tscs = None
    prev_ent: tuple | None = None
    # columnar prefetch: the spec/metadata/containers attribute chains run in
    # C map loops once, not as per-pod bytecode inside the hot loop below
    specs = list(map(_SPEC_OF, pods))
    metas = list(map(_META_OF, pods))
    for p, s, m in zip(pods, specs, metas):  # solverlint: ok(python-loop-over-pod-axis): THE first-contact pass — one prekey tuple + dict probe + stamp per pod, at most once per cold pod; every later encode reads stamps in C loops (_columnar_group)
        cs = s.containers
        if (
            s.affinity is None
            and not s.tolerations
            and not s.init_containers
            and not s.overhead
            and not s.volumes
            and not s.resource_claims
            and len(cs) == 1
        ):
            c = cs[0]
            rq = c.resources.get("requests")
            nsel = s.node_selector
            lb = m.labels
            pt = c.ports
            tscs = s.topology_spread_constraints
            if (
                prev_ent is not None
                and m.namespace == prev_ns
                and nsel == prev_nsel
                and lb == prev_lb
                and rq == prev_rq
                and pt == prev_pt
                and (tscs is prev_tscs or (not tscs and not prev_tscs))
            ):
                sig, pvc = prev_ent
                append(sig)
                try:
                    p._sig_stamp = stamp_cls(m.resource_version, sig, pvc)
                except (AttributeError, TypeError):  # frozen/slotted pod doubles
                    pass
                continue
            # SYNC WARNING: the requests/ports components below are inlined
            # copies of _requests_key/_ports_key (this is the only per-pod
            # hot loop, so no per-container helper calls) — any field added
            # to those helpers MUST be added here too, or two pods differing
            # in the new field share a prekey and the second silently stamps
            # with the first's signature (equal prekey must imply equal
            # pod_signature output)
            key = (
                m.namespace,
                tuple(nsel.items()) if nsel else None,
                tuple(lb.items()) if lb else None,
                tuple([(k, q.milli) for k, q in rq.items()]) if rq else None,
                tuple([(d.get("hostPort"), d.get("hostIP", ""), d.get("protocol", "TCP")) for d in pt if d.get("hostPort")]) if pt else None,
                tuple(
                    (t.max_skew, t.topology_key, t.when_unsatisfiable, repr(t.label_selector), t.min_domains, t.node_affinity_policy, t.node_taints_policy, tuple(getattr(t, "match_label_keys", None) or ()))
                    for t in tscs
                )
                if tscs
                else None,
            )
            ent = get(key)
            if ent is None:
                sig = intern(psig(p))
                ent = (sig, has_claims(sig[8]))
                entry_by_prekey[key] = ent
            sig, pvc = ent
            prev_ns, prev_nsel, prev_lb, prev_rq, prev_pt, prev_tscs = m.namespace, nsel, lb, rq, pt, tscs
            prev_ent = ent
        else:
            sig = intern(psig(p))
            pvc = has_claims(sig[8])
        append(sig)
        try:
            p._sig_stamp = stamp_cls(m.resource_version, sig, pvc)
        except (AttributeError, TypeError):  # frozen/slotted pod doubles
            pass
    return sigs


def _columnar_group(pods: list):
    """The signature-level columnar grouping pass: every per-pod read runs in
    a C loop (attrgetter map chains, list equality, numpy), and grouping is
    one np.unique over the interned signature tuples' object ids — no
    Python-level per-pod bytecode at all. This is what takes a warm-cluster
    100k/1M-pod encode's pod pass from ~1s of interpreted tuple work to
    ~0.1s; unstamped or stale pods fall to `_batch_stamp` (the prekey'd
    first-contact pass), churn restamps only the stale subset.

    Returns (grouped, arts) where grouped is (sig_of_pod_raw [P] i32,
    rep_idx [S] i64 first-appearance pod index per signature, rep_keys [S])
    or None when the per-pod loop must run instead (a PVC-backed pod is
    present: its signature key extends with the resolved volume component,
    which only the sequential path builds), and arts is the `_GroupMemo`
    artifact dict for encode() to cache FFD-order columns in (None when the
    result was not memoizable)."""
    global _GROUP_MEMO, _PREV_GROUP_MEMO
    P = len(pods)
    ids = np.fromiter(map(id, pods), np.int64, count=P)
    try:
        rv_arr = np.fromiter(map(_RV_OF, pods), np.int64, count=P)
    except (TypeError, ValueError, OverflowError):  # non-int resource_version
        rv_arr = None
    memo = _GROUP_MEMO
    if (
        memo is not None
        and rv_arr is not None
        and np.array_equal(memo.ids, ids)
        and np.array_equal(memo.rvs, rv_arr)
    ):
        return memo.grouped, memo.arts
    # miss: release the old memo from the PRIMARY slot now, not at the
    # rebuild below — `pods_ref` strongly pins the memoized snapshot's whole
    # pod graph, and the rebuild path may not write a replacement (rv_arr
    # None), which would otherwise leave e.g. a shrunk-away 1M-pod snapshot
    # reachable indefinitely. It moves to the HANDOFF slot instead: the next
    # FFD lexsort copies uid bytes for every shared pod object, then drops it
    _PREV_GROUP_MEMO = memo
    _GROUP_MEMO = memo = None
    try:
        stamps = list(map(_STAMP_OF, pods))
    except AttributeError:
        # some pods were never stamped: re-read with a default so only that
        # subset pays the first-contact pass below, not the whole axis
        stamps = [getattr(p, "_sig_stamp", None) for p in pods]
    if not any(stamps):
        # whole-axis first contact (a fresh cluster, or every stamp killed by
        # deepcopy): batch-stamp directly off its return value — the
        # stale-subset split, the post-stamp re-read, and the rv re-compare
        # below would all be full extra passes over an all-stale axis
        sigs = _batch_stamp(pods)
    else:
        try:
            rv_st = list(map(_ST_RV, stamps))
        except (AttributeError, TypeError):
            # missing stamps — first contact, or deep-copied pods whose
            # _sig_stamp deliberately deepcopies to None — read as the
            # _RV_MISSING sentinel, i.e. unconditionally stale
            rv_st = [getattr(st, "rv", _RV_MISSING) for st in stamps]
        rv_pod = rv_arr.tolist() if rv_arr is not None else list(map(_RV_OF, pods))
        if rv_st == rv_pod:
            sigs = list(map(_ST_SIG, stamps))
        else:
            # churn: restamp only the missing+stale subset (comprehension is
            # the sanctioned cheap pass; proportional to it)
            _batch_stamp([p for a, b, p in zip(rv_st, rv_pod, pods) if a != b])
            try:
                stamps = list(map(_STAMP_OF, pods))
                fresh = list(map(_ST_RV, stamps)) == rv_pod
            except (AttributeError, TypeError):
                fresh = False
            # a pod that cannot HOLD a stamp pays the full first-contact
            # pass every encode (rare: frozen/slotted pod doubles)
            sigs = list(map(_ST_SIG, stamps)) if fresh else _batch_stamp(pods)
    obj_ids = np.fromiter(map(id, sigs), np.int64, count=P)
    _, first_idx, inverse = np.unique(obj_ids, return_index=True, return_inverse=True)
    # renumber to FIRST-APPEARANCE order — bit-identical to the sequential
    # loop's sid allocation (signature ids are load-bearing downstream)
    order_u = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order_u)
    rank[order_u] = np.arange(order_u.size)
    rep_idx = first_idx[order_u]
    rep_keys = [sigs[i] for i in rep_idx]
    # claim-volume gate on the S unique signatures, not the P pods (a pure
    # function of the signature; covers PVC-backed AND generic-ephemeral)
    if any(_sig_has_claims(k[8]) for k in rep_keys):
        grouped = None
    else:
        sig_of_pod_raw = rank[inverse].astype(np.int32)
        for a in (sig_of_pod_raw, rep_idx):
            a.setflags(write=False)  # memo-shared across solvers: read-only
        grouped = (sig_of_pod_raw, rep_idx, rep_keys)
    if rv_arr is None:
        return grouped, None
    _GROUP_MEMO = memo = _GroupMemo(ids, rv_arr, pods, grouped)
    return grouped, memo.arts


def _uid_column(pods: list, P: int) -> np.ndarray:
    """The FFD lexsort's uid tiebreak column for `pods` (raw order),
    reusing the outgoing `_GroupMemo` generation's already-materialized uid
    bytes for every pod OBJECT the two snapshots share, so warm-churn cold
    sorts (the pod multiset changed, the objects mostly didn't — every
    consolidation-simulation or churn-loop re-encode) skip the per-pod uid
    string extraction entirely. Holding `_PREV_GROUP_MEMO` alive until here
    means an `id()` match proves object identity (no recycled ids), so a
    copied uid is exact; misses materialize individually. Ascii uids sort as
    memcmp bytes — same order as unicode codepoints (the k8s norm)."""
    global _PREV_GROUP_MEMO
    prev = _PREV_GROUP_MEMO
    _PREV_GROUP_MEMO = None
    prev_uid = prev.arts.get("uid_raw") if prev is not None else None
    if prev_uid is not None and prev_uid.dtype.kind == "S" and prev.ids.size:
        ids = np.fromiter(map(id, pods), np.int64, count=P)
        order = np.argsort(prev.ids, kind="stable")
        sorted_prev = prev.ids[order]
        pos = np.clip(np.searchsorted(sorted_prev, ids), 0, sorted_prev.size - 1)
        hit = sorted_prev[pos] == ids
        if hit.all():
            return prev_uid[order[pos]]
        n_miss = int((~hit).sum())
        if n_miss <= P // 2:
            miss_idx = np.nonzero(~hit)[0]
            try:
                miss = np.array([_UID_OF(pods[i]) for i in miss_idx], dtype="S")
            except UnicodeEncodeError:
                miss = None
            if miss is not None:
                w = max(prev_uid.dtype.itemsize, miss.dtype.itemsize)
                out = np.zeros(P, dtype=f"S{w}")
                out[hit] = prev_uid[order[pos[hit]]]
                out[miss_idx] = miss
                return out
    uid_l = list(map(_UID_OF, pods))
    try:
        # ascii uids (the k8s norm) sort as memcmp bytes — same order as
        # unicode codepoints, ~2x faster in the lexsort and 4x smaller
        return np.array(uid_l, dtype="S")
    except UnicodeEncodeError:
        return np.array(uid_l)


def _pod_signature_reference(pod) -> tuple:
    """The structure-literal reference signature (every field spelled out
    once, no fast paths) — `pod_signature` returns byte-identical tuples and
    falls through to this one for the rare pod shapes."""
    spec = pod.spec
    md = pod.metadata
    aff = spec.affinity
    aff_key = None
    if aff is not None:
        na = aff.node_affinity
        na_key = None
        if na is not None:
            na_key = (
                tuple(_nst_key(term) for term in na.required),
                tuple((p.weight, _nst_key(p.preference)) for p in na.preferred),
            )
        aff_key = (
            na_key,
            tuple(_term_key(t) for t in aff.pod_affinity_required),
            tuple((w.weight, _term_key(w.term)) for w in aff.pod_affinity_preferred),
            tuple(_term_key(t) for t in aff.pod_anti_affinity_required),
            tuple((w.weight, _term_key(w.term)) for w in aff.pod_anti_affinity_preferred),
        )
    req_class = (
        tuple(sorted(spec.node_selector.items())) if spec.node_selector else (),
        aff_key,
    )
    labels = md.labels
    return (
        req_class,
        md.namespace,
        tuple(sorted(labels.items())) if labels else (),
        tuple((_requests_key(c), _ports_key(c)) for c in spec.containers),
        tuple((_requests_key(c), c.is_sidecar(), _ports_key(c)) for c in spec.init_containers) if spec.init_containers else (),
        tuple(sorted((k, q.milli) for k, q in spec.overhead.items())) if spec.overhead else (),
        tuple(
            tuple(sorted((k, str(v)) for k, v in t.items())) if isinstance(t, dict) else repr(t)
            for t in spec.tolerations
        )
        if spec.tolerations
        else (),
        tuple(
            (
                t.max_skew,
                t.topology_key,
                t.when_unsatisfiable,
                _sel_key(t.label_selector),
                t.min_domains,
                t.node_affinity_policy,
                t.node_taints_policy,
                tuple(getattr(t, "match_label_keys", None) or ()),
            )
            for t in spec.topology_spread_constraints
        )
        if spec.topology_spread_constraints
        else (),
        tuple(
            "pvc" if v.get("persistentVolumeClaim") else ("eph" if v.get("ephemeral") is not None else "other")
            for v in spec.volumes
        )
        if spec.volumes
        else (),
        bool(spec.resource_claims),
    )


class CapabilityReport:
    """Attributed capability findings: the bounded reason list (deduped by
    family — at most `MAX_REASONS_PER_FAMILY` examples each, so metrics and
    logs stay low-cardinality while still seeing every FAMILY in play), the
    signature indices flagged by pod-local reasons, and whether any
    snapshot-global reason fired. `sig_local` indexes into the `pods`
    sequence handed to `capability_report` (signature ids when the encode's
    representatives are passed)."""

    MAX_REASONS_PER_FAMILY = 3

    def __init__(self):
        self.reasons: list[str] = []
        self.sig_local: set[int] = set()
        self.has_global: bool = False
        self._fam_counts: dict[str, int] = {}

    def add(self, reason: str, sig: int | None = None) -> None:
        from .fallback import is_pod_local, reason_family

        fam = reason_family(reason)
        n = self._fam_counts.get(fam, 0)
        if n < self.MAX_REASONS_PER_FAMILY and reason not in self.reasons:
            self.reasons.append(reason)
            self._fam_counts[fam] = n + 1
        if sig is not None and is_pod_local(fam):
            self.sig_local.add(sig)
        else:
            self.has_global = True


def check_capability(snap, pods=None, vol_comps=None) -> list[str]:
    """Reasons the snapshot cannot run on the tensor path (empty = OK).
    `pods` defaults to the snapshot's; pass signature representatives to check
    each unique shape once. `vol_comps` (parallel to `pods`) supplies
    already-resolved volume components so the encode's signature loop and
    this check never resolve the same claims twice."""
    return capability_report(snap, pods, vol_comps).reasons


def capability_report(snap, pods=None, vol_comps=None) -> CapabilityReport:
    """Attributed variant of `check_capability`: EVERY offending pod shape is
    scanned (no first-reason short-circuit across pods), reasons are
    collected bounded and deduped by family, and pod-local reasons carry the
    signature index they belong to — the hybrid partitioner's input.

    Relaxable soft constraints (preferred node affinity, node-affinity
    OR-terms, ScheduleAnyway spreads) are IN-window under the default Respect
    policy: the tensor pack honors them tier-0 exactly as the FFD does before
    any relaxation (preferences.go:40-55 relaxes only on failure), and
    TPUSolver falls back to the host relaxation loop only if a pod is left
    unplaced with soft constraints in play."""
    report = CapabilityReport()
    respect = getattr(snap, "preference_policy", "Respect") == "Respect"
    # NodePool minValues is fully tensorized: the pack runs unconstrained and
    # decode enforces satisfies_min_values per produced claim — widening
    # decode pins, relaxing under BestEffort, or routing irreparable claims
    # through a bounded host repair (TPUSolver._enforce_min_values). No
    # capability reason is emitted for it anymore.
    rep_pods = list(pods if pods is not None else snap.pods)
    # required anti-affinity is modeled as symmetric per-domain groups
    # (members = pods matched by the selector); that is exact only when the
    # declaring set and the matched set coincide (pure self-anti-affinity,
    # the deployment-replicas case). Asymmetric terms stay host-side. The
    # same holds for required pod affinity: the host counts matched
    # non-declaring pods without constraining them, which the domain kernel
    # can express only when matched == declaring. (Hostname spread/anti
    # groups are exact either way via the owner/member mask split; hostname
    # affinity keeps the symmetric window because its bootstrap rule reads
    # self-selection.)
    for r in _anti_symmetry_reasons(rep_pods) + _affinity_symmetry_reasons(rep_pods):
        report.add(r)
    # asymmetric KEYED spread membership is POD-LOCAL: flagging BOTH the
    # declaring and the matched signatures routes the entire coupled
    # membership to the host residual, where the count-without-constrain
    # semantics are native (fallback.py tier rationale)
    for r, sigs in _spread_symmetry_reasons(rep_pods):
        for s in sigs:
            report.add(r, sig=s)
    if report.has_global:
        return report
    _vol_lowering = None  # one lowering for all reps (per-solve SC/PV memos)

    def resolve_comp(idx, pod):
        nonlocal _vol_lowering
        if vol_comps is not None:
            return vol_comps[idx]
        from .volumes import VolumeLowering

        if _vol_lowering is None:
            _vol_lowering = VolumeLowering(snap.store)
        return _vol_lowering.component(pod)

    for idx, pod in enumerate(rep_pods):
        for r in _pod_window_reasons(snap, pod, respect, lambda p, i=idx: resolve_comp(i, p)):
            report.add(r, sig=idx)
    # inverse anti-affinity from already-running pods IS tensorized: the
    # running pods' recorded domains cannot change during a solve, so their
    # inverse groups (topology.go:476-508) lower to STATIC per-signature
    # blocked-domain / blocked-host masks (_apply_inverse_anti_blocks) —
    # no capability restriction needed
    # strict reserved-offering mode (consolidation sims) requires per-pod
    # reservation failures, which only the sequential host path expresses;
    # decode's host-side cap implements fallback mode only. POD-LOCAL: only
    # the signatures whose requirements can REACH reserved capacity carry
    # the demand — a claim whose every pod excludes the reserved capacity
    # type can never enter _offerings_to_reserve's strict branch, so those
    # signatures ride the tensor path untouched.
    if (
        getattr(snap, "reserved_offering_mode", "fallback") == "strict"
        and getattr(snap, "reserved_capacity_enabled", True)
        and any(
            o.available and o.capacity_type() == wk.CAPACITY_TYPE_RESERVED
            for its in snap.instance_types.values()
            for it in its
            for o in it.offerings
        )
    ):
        for idx, pod in enumerate(rep_pods):
            if _sig_demands_reserved(pod):
                report.add(f"{pod.key()}: strict reserved-offering demand", sig=idx)
    return report


def _sig_demands_reserved(pod) -> bool:
    """Can a claim holding this pod shape reach reserved capacity? True
    unless the pod's own stable requirements pin the capacity type away from
    reserved. Relaxable shapes (multiple OR'd node-affinity terms, or a
    preferred term re-allowing reserved) stay flagged: the relaxation loop
    could re-widen what the first term excluded."""
    if Requirements.from_pod(pod, strict=True).get(wk.CAPACITY_TYPE_LABEL_KEY).has(wk.CAPACITY_TYPE_RESERVED):
        return True
    # preferred terms only ever NARROW the strict set (Add intersects), so an
    # exclusion in nodeSelector/required[0] survives preference peeling; but
    # further OR terms can re-allow reserved once relaxation drops the first
    na = pod.spec.affinity.node_affinity if pod.spec.affinity else None
    return na is not None and len(na.required) > 1


def _pod_window_reasons(snap, pod, respect: bool, resolve_comp) -> list[str]:
    """The in-window gate for ONE pod shape: returns its fallback reasons
    (empty = in-window). Checks short-circuit at the pod level — the first
    offending constraint family describes the pod — but the caller scans
    every representative, so the snapshot-wide picture is complete.

    Layering vs the grouped kernel's multi-group merge: this window is the
    OUTER gate (multi-key topology / affinity-combined shapes route to the
    host FFD path before the kernel ever sees them), while
    `scheduler_model_grouped.sig_demotions` is the INNER safety net — it
    demotes the same families to per-pod count=1 items so `build_items`
    stays correct on any encode handed to it directly (the encode below
    still fully lowers an out-of-window shape; fallback_reasons only steer
    the solver). In-window multi-group shapes — several spreads/anti/aff
    groups over ONE domain key (hostname is exempt from `used_keys`) —
    merge count>1 and take the joint water-fill; with the
    `KARPENTER_SOLVER_MULTIGROUP=0` hatch they demote with reason
    `hatch-off`, the only demotion reachable in-window."""
    aff = pod.spec.affinity
    if aff is not None:
        if aff.pod_affinity_preferred:
            # soft constraint: the host relaxation loop owns it
            return [f"{pod.key()}: preferred pod affinity"]
        if aff.pod_affinity_required:
            # required affinity is in-window (KIND_DOM_AFF/KIND_HOST_AFF:
            # members co-locate in recorded domains, bootstrapping one
            # when none is reachable — topology.go:246-282) for the
            # single-term, selector-symmetric, uncombined case
            if len(aff.pod_affinity_required) > 1:
                return [f"{pod.key()}: multiple pod affinity terms"]
            term = aff.pod_affinity_required[0]
            if term.namespaces or term.namespace_selector is not None:
                return [f"{pod.key()}: pod affinity with explicit namespaces"]
            if (
                pod.spec.topology_spread_constraints
                or aff.pod_anti_affinity_required
                or aff.pod_anti_affinity_preferred
            ):
                return [f"{pod.key()}: pod affinity combined with other topology constraints"]
        if aff.pod_anti_affinity_preferred:
            return [f"{pod.key()}: preferred anti-affinity"]
        if any(t.namespaces or t.namespace_selector is not None for t in aff.pod_anti_affinity_required):
            return [f"{pod.key()}: anti-affinity with explicit namespaces"]
        na = aff.node_affinity
        if not respect and na is not None and (na.preferred or len(na.required) > 1):
            # Ignore policy drops preferences host-side pre-solve; keep
            # the conservative window there
            return [f"{pod.key()}: relaxable node affinity"]
    used_keys = {t.topology_key for t in pod.spec.topology_spread_constraints if t.topology_key != wk.HOSTNAME_LABEL_KEY}
    dom_anti_terms = [t for t in (aff.pod_anti_affinity_required if aff else []) if t.topology_key != wk.HOSTNAME_LABEL_KEY]
    if aff is not None:
        used_keys |= {t.topology_key for t in dom_anti_terms}
    if len(used_keys) > 1:
        # the pack scan commits one domain key per placement batch
        return [f"{pod.key()}: topology constraints over multiple domain keys"]
    if dom_anti_terms and (
        any(t.topology_key != wk.HOSTNAME_LABEL_KEY for t in pod.spec.topology_spread_constraints)
        or len({(t.topology_key, _sel_key(t.label_selector)) for t in dom_anti_terms}) > 1
    ):
        # keyed anti-affinity uses the reference's block-all-possible-
        # domains semantics (topology.go Record for anti), which the
        # kernel models as a dedicated sequential path — one dom group
        # per item there
        return [f"{pod.key()}: combined keyed anti-affinity constraints"]
    for tsc in pod.spec.topology_spread_constraints:
        if tsc.when_unsatisfiable != "DoNotSchedule" and not respect:
            return [f"{pod.key()}: ScheduleAnyway spread"]
        if tsc.node_taints_policy == "Honor":
            # taint-filtered domain registration/counting stays host-side
            return [f"{pod.key()}: spread taint policy"]
        if tsc.topology_key != wk.HOSTNAME_LABEL_KEY and _node_filter_unexpressible(pod, tsc):
            # the kernel's per-item allowed-domain masking IS the Honor
            # node filter when the filter only constrains the spread's own
            # topology key; anything wider stays host-side
            return [f"{pod.key()}: node-filtered spread counting"]
    from .volumes import has_pvc_volumes, window_reasons

    if has_pvc_volumes(pod):
        # the common case (single topology alternative, per-driver
        # attach limits) is tensorized (solver/volumes.py); only
        # resolution-level gates remain here — encode() adds the
        # cross-pod gates (shared claims) it alone can see
        if getattr(snap, "store", None) is None:
            return [f"{pod.key()}: PVC-backed volumes (no store)"]
        vol_rs = window_reasons(resolve_comp(pod), pod)
        if vol_rs:
            return vol_rs
    if pod.spec.resource_claims:
        # DRA's DFS decision tree stays host-side (SURVEY.md §7 stage 9)
        return [f"{pod.key()}: dynamic resource claims"]
    return []


def _freeze_shared(derived: EncodedSnapshot, base: EncodedSnapshot) -> None:
    """Runtime arm of the SHARED_ENCODE_FIELDS contract: mark every numpy
    array the derived encode shares BY REFERENCE with its base read-only, so
    an in-place write the shared-array-mutation lint misses raises
    (`ValueError: assignment destination is read-only`) in tests instead of
    silently corrupting the EncodeCache delta base / hybrid masked carry.
    Identity-gated: sliced copies (fancy indexing) stay writable."""
    for f in SHARED_ENCODE_FIELDS:
        arr = getattr(derived, f, None)
        if isinstance(arr, np.ndarray) and arr is getattr(base, f, None):
            arr.setflags(write=False)


def _node_filter_unexpressible(pod, tsc) -> bool:
    """True when the spread's effective Honor node-affinity filter
    (topologynodefilter.go; defaults: affinity=Honor) constrains anything the
    per-item allowed-domain mask cannot express — keys other than the
    constraint's own topology key, or OR'd affinity terms touching it."""
    if (tsc.node_affinity_policy or "Honor") != "Honor":
        return False
    key = tsc.topology_key
    selector_keys = set(pod.spec.node_selector or ())
    if selector_keys - {key}:
        return True
    aff = pod.spec.affinity
    na = aff.node_affinity if aff is not None else None
    if na is None or not na.required:
        return False
    term_keys = [{e["key"] for e in term} for term in na.required]
    if any(ks - {key} for ks in term_keys):
        return True
    # several OR'd terms on the key itself: the filter is their union while
    # the tier-0 mask follows only the first term
    return len(na.required) > 1 and any(key in ks for ks in term_keys)


def _anti_symmetry_reasons(rep_pods) -> list[str]:
    """Required anti-affinity terms whose declaring set != matched set (over
    the solve's unique pod shapes): the symmetric group model would
    over-constrain matched-but-not-declaring pods."""
    declared: dict[tuple, tuple[set[int], object]] = {}
    for s, pod in enumerate(rep_pods):
        aff = pod.spec.affinity
        if aff is None:
            continue
        for term in aff.pod_anti_affinity_required:
            ident = (term.topology_key, _sel_key(term.label_selector), pod.metadata.namespace)
            entry = declared.get(ident)
            if entry is None:
                declared[ident] = ({s}, term.label_selector)
            else:
                entry[0].add(s)
    reasons = []
    for (key, _selk, ns), (declarers, selector) in declared.items():
        matched = {
            s
            for s, pod in enumerate(rep_pods)
            if pod.metadata.namespace == ns and selector is not None and match_label_selector(selector, pod.metadata.labels)
        }
        if matched != declarers:
            reasons.append(f"asymmetric anti-affinity (key {key}): selector matches pods that do not declare it")
    return reasons


def _spread_symmetry_reasons(rep_pods) -> list[tuple[str, frozenset]]:
    """Non-hostname spread constraints whose declaring set != matched set
    (over the solve's unique pod shapes): the host counts matched
    non-declaring pods without constraining them, which the keyed-domain
    kernel cannot express. Returns (reason, flagged signature set) pairs —
    the flagged set is declarers UNION matched, so the hybrid partitioner
    routes the entire coupled membership to the host residual together."""
    from ..controllers.provisioning.scheduling.topology import effective_spread_selector

    declared: dict[tuple, tuple[set[int], object]] = {}
    for s, pod in enumerate(rep_pods):
        for tsc in pod.spec.topology_spread_constraints:
            if tsc.topology_key == wk.HOSTNAME_LABEL_KEY:
                continue
            eff_sel = effective_spread_selector(pod, tsc)
            ident = (tsc.topology_key, _sel_key(eff_sel), pod.metadata.namespace)
            entry = declared.get(ident)
            if entry is None:
                declared[ident] = ({s}, eff_sel)
            else:
                entry[0].add(s)
    reasons = []
    for (key, _selk, ns), (declarers, selector) in declared.items():
        matched = {
            s
            for s, pod in enumerate(rep_pods)
            if pod.metadata.namespace == ns and selector is not None and match_label_selector(selector, pod.metadata.labels)
        }
        if matched != declarers:
            reasons.append(
                (
                    f"asymmetric spread membership (key {key}): selector matches pods that do not declare it",
                    frozenset(declarers | matched),
                )
            )
    return reasons


def _affinity_symmetry_reasons(rep_pods) -> list[str]:
    """Required pod-affinity terms whose declaring set != matched set (over
    the solve's unique pod shapes): the symmetric group model counts exactly
    the pods it constrains, so matched-but-not-declaring pods would wrongly
    bootstrap/commit domains for the group."""
    declared: dict[tuple, tuple[set[int], object]] = {}
    for s, pod in enumerate(rep_pods):
        aff = pod.spec.affinity
        if aff is None:
            continue
        for term in aff.pod_affinity_required:
            ident = (term.topology_key, _sel_key(term.label_selector), pod.metadata.namespace)
            entry = declared.get(ident)
            if entry is None:
                declared[ident] = ({s}, term.label_selector)
            else:
                entry[0].add(s)
    reasons = []
    for (key, _selk, ns), (declarers, selector) in declared.items():
        matched = {
            s
            for s, pod in enumerate(rep_pods)
            if pod.metadata.namespace == ns and selector is not None and match_label_selector(selector, pod.metadata.labels)
        }
        if matched != declarers:
            reasons.append(f"asymmetric pod affinity (key {key}): selector matches pods that do not declare it")
    return reasons


def _term_namespaces(store, pod, term) -> set[str]:
    """Namespaces a pod-(anti-)affinity term spans (topology.py
    _namespaces_for_term semantics)."""
    if term.namespaces:
        return set(term.namespaces)
    if term.namespace_selector is not None:
        if not term.namespace_selector:
            return {p.metadata.namespace for p in store.list("Pod")} | {pod.metadata.namespace}
        return {pod.metadata.namespace}
    return {pod.metadata.namespace}


def _inverse_anti_entries(snap, solve_uids_of) -> list[dict]:
    """Running pods with required anti-affinity -> static blocking entries.

    The host tracks these as inverse topology groups (topology.go:476-508,
    topology.py _update_inverse_affinities): an incoming pod their selector
    matches may only land in REGISTERED domains of the term's key that do not
    already hold the running pod. Running pods cannot move during a solve, so
    the whole mechanism lowers to per-signature static masks.

    `solve_uids_of` is a zero-arg callable returning the solve-pod uid set —
    invoked only when anti-affinity running pods exist, so the common case
    never pays the O(P) set build."""
    entries: list[dict] = []
    cluster = getattr(snap, "cluster", None)
    if cluster is None:
        return entries
    anti_pods = cluster.pods_with_anti_affinity()
    if not anti_pods:
        return entries
    solve_uids = solve_uids_of()
    for pod in anti_pods:
        if pod.metadata.uid in solve_uids:
            continue
        aff = pod.spec.affinity
        if aff is None:
            continue
        node = snap.store.try_get("Node", pod.spec.node_name) if pod.spec.node_name else None
        node_labels = node.metadata.labels if node is not None else {}
        for term in aff.pod_anti_affinity_required:
            entries.append(
                dict(
                    key=term.topology_key,
                    selector=term.label_selector,
                    namespaces=_term_namespaces(snap.store, pod, term),
                    # recorded only when the node carries the label, exactly
                    # like _update_inverse_anti_affinity (no hostname-name
                    # fallback there, unlike _count_domains)
                    recorded=node_labels.get(term.topology_key),
                    node_name=pod.spec.node_name,
                )
            )
    return entries


def _apply_inverse_anti_blocks(entries, rep_pods, rows, sig_dom_allowed, n_existing: int, state_nodes) -> np.ndarray:
    """Lower inverse anti-affinity entries into sig_dom_allowed (in place) and
    a per-(signature, existing node) blocked matrix.

    Host semantics per matching inverse group (_next_domain_anti_affinity):
    the pod's viable domains for the term's key are the group's REGISTERED
    domains (NodePool x IT universe — inverse groups never count existing
    nodes into their registry) minus the recorded (running-pod) domains; a
    row carrying no value for the key remains viable iff that set is
    nonempty (Requirements.get of an absent key is Exists)."""
    S = len(rep_pods)
    sig_host_blocked = np.zeros((S, max(n_existing, 1)), dtype=bool)
    if not entries:
        return sig_host_blocked
    key_idx = {k: i for i, k in enumerate(rows.dom_key_names)}
    node_idx = {sn.name(): j for j, sn in enumerate(state_nodes)}
    dko = np.asarray(rows.dom_key_of_l)
    matched_keys: set[tuple[int, int]] = set()  # (sig, dom key) pairs touched
    for e in entries:
        sel = e["selector"]
        matched = [
            s
            for s, pod in enumerate(rep_pods)
            if pod.metadata.namespace in e["namespaces"] and sel is not None and match_label_selector(sel, pod.metadata.labels)
        ]
        if not matched:
            continue
        if e["key"] == wk.HOSTNAME_LABEL_KEY:
            j = node_idx.get(e["node_name"] or "")
            if j is not None:
                for s in matched:
                    sig_host_blocked[s, j] = True
            continue
        k = key_idx[e["key"]]
        keydoms = dko == k
        keydoms[rows.dom_sentinel[k]] = False  # real domains of the key
        allowed = rows.universe_dom & keydoms
        rec = e["recorded"]
        if rec is not None:
            d = rows.dom_ids[k].get(rec)
            if d is not None:
                allowed = allowed.copy()
                allowed[d] = False
        blocked = keydoms & ~allowed
        for s in matched:
            sig_dom_allowed[s, blocked] = False
            matched_keys.add((s, k))
    # per-key sentinel: viable only while some registered real domain of the
    # key survives the pod's own requirements and every entry's blocking
    for s, k in sorted(matched_keys):
        keydoms = dko == k
        keydoms[rows.dom_sentinel[k]] = False
        if not (sig_dom_allowed[s] & keydoms).any():
            sig_dom_allowed[s, rows.dom_sentinel[k]] = False
    return sig_host_blocked


def _dom_keys_for(rep_pods, extra_keys=()) -> list[str]:
    """The snapshot's domain keys: zone always (dom key 0), plus every
    non-hostname topology key referenced by a spread constraint, required
    (anti-)affinity term, or running-pod inverse anti-affinity term."""
    keys: set[str] = set(k for k in extra_keys if k != wk.HOSTNAME_LABEL_KEY)
    for pod in rep_pods:
        for tsc in pod.spec.topology_spread_constraints:
            if tsc.topology_key != wk.HOSTNAME_LABEL_KEY:
                keys.add(tsc.topology_key)
        aff = pod.spec.affinity
        if aff is not None:
            for term in list(aff.pod_anti_affinity_required) + list(aff.pod_affinity_required):
                if term.topology_key != wk.HOSTNAME_LABEL_KEY:
                    keys.add(term.topology_key)
    return [wk.ZONE_LABEL_KEY] + sorted(keys - {wk.ZONE_LABEL_KEY})


@dataclass
class _RowArtifacts:
    """Everything the row side of one encode produced — reusable while the
    cluster generation, pools, instance types, daemons, and resource axis are
    unchanged. The vocab/zone/taint interners are shared MUTABLY across
    solves: pod-side interning only appends, so row value ids stay stable."""

    vocab: Vocabulary
    dom_key_names: list  # [Kd] label keys (index 0 = zone)
    dom_values: list  # [D] value strings ("" = per-key sentinel)
    dom_key_of_l: list  # [D] dom-key index per domain
    dom_ids: list  # [Kd] dict value -> domain id
    dom_sentinel: list  # [Kd] sentinel domain id per key
    universe_dom: np.ndarray  # [D] bool — NodePool x IT discovered universe
    taint_classes: dict
    taint_sets: list
    templates: list
    row_alloc: np.ndarray
    row_price: np.ndarray
    row_labels0: np.ndarray  # at the vocab width when rows were built
    row_dom: np.ndarray  # [Nrows, Kd]
    row_pool_rank: np.ndarray
    row_taint_class: np.ndarray
    row_meta: list
    # per row: daemon-reserved host ports — offering rows carry their
    # daemon-overhead group's ports (fresh slots open holding them); existing
    # rows carry PHANTOM daemon headroom ports (compatible daemons that have
    # no materialized pod yet, mirroring ExistingNode's port seeding)
    row_daemon_ports: list
    n_existing: int
    rank_domset: np.ndarray  # [Q, D]
    state_nodes: list
    # vocab width at build time: pod-side interning grows the shared vocab
    # monotonically, so reuse is bounded (see EncodeCache growth guard)
    built_n_keys: int = 0
    built_vmax: int = 0
    # decode-side memo (instance-type masks, claim Requirements, template
    # contexts) — tied to THIS artifact's lifetime so template identities in
    # its keys can never go stale
    decode_cache: dict = field(default_factory=dict)


# Why a delta-capable solve routed to the full path anyway — the bounded
# value set of the `karpenter_solver_delta_reject_total{reason}` counter and
# the SolveTrace's `delta_reject` attribution. Producers (encode's
# `_try_delta_encode` and the solver's delta paths — `_solve_delta`,
# `_solve_delta_inner`, and `_solve_masked_delta`'s carry guards) must only
# ever emit values from this tuple; solverlint's metric-label-cardinality
# rule holds the call sites to it.
DELTA_REJECT_REASONS = (
    "unseen-sig",  # appended pod shape could not be grown onto the signature axis
    "row-key",  # row-side drift beyond what the node_generation refresh absorbs
    "vol-rv",  # StorageClass/PV/PVC content changed under the folded volume reqs
    "pvc",  # appended pod carries claim-backed volumes (full encode resolves them)
    "cap",  # delta larger than the amortization bound
    "reorder",  # pod list is not (subsequence + appended tail)
    "fallback-global",  # fallback attribution cannot be re-derived delta-side
    "irreversible",  # removed placed pod owns a required pod-affinity group
    "slot-exhausted",  # delta pack ran out of slots; full (uncapped) pack retries
    "validate",  # stale carry: merged placement failed the fast validator
    "no-carry",  # delta encode succeeded but the device carry is gone/stale
)


class EncodeCache:
    """Cross-solve encode memo owned by a solver instance.

    Pod side: signatures are content-addressed tuples over the pod spec, so
    they are cacheable per (uid, resourceVersion) — an unchanged pod
    re-solving on the next reconcile skips the tuple build, while any pod
    edit bumps resourceVersion and recomputes.

    Row side: the candidate-row tensors are keyed on the state/cluster.py
    GENERATION counter (bumped on every cluster mutation) plus nodepool
    hashes, instance-type identities, daemon versions, and the resource axis
    — a steady-state reconcile with unchanged cluster state skips the whole
    templates/rows build.

    Whole-encode delta (SURVEY.md §7 "incremental state -> device"): when
    the rows are cache-valid and the pod set is the previous solve's plus a
    few appended pods of ALREADY-SEEN signatures (deployment scale-up, the
    steady-state reconcile shape), the previous EncodedSnapshot is reused
    wholesale — per-signature tensors untouched, the added pods appended to
    the pod axis. The result carries `delta_base`/`delta_added` so the
    solver can also run the device pack incrementally."""

    def __init__(self):
        self.row_key: tuple | None = None
        self.rows: _RowArtifacts | None = None
        # whole-encode delta state
        self.last_enc = None  # EncodedSnapshot
        self.last_row_key: tuple | None = None
        self.last_raw_pods: list | None = None  # snap.pods by reference
        self.last_sig_ids: dict[tuple, int] | None = None
        self.last_vol_rv: tuple | None = None  # SC/PV/PVC kind revisions
        # why the newest _try_delta_encode returned None (DELTA_REJECT_REASONS
        # value, or None on a hit / when there was no base to delta against) —
        # read by the solver for trace + counter attribution
        self.last_delta_reject: str | None = None

    def signature(self, pod) -> tuple:
        # the (uid, resourceVersion)-keyed dict this method used to own moved
        # ONTO the Pod object (_SigStamp): same invalidation semantics, no
        # per-solver duplication, and a fresh solver's first encode of a live
        # cluster reads stamps instead of rebuilding 100k tuples
        return pod_signature_cached(pod)


def _try_delta_encode(snap, cache: EncodeCache):
    """Pod-delta fast path: returns an EncodedSnapshot reusing the previous
    encode's tensors wholesale, or None when a full encode is needed.

    Conditions: the pod list is the previous solve's with a small number of
    pods REMOVED (they bound or were deleted — relative order of survivors
    preserved, one O(P) two-pointer identity walk) and/or a small tail of
    APPENDED pods. Appended pods of already-interned signatures ride the base
    tensors untouched; appended pods of UNSEEN in-window signatures GROW the
    per-signature axis (`_grow_signatures`) — new rows appended under the
    existing bucket envelope, so grown shapes stay JIT-stable and the grown
    encode is itself a valid delta base. The row-side cache key must be
    unchanged, OR differ only in `node_generation` over a stable
    node/pool/instance-type/daemon set — the steady-state bind-flush event —
    in which case the volatile row arrays are refreshed in place
    (`_try_row_refresh`) and the solve carries a `delta_row_diff` for the
    device carry. Survivors and additions live on the POD AXIS; the result
    carries `delta_base`/`delta_added_sigs`/`delta_removed_enc` so the
    solver can run the device pack incrementally in both directions. Every
    None return records WHY on `cache.last_delta_reject`
    (DELTA_REJECT_REASONS). Reference analogue: event-driven state updates
    instead of rebuild-per-solve (cluster.go:945-964)."""
    cache.last_delta_reject = None
    base = cache.last_enc
    prev_raw = cache.last_raw_pods
    if base is None or prev_raw is None or cache.last_sig_ids is None:
        return None  # nothing to delta against: a cold encode, not a reject

    def _reject(reason: str):
        cache.last_delta_reject = reason
        return None

    # the base's folded volume requirements are only valid while the
    # SC/PV/PVC content they resolved against is unchanged (the row key
    # can't see those kinds)
    if _volume_kind_revisions(snap) != cache.last_vol_rv:
        return _reject("vol-rv")
    cur = snap.pods
    n_prev = len(prev_raw)
    # Delta-size bound. The original 5%-of-base cap assumed the resident
    # snapshot dwarfs its deltas (a 50k batch re-solved with a few pods
    # moved); the churn SERVING regime inverts that — the pending backlog
    # turns over at the same scale it holds, so appended tails and removal
    # sweeps comparable to the base are the steady-state case. They still
    # pay only O(delta): every per-signature tensor is reused wholesale and
    # the delta pack scans only the added items, so up to 3x the base the
    # delta path beats a full re-encode (unseen signatures or row changes
    # route to the full path below regardless).
    cap = max(64, 3 * n_prev)
    if len(cur) > n_prev + cap or len(cur) < n_prev - cap:
        return _reject("cap")  # larger swings: the full encode amortizes better
    # two-pointer identity walk: prev pods missing from cur (in order) are
    # the removals; whatever cur holds past the walk is the appended tail
    removed_raw: list[int] = []
    j = 0
    n_cur = len(cur)
    for i, p in enumerate(prev_raw):
        if j < n_cur and cur[j] is p:
            j += 1
        else:
            removed_raw.append(i)
            if len(removed_raw) > cap:
                return _reject("cap")
    added = list(cur[j:])
    if len(removed_raw) + len(added) > cap:
        return _reject("cap")
    if removed_raw and added:
        # a previous pod appearing in the tail means cur is NOT
        # (subsequence + appended-new): reordering/insertion — full encode
        removed_ids = {id(prev_raw[i]) for i in removed_raw}
        if any(id(p) in removed_ids for p in added):
            return _reject("reorder")
    from .volumes import has_pvc_volumes

    added_sigs: list[int] = []
    new_sig_pods: list[tuple] = []  # (key, rep pod) per UNSEEN shape, appearance order
    new_sid_of_key: dict = {}
    S0 = base.n_sigs
    for p in added:
        # PVC-backed pods extend their interned key with the RESOLVED volume
        # component (claims/SC/PV content), which the bare signature cannot
        # see — a bare-key hit could alias a comp-less signature and drop the
        # pod's volume constraints; only the full encode resolves components
        if has_pvc_volumes(p):
            return _reject("pvc")
        key = cache.signature(p)
        sid = cache.last_sig_ids.get(key)
        if sid is None:
            # unseen pod shape: the per-signature tensors GROW (below) —
            # provisional ids follow the base axis in appearance order
            sid = new_sid_of_key.get(key)
            if sid is None:
                sid = S0 + len(new_sig_pods)
                new_sid_of_key[key] = sid
                new_sig_pods.append((key, p))
        added_sigs.append(sid)
    row_key = _row_cache_key(snap, base.resource_names, list(base.dom_key_names))
    refresh = None  # (fields, diff, new _RowArtifacts) when the row side drifted
    if row_key != cache.last_row_key:
        refresh = _try_row_refresh(snap, cache, base, row_key)
        if refresh is None:
            return _reject("row-key")
    grown = None  # replacement fields appending the new signatures
    if new_sig_pods:
        rows_now = refresh[2] if refresh is not None else cache.rows
        grown = _grow_signatures(snap, base, rows_now, new_sig_pods)
        if grown is None:
            return _reject("unseen-sig")
    if not added and not removed_raw and refresh is None:
        # identical resubmit: the solver may treat this enc as its own delta
        # base, so the delta arrays stamped when IT was created must not
        # survive to be replayed against the already-merged carry
        base.encode_mode = "delta"
        base.delta_added_sigs = np.zeros(0, np.int32)
        base.delta_removed_enc = np.zeros(0, np.int64)
        base.delta_row_diff = None
        return base
    import dataclasses as _dc

    if removed_raw:
        # map removed raw-order pods to base-enc (FFD-sorted) indices; the
        # base pod list is always a permutation of the raw list it encoded
        enc_idx_of = {id(p): k for k, p in enumerate(base.pods)}
        try:
            removed_enc = np.array(
                sorted(enc_idx_of[id(prev_raw[i])] for i in removed_raw), np.int64
            )
        except KeyError:
            return _reject("reorder")  # raw/enc pod lists diverged (shouldn't happen)
        keep = np.ones(len(base.pods), dtype=bool)
        keep[removed_enc] = False
        kept_pods = [p for k, p in enumerate(base.pods) if keep[k]]
        kept_sigs = base.sig_of_pod[keep]
    else:
        removed_enc = np.zeros(0, np.int64)
        kept_pods = list(base.pods)
        kept_sigs = base.sig_of_pod

    # a fallback-pinned base chains through removals only when the encode's
    # per-signature ATTRIBUTION can prove what the reasons become: with
    # snapshot-global reasons the delta cannot re-derive them; with pod-local
    # reasons, vacating EVERY flagged signature makes the snapshot clean,
    # while vacating only some could not keep the right reason strings —
    # those snapshots take the full encode (appends alone are always safe:
    # all base pods remain and appended pods reuse interned shapes)
    fb_fields: dict = {}
    if removed_raw and base.fallback_reasons:
        if base.fallback_has_global:
            return _reject("fallback-global")
        occupied = {int(s) for s in np.unique(kept_sigs)} | {int(s) for s in added_sigs}
        still = {s for s in base.fallback_sig_local if s in occupied}
        if not still:
            fb_fields = dict(fallback_reasons=[], fallback_sig_local=frozenset())
        elif still != set(base.fallback_sig_local):
            return _reject("fallback-global")

    enc = _dc.replace(
        base,
        # base.pods is FFD-sorted; appended pods process after the batch,
        # which is exactly how the reference treats late arrivals — and
        # build_items merges them into their signature's existing work item,
        # so a full pack on this snapshot is count-identical to a fresh one
        pods=kept_pods + added,
        sig_of_pod=np.concatenate([kept_sigs, np.asarray(added_sigs, np.int32)]),
        **fb_fields,
        **(refresh[0] if refresh is not None else {}),
        **(grown if grown is not None else {}),
    )
    enc.encode_mode = "delta"
    enc.row_cache_hit = True  # a delta encode is by definition row-cache-valid
    enc.delta_base = base
    enc.delta_added_sigs = np.asarray(added_sigs, np.int32)
    enc.delta_removed_enc = removed_enc
    enc.delta_row_diff = refresh[1] if refresh is not None else None
    cached_restrict = getattr(base, "_sig_restrict", None)
    if cached_restrict is not None and grown is None:
        # growth changes S: the [S, Kd] cache recomputes lazily on the
        # grown encode (one cheap row-wise pass over sig_dom_allowed)
        enc._sig_restrict = cached_restrict
    cache.last_enc = enc
    cache.last_raw_pods = list(cur)
    if grown is not None:
        # intern the grown keys so the NEXT delta recognizes them — the
        # grown encode is a first-class delta base (the dict describes
        # cache.last_enc, which is now the grown encode)
        cache.last_sig_ids.update(new_sid_of_key)
    if refresh is not None:
        # the refreshed row artifacts supersede the stale generation for
        # every later consumer (and fresh solvers via the global table)
        cache.row_key = cache.last_row_key = row_key
        cache.rows = refresh[2]
        if len(_ROW_GLOBAL) >= 8 and row_key not in _ROW_GLOBAL:
            _ROW_GLOBAL.clear()
        _ROW_GLOBAL[row_key] = refresh[2]
    _freeze_shared(enc, base)
    maybe_check_encoded(enc, where="delta-encode")
    return enc


def _volume_kind_revisions(snap) -> tuple:
    store = getattr(snap, "store", None)
    if store is None or not hasattr(store, "kind_revision"):
        return (0, 0, 0)
    return (
        store.kind_revision("StorageClass"),
        store.kind_revision("PersistentVolume"),
        store.kind_revision("PersistentVolumeClaim"),
    )


def _row_cache_key(snap, rnames: list[str], dom_keys: list[str]) -> tuple:
    return (
        # epoch is a process-unique token (id() could recycle after GC)
        getattr(snap.cluster, "epoch", None) or id(snap.cluster),
        # node_generation, not generation: pending-pod arrivals bump only the
        # latter, and they are the steady-state churn event the pod-delta
        # path exists for — the row side provably cannot see them
        getattr(snap.cluster, "node_generation", snap.cluster.generation),
        tuple(dom_keys),
        # the SNAPSHOT's node selection, not just cluster content: the
        # disruption simulation filters candidates out of state_nodes without
        # touching the cluster (helpers.py simulate_scheduling)
        tuple(sorted(sn.name() for sn in snap.state_nodes)),
        tuple(sorted((np_.metadata.name, np_.hash()) for np_ in snap.node_pools)),
        tuple(sorted((name, tuple(id(it) for it in its)) for name, its in snap.instance_types.items())),
        tuple(sorted((d.metadata.uid, d.metadata.resource_version) for d in snap.daemonset_pods)),
        tuple(rnames),
    )


def _group_scheduled_counts(snap, group_meta, group_dom_key, rows, state_nodes, solve_uids_of):
    """Initial topology-group counts from already-SCHEDULED cluster pods
    (memoized per (namespace, labels) — bound deployment replicas share
    labels). Shared by the full encode and the row-refresh delta, which must
    re-derive exactly these counts when pods bind/depart between solves."""
    G = len(group_meta)
    D = len(rows.dom_values)
    n_existing = len(state_nodes)
    counts_dom_init = np.zeros((G, D), dtype=np.int32)
    counts_host_existing = np.zeros((G, max(n_existing, 1)), dtype=np.int32)
    if not G:
        return counts_dom_init, counts_host_existing
    dom_ids = rows.dom_ids
    node_by_name = {sn.name(): j for j, sn in enumerate(state_nodes)}
    scheduled = [p for p in snap.store.list("Pod") if p.spec.node_name and pod_utils.is_active(p)]
    solve_uids = solve_uids_of() if scheduled else frozenset()
    match_memo: dict[tuple, list[int]] = {}
    for p in scheduled:
        if p.metadata.uid in solve_uids:
            continue
        mkey = (p.metadata.namespace, tuple(sorted(p.metadata.labels.items())))
        gs = match_memo.get(mkey)
        if gs is None:
            gs = []
            for g, d in enumerate(group_meta):
                if p.metadata.namespace != d["ns"] or d["selector"] is None:
                    continue
                if match_label_selector(d["selector"], p.metadata.labels):
                    gs.append(g)
            match_memo[mkey] = gs
        if not gs:
            continue
        node = snap.store.try_get("Node", p.spec.node_name)
        if node is None:
            continue
        for g in gs:
            dk = int(group_dom_key[g])
            if dk >= 0:
                v = node.metadata.labels.get(rows.dom_key_names[dk])
                if v is not None and v in dom_ids[dk]:
                    counts_dom_init[g, dom_ids[dk][v]] += 1
            else:
                j = node_by_name.get(p.spec.node_name)
                if j is not None:
                    counts_host_existing[g, j] += 1
    return counts_dom_init, counts_host_existing


def _group_registered_of(rows, group_dom_key, counts_dom_init, n_groups: int) -> np.ndarray:
    """Per-group registered-domain universe (see the call site in encode()
    for the host-semantics rationale); shared with the row-refresh delta."""
    D = len(rows.dom_values)
    group_registered = np.zeros((n_groups, D), dtype=bool)
    if n_groups:
        Kd = len(rows.dom_key_names)
        dom_key_of = np.array(rows.dom_key_of_l, dtype=np.int32)
        n_existing = rows.n_existing
        existing_dom = np.zeros(D, dtype=bool)
        if n_existing:
            exd = rows.row_dom[:n_existing].reshape(-1)
            existing_dom[exd[exd >= Kd]] = True  # ids < Kd are sentinels
        for g in range(n_groups):
            dk = int(group_dom_key[g])
            if dk >= 0:
                group_registered[g] = (rows.universe_dom | existing_dom) & (dom_key_of == dk)
        group_registered |= counts_dom_init > 0
    return group_registered


def _existing_row_state(snap, rnames: list[str], state_nodes):
    """Compute the VOLATILE per-existing-node row state from live cluster
    state: remaining allocatable (net of bound pods and phantom daemon
    headroom), phantom daemon ports, and host-port usage. THE single
    definition — `_build_rows` consumes it for the full encode and
    `_try_row_refresh` for the row-refresh delta, so the two can never
    drift. Returns (alloc [E, R] f32, ports per node, phantom daemon ports
    per node)."""
    from ..scheduling.hostports import pod_host_ports as _php
    from .volumes import CSI_AXIS_PREFIX, existing_row_axis_value

    R = len(rnames)
    ridx = {k: i for i, k in enumerate(rnames)}
    csi_axes = [(i, name[len(CSI_AXIS_PREFIX):]) for i, name in enumerate(rnames) if name.startswith(CSI_AXIS_PREFIX)]
    alloc = np.zeros((len(state_nodes), R), dtype=np.float32)
    node_ports: list = []
    phantom_ports: list = []
    for j, sn in enumerate(state_nodes):
        remaining = res.subtract(sn.allocatable(), sn.total_pod_requests())
        daemons = [d for d in snap.daemonset_pods if _daemon_compatible_with_node(sn, sn.taints(), d)]
        headroom = res.subtract(res.requests_for_pods(daemons), sn.total_daemon_requests())
        headroom = {k: v for k, v in headroom.items() if v.milli > 0}
        remaining = res.subtract(remaining, headroom)
        usage = sn.host_port_usage.copy()
        phantom = []
        for d in daemons:
            hps = _php(d)
            if hps and usage.conflicts(d.key(), hps) is None:
                usage.add(f"daemon-headroom/{d.key()}", hps)
                phantom.extend(hps)
        phantom_ports.append(phantom)
        node_ports.append(list(sn.host_port_usage.all_ports()) + phantom)
        vec = np.zeros(R, dtype=np.float32)
        for k, q in remaining.items():
            i = ridx.get(k)
            if i is not None:
                vec[i] = _scale(k, q)
        for i, driver in csi_axes:
            vec[i] = existing_row_axis_value(sn, driver)
        alloc[j] = vec
    return alloc, node_ports, phantom_ports


def _port_mask_rows(port_lists, pk_ids: dict, ps_ids: dict):
    """Lower port lists onto an EXISTING port vocabulary: returns
    (any, wild, spec) boolean masks, or None when a port falls outside the
    vocabulary (the delta paths must route full then — the port axes cannot
    grow without re-encoding every mask)."""
    n = len(port_lists)
    P1, P2 = max(len(pk_ids), 1), max(len(ps_ids), 1)
    any_ = np.zeros((n, P1), dtype=bool)
    wild = np.zeros((n, P1), dtype=bool)
    spec = np.zeros((n, P2), dtype=bool)
    for i, ports in enumerate(port_lists):
        for p in ports:
            k = pk_ids.get((p.port, p.protocol))
            if k is None:
                return None
            any_[i, k] = True
            if p.ip == "0.0.0.0":
                wild[i, k] = True
            else:
                s = ps_ids.get((p.ip, p.port, p.protocol))
                if s is None:
                    return None
                spec[i, s] = True
    return any_, wild, spec


def _try_row_refresh(snap, cache: EncodeCache, base, row_key: tuple):
    """Absorb a `node_generation`-only row-side drift — pods binding to or
    departing from a STABLE node set, the steady-state bind-flush event —
    into the delta path. Every STATIC row artifact (labels, taints, domain
    pins, prices, offering rows, vocabulary) is VERIFIED unchanged and reused
    by reference; the volatile arrays (existing-node remaining capacity,
    initial topology counts, registered domains, host-port usage) are
    recomputed from live state, exactly as `_build_rows` + encode() would.
    Returns (replacement enc fields, carry diff for the solver, refreshed
    _RowArtifacts) or None when the drift is not refresh-shaped. Reference
    analogue: cluster.go:945-964 applies bind/delete deltas to node state
    instead of rebuilding it per reconcile."""
    rows = cache.rows
    old_key = cache.last_row_key
    if rows is None or cache.row_key != old_key or old_key is None:
        return None
    # identical except the node_generation component (index 1 of
    # _row_cache_key): same cluster epoch, domain keys, node-name set,
    # pools, instance types, daemons, and resource axis
    if len(old_key) != len(row_key) or old_key[0] != row_key[0] or old_key[2:] != row_key[2:]:
        return None
    # inverse anti-affinity lowers from RUNNING pods, which no component of
    # the row key captures — any running anti pod (now, or baked into the
    # base's masks) forces the full encode
    cluster = getattr(snap, "cluster", None)
    if cluster is None or cluster.pods_with_anti_affinity():
        return None
    if base.inverse_blocked:
        return None
    if base.fallback_reasons:
        # a hybrid base's carry is the MASKED pack: the diff would need
        # translation onto the masked group/slot axes, and dropping it there
        # would silently desynchronize the carry from the refreshed arrays —
        # route full (cold hybrid re-partition) instead
        return None
    if base.group_meta is None and base.n_groups:
        return None  # pre-retention base: cannot re-derive group counts
    if base.port_key_ids is None:
        return None
    state_nodes = sorted(snap.state_nodes, key=lambda n: n.name())
    n_existing = rows.n_existing
    if len(state_nodes) != n_existing:
        return None
    vocab = rows.vocab
    dom_keys = rows.dom_key_names
    Kd = len(dom_keys)
    K0 = rows.row_labels0.shape[1]
    # -- static verification: the row key hashes node NAMES only; a label,
    # taint, or domain edit bumps the same generation counter a bind does,
    # and must route full. Lookups are non-interning so verification can
    # never widen the shared vocabulary.
    for j, sn in enumerate(state_nodes):
        lbls = sn.labels()
        expect = np.zeros(K0, dtype=np.int32)
        for k, v in lbls.items():
            kid = vocab.keys.get(k)
            if kid is None or kid >= K0:
                return None
            vid = vocab.values[kid].get(v)
            if vid is None:
                return None
            expect[kid] = vid
        if not np.array_equal(expect, rows.row_labels0[j]):
            return None
        tkey = tuple(sorted((t.key, t.value, t.effect) for t in sn.taints()))
        if rows.taint_classes.get(tkey) != int(rows.row_taint_class[j]):
            return None
        for k in range(Kd):
            v = lbls.get(dom_keys[k])
            want = rows.dom_ids[k].get(v) if v else rows.dom_sentinel[k]
            if want is None or want != int(rows.row_dom[j, k]):
                return None
    # -- volatile recompute ---------------------------------------------------
    rnames = base.resource_names
    new_alloc, node_ports, phantom_ports = _existing_row_state(snap, rnames, state_nodes)
    old_exist_alloc = np.asarray(base.row_alloc[:n_existing], dtype=np.float32)
    # existing_port_* arrays are [max(E, 1), P1/P2]
    masks = _port_mask_rows(node_ports if n_existing else [[]], base.port_key_ids, base.port_spec_ids)
    if masks is None:
        return None  # a bound pod introduced ports outside the vocabulary
    new_pany, new_pwild, new_pspec = masks
    ports_changed = not (
        np.array_equal(new_pany, base.existing_port_any)
        and np.array_equal(new_pwild, base.existing_port_wild)
        and np.array_equal(new_pspec, base.existing_port_spec)
    )
    G = base.n_groups
    group_meta = base.group_meta or []
    _uids: set | None = None

    def solve_uids_of() -> set:
        nonlocal _uids
        if _uids is None:
            _uids = set(map(_UID_OF, snap.pods))
        return _uids

    new_cdi, new_che = _group_scheduled_counts(
        snap, group_meta, base.group_dom_key, rows, state_nodes, solve_uids_of
    )
    new_registered = _group_registered_of(rows, base.group_dom_key, new_cdi, G)
    row_alloc_full = np.asarray(base.row_alloc).copy()
    row_alloc_full[:n_existing] = new_alloc
    import dataclasses as _dc

    new_row_meta = [("existing", sn) for sn in state_nodes] + list(rows.row_meta[n_existing:])
    new_daemon_ports = list(phantom_ports) + list(rows.row_daemon_ports[n_existing:])
    new_rows = _dc.replace(
        rows,
        row_alloc=row_alloc_full,
        row_meta=new_row_meta,
        row_daemon_ports=new_daemon_ports,
        state_nodes=state_nodes,
    )
    fields = dict(
        row_alloc=row_alloc_full,
        row_meta=new_row_meta,
        counts_dom_init=new_cdi,
        counts_host_existing=new_che,
        group_registered=new_registered,
        existing_port_any=new_pany,
        existing_port_wild=new_pwild,
        existing_port_spec=new_pspec,
    )
    diff = dict(
        n_existing=n_existing,
        alloc=new_alloc - old_exist_alloc,  # [E, R]
        counts_dom=(new_cdi - base.counts_dom_init) if G else None,  # [G, D]
        counts_host=(new_che - base.counts_host_existing) if G else None,  # [G, max(E,1)]
        ports_changed=ports_changed,
    )
    return fields, diff, new_rows


def _grow_signatures(snap, base, rows, new_sig_pods):
    """Append UNSEEN pod shapes to a delta base's per-signature tensors.

    Each new signature lowers exactly as the full encode would — requirement
    masks over the shared (append-only) vocabulary, taint tolerance against
    the row taint classes, per-key domain masks, inverse anti-affinity
    blocks, group membership/ownership against the RETAINED group metadata,
    host ports against the retained port vocabulary — and the new rows are
    appended to every [S, ...] array. Growth is refused (None) whenever the
    shape cannot ride the base's axes: an out-of-window shape (fallback
    attribution would change), a mask key/value outside the base's [K, W]
    envelope, a port outside the vocabulary, a new resource-axis name, a
    topology group the base never built (the group axis and its counts would
    have to grow), or membership that would break the selector-symmetry
    window. Everything refused routes to the full encode with reason
    "unseen-sig"."""
    if rows is None:
        return None
    if base.group_meta is None and base.n_groups:
        return None
    if base.port_key_ids is None:
        return None
    if getattr(snap, "reserved_offering_mode", "fallback") == "strict":
        return None  # strict reserved mode flags demand per shape: full path
    respect = getattr(snap, "preference_policy", "Respect") == "Respect"
    reps = [p for _k, p in new_sig_pods]
    for pod in reps:
        if _pod_window_reasons(snap, pod, respect, lambda p: None):
            return None  # out-of-window shape: the full encode re-derives attribution
    n_new = len(reps)
    S0 = base.n_sigs
    vocab = rows.vocab
    K_mask = base.sig_mask.shape[1]
    W = base.sig_mask.shape[2]
    Vcap = W * 32

    # -- requirements + vocabulary (append-only: row value ids stay stable) --
    sig_requirements_new = [Requirements.from_pod(p, strict=not respect) for p in reps]
    for reqs in sig_requirements_new:
        for key, r in reqs.items():
            vocab.key_id(key)
            for v in r.values:
                vocab.value_id(key, v)
    if vocab.n_keys > K_mask or vocab.max_values() > Vcap:
        # the base masks' [K, W] envelope cannot hold the new ids; the full
        # encode re-sizes (interned values stay — the encode growth guard
        # tolerates bounded drift before a row rebuild)
        return None

    # -- resource axis (fixed): a new resource name cannot be represented ----
    rnames = base.resource_names
    ridx = {k: i for i, k in enumerate(rnames)}
    sig_requests_new = [res.pod_requests(p) for p in reps]
    if any(k not in ridx for rr in sig_requests_new for k in rr):
        return None
    R = len(rnames)
    sig_req_new = np.zeros((n_new, R), dtype=np.float32)
    for i, rr in enumerate(sig_requests_new):
        for k, q in rr.items():
            sig_req_new[i, ridx[k]] = _scale(k, q)

    # -- requirement bitmasks at the base's exact [K, W] width ---------------
    bool_masks = np.ones((n_new, K_mask, Vcap), dtype=bool)
    for i, reqs in enumerate(sig_requirements_new):
        for key, r in reqs.items():
            kid = vocab.keys[key]
            vals = vocab.values[kid]
            allowed = np.zeros(Vcap, dtype=bool)
            op = r.operator()
            absent_ok = op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST) or key in wk.WELL_KNOWN_LABELS
            allowed[ABSENT] = absent_ok
            for value, vid in vals.items():
                allowed[vid] = r.has(value)
            bool_masks[i, kid] = allowed
    sig_mask_new = pack_bool_masks(bool_masks)
    if sig_mask_new.shape[2] != W:  # words_for(32W) == W by construction
        return None

    # -- taint tolerance against the base's row taint classes ----------------
    C = base.sig_taint_ok.shape[1]
    if len(rows.taint_sets) != C:
        return None
    sig_taint_ok_new = np.ones((n_new, C), dtype=bool)
    for i, pod in enumerate(reps):
        for c, taints in enumerate(rows.taint_sets):
            sig_taint_ok_new[i, c] = taints_tolerate_pod(taints, pod, include_prefer_no_schedule=True) is None

    # -- per-key domain masks + inverse anti-affinity ------------------------
    D = base.n_doms
    dom_allowed_new = np.ones((n_new, D), dtype=bool)
    for i, reqs in enumerate(sig_requirements_new):
        for k, key in enumerate(rows.dom_key_names):
            if not reqs.has(key):
                continue
            r = reqs.get(key)
            dom_allowed_new[i, rows.dom_sentinel[k]] = r.operator() in (Operator.NOT_IN, Operator.DOES_NOT_EXIST)
            for v, did in rows.dom_ids[k].items():
                dom_allowed_new[i, did] = r.has(v)
    inverse_entries = _inverse_anti_entries(snap, lambda: set(map(_UID_OF, snap.pods)))
    host_blocked_new = _apply_inverse_anti_blocks(
        inverse_entries, reps, rows, dom_allowed_new, base.n_existing, rows.state_nodes
    )

    # -- group membership/ownership against the retained group metadata -----
    from ..controllers.provisioning.scheduling.topology import effective_spread_selector

    group_meta = base.group_meta or []
    ident_idx = {m["ident"]: g for g, m in enumerate(group_meta)}
    dom_key_idx = {key: k for k, key in enumerate(rows.dom_key_names)}
    member_new = np.zeros((n_new, base.sig_member.shape[1]), dtype=bool)
    owner_new = np.zeros_like(member_new)
    for i, pod in enumerate(reps):
        declared: list[tuple] = []
        for tsc in pod.spec.topology_spread_constraints:
            if tsc.topology_key == wk.HOSTNAME_LABEL_KEY:
                kind, dk, md = KIND_HOST_SPREAD, -1, 0
            else:
                dk = dom_key_idx.get(tsc.topology_key)
                if dk is None:
                    return None  # domain key the base never interned
                kind, md = KIND_DOM_SPREAD, tsc.min_domains or 0
            eff_sel = effective_spread_selector(pod, tsc)
            declared.append((kind, dk, tsc.max_skew, md, _sel_key(eff_sel), pod.metadata.namespace))
        aff = pod.spec.affinity
        if aff is not None:
            for term in aff.pod_anti_affinity_required:
                if term.topology_key == wk.HOSTNAME_LABEL_KEY:
                    kind, dk = KIND_HOST_ANTI, -1
                else:
                    dk = dom_key_idx.get(term.topology_key)
                    if dk is None:
                        return None
                    kind = KIND_DOM_ANTI
                declared.append((kind, dk, 0, 0, _sel_key(term.label_selector), pod.metadata.namespace))
            for term in aff.pod_affinity_required:
                if term.topology_key == wk.HOSTNAME_LABEL_KEY:
                    kind, dk = KIND_HOST_AFF, -1
                else:
                    dk = dom_key_idx.get(term.topology_key)
                    if dk is None:
                        return None
                    kind = KIND_DOM_AFF
                declared.append((kind, dk, 0, 0, _sel_key(term.label_selector), pod.metadata.namespace))
        for ident in declared:
            g = ident_idx.get(ident)
            if g is None:
                return None  # a group the base never built: the axis must grow
            owner_new[i, g] = True
            member_new[i, g] = True
        for g, m in enumerate(group_meta):
            if (
                pod.metadata.namespace == m["ns"]
                and m["selector"] is not None
                and match_label_selector(m["selector"], pod.metadata.labels)
            ):
                member_new[i, g] = True
        # selector-symmetry window (capability_report's judgment, applied
        # incrementally): for every kind except hostname SPREAD — whose
        # member/owner split the host models exactly — a new shape that is
        # counted-but-not-constrained (or vice versa) by an existing group
        # would change the snapshot's symmetry attribution
        for g, m in enumerate(group_meta):
            if m["kind"] == KIND_HOST_SPREAD:
                continue
            if member_new[i, g] != owner_new[i, g]:
                return None

    # -- host ports against the retained vocabulary --------------------------
    from ..scheduling.hostports import pod_host_ports

    port_rows = _port_mask_rows([pod_host_ports(p) for p in reps], base.port_key_ids, base.port_spec_ids)
    if port_rows is None:
        return None
    pany_new, pwild_new, pspec_new = port_rows
    if pany_new.shape[1] != base.sig_port_any.shape[1] or pspec_new.shape[1] != base.sig_port_spec.shape[1]:
        return None

    # -- requirement classes --------------------------------------------------
    rc_index = {k: i for i, k in enumerate(base.req_class_keys)}
    req_class_keys_new = list(base.req_class_keys)
    rc_of_new = np.zeros(n_new, dtype=np.int32)
    for i, (key, _pod) in enumerate(new_sig_pods):
        class_key = key[0]
        cid = rc_index.get(class_key)
        if cid is None:
            cid = len(req_class_keys_new)
            rc_index[class_key] = cid
            req_class_keys_new.append(class_key)
        rc_of_new[i] = cid

    relax_new = np.fromiter((respect and _is_relaxable(p) for p in reps), dtype=bool, count=n_new)
    sr = base.sig_relaxable
    sig_relaxable = np.concatenate([sr, relax_new]) if sr is not None else None
    return dict(
        sig_req=np.concatenate([base.sig_req, sig_req_new]),
        sig_mask=np.concatenate([base.sig_mask, sig_mask_new]),
        sig_taint_ok=np.concatenate([base.sig_taint_ok, sig_taint_ok_new]),
        sig_dom_allowed=np.concatenate([base.sig_dom_allowed, dom_allowed_new]),
        sig_member=np.concatenate([base.sig_member, member_new]),
        sig_owner=np.concatenate([base.sig_owner, owner_new]),
        sig_host_blocked=np.concatenate([base.sig_host_blocked, host_blocked_new]),
        sig_port_any=np.concatenate([base.sig_port_any, pany_new]),
        sig_port_wild=np.concatenate([base.sig_port_wild, pwild_new]),
        sig_port_spec=np.concatenate([base.sig_port_spec, pspec_new]),
        sig_requirements=list(base.sig_requirements) + sig_requirements_new,
        sig_requests=list(base.sig_requests) + sig_requests_new,
        req_class_of_sig=np.concatenate([base.req_class_of_sig, rc_of_new]),
        req_class_keys=req_class_keys_new,
        sig_relaxable=sig_relaxable,
        has_relaxable=bool(base.has_relaxable or relax_new.any() or base.pools_prefer),
    )


def _build_rows(snap, rnames: list[str], rl_to_vec, dom_keys: list[str]) -> _RowArtifacts:
    """The row side of encode: vocab/domain/taint interning, weight-ordered
    templates with daemon-overhead groups, and one row per existing node and
    per (template x instance type x available offering)."""
    vocab = Vocabulary()
    # CANONICAL dom-key ids: the dom keys intern FIRST, in dom-key order, so
    # `dom_vocab_keys` — a STATIC of the jitted pack (compat_matrix's
    # force-allow columns) — is (0..Kd-1) for every snapshot with the same
    # dom-key list, regardless of incidental interning order. Without this,
    # two tenants of one fleet process reach different vocab ids for the
    # same zone key (interning order depends on the shared signature-stamp
    # state) and tenant N+1's first solve pays a recompile the shared
    # high-water shapes were supposed to prevent.
    for key in dom_keys:
        vocab.key_id(key)

    # keyed domain vocabulary: per-key sentinels first (key order), so the
    # zone sentinel is id 0 (NO_ZONE) and a zone-only snapshot is laid out
    # exactly as the single-key encoding was
    Kd = len(dom_keys)
    dom_values: list[str] = []
    dom_key_of_l: list[int] = []
    dom_ids: list[dict[str, int]] = []
    dom_sentinel: list[int] = []
    for k in range(Kd):
        dom_sentinel.append(len(dom_values))
        dom_values.append("")
        dom_key_of_l.append(k)
        dom_ids.append({})

    def dom_id(k: int, v: str) -> int:
        ids = dom_ids[k]
        d = ids.get(v)
        if d is None:
            d = len(dom_values)
            ids[v] = d
            dom_values.append(v)
            dom_key_of_l.append(k)
        return d

    def zone_id(z: str) -> int:
        return dom_id(0, z)

    taint_classes: dict[tuple, int] = {}
    taint_sets: list[list] = []

    def taint_class(taints) -> int:
        key = tuple(sorted((t.key, t.value, t.effect) for t in taints))
        c = taint_classes.get(key)
        if c is None:
            c = len(taint_sets)
            taint_classes[key] = c
            taint_sets.append(list(taints))
        return c

    # templates, weight-ordered like the scheduler
    pools = sorted(snap.node_pools, key=lambda p: (-p.spec.weight, p.metadata.name))
    templates: list[NodeClaimTemplate] = []
    for np_ in pools:
        t = NodeClaimTemplate(np_)
        its = [it for it in snap.instance_types.get(np_.metadata.name, []) if _template_compatible(t, it)]
        if its:
            t.instance_type_options = its
            templates.append(t)

    row_alloc_l, row_price_l, row_labels_l, row_dom_l = [], [], [], []
    row_rank_l, row_taint_l, row_meta = [], [], []

    def intern_labels(labels: dict[str, str]) -> dict[int, int]:
        return {vocab.key_id(k): vocab.value_id(k, v) for k, v in labels.items()}

    def min_values_cap(t, zone: str | None, overhead_by_it: dict) -> np.ndarray | None:
        """Per-(template, zone) allocatable CAP enforcing the minValues
        envelope on the pack itself: a slot filled past this vector could
        produce a claim that fewer than `min_values` distinct key values can
        hold — which the host prevents per pod (filter_instance_types
        refuses the add) and the minValues-blind pack would otherwise
        discover only at decode, repairing most of the snapshot host-side.
        The cap is the elementwise MIN over the smallest prefix of LARGEST
        types (cpu, then memory — catalog families scale ~proportionally)
        spanning the bound: totals within it fit every prefix type, so the
        decode's post-filter set keeps >= min_values distinct values
        (modulo requirement narrowing, which the widen pass and the bounded
        repair absorb). ZONE-aware because decode pins committed zones into
        claim requirements: a row in a type-poor zone must cap at what THAT
        zone's types can span, not the global envelope. None when the
        template carries no minValues or a bound the (zone's) catalog
        cannot span (decode's repair reproduces the host error)."""
        mv_reqs = [(key, r.min_values) for key, r in t.requirements.items() if r.min_values is not None]
        if not mv_reqs:
            return None
        cands = [
            it
            for it in t.instance_type_options
            if zone is None or any(o.available and o.zone() == zone for o in it.offerings)
        ]
        # NET of daemon overhead, mirroring the row vectors AND the decode
        # fit check (survivors compares gross alloc >= total + ovh): a cap
        # from gross allocatable would let slots fill past what the
        # overhead-burdened prefix types can actually hold
        vecs = {
            id(it): rl_to_vec(
                {k: v for k, v in res.subtract(it.allocatable(), overhead_by_it.get(id(it), {})).items() if v.milli > 0}
            )
            for it in cands
        }
        order = sorted(cands, key=lambda it: (-vecs[id(it)][0], -vecs[id(it)][1]))
        cap = None
        for key, m in mv_reqs:
            tr = t.requirements.get(key)
            seen: set[str] = set()
            cur = None
            for it in order:
                cur = vecs[id(it)] if cur is None else np.minimum(cur, vecs[id(it)])
                r = it.requirements.get(key)
                if r.operator() == Operator.IN:
                    seen.update(v for v in r.values if tr.has(v))
                if len(seen) >= m:
                    break
            if len(seen) < m:
                continue  # unsatisfiable bound: leave rows unclamped
            cap = cur if cap is None else np.minimum(cap, cur)
        if cap is not None:
            # attach-limit axes must stay unbounded (the per-offering clamp
            # runs after the CSI columns are set)
            from .volumes import CSI_AXIS_BIG as _BIG

            cap = cap.copy()
            for i, _driver in csi_axes:
                cap[i] = _BIG
        return cap

    # per-driver CSI attach axes: raw slot counts; existing nodes carry
    # (limit - attached, set in _existing_row_state), new-claim rows are
    # unbounded (the host oracle enforces limits only on existing nodes —
    # ExistingNode.can_add)
    from .volumes import CSI_AXIS_BIG, CSI_AXIS_PREFIX

    csi_axes = [
        (i, name[len(CSI_AXIS_PREFIX):]) for i, name in enumerate(rnames) if name.startswith(CSI_AXIS_PREFIX)
    ]

    # existing nodes first; the volatile per-node state (remaining alloc net
    # of bound pods + phantom daemon headroom, phantom ports) comes from the
    # ONE shared definition the row-refresh delta also recomputes from
    state_nodes = sorted(snap.state_nodes, key=lambda n: n.name())
    exist_alloc, _node_ports, phantom_ports = _existing_row_state(snap, rnames, state_nodes)
    row_daemon_ports: list = list(phantom_ports)
    for j, sn in enumerate(state_nodes):
        lbls = sn.labels()
        row_alloc_l.append(exist_alloc[j])
        row_price_l.append(0.0)
        row_labels_l.append(intern_labels(lbls))
        row_dom_l.append([dom_id(k, lbls[key]) if lbls.get(key) else dom_sentinel[k] for k, key in enumerate(dom_keys)])
        row_rank_l.append(-1)
        row_taint_l.append(taint_class(sn.taints()))
        row_meta.append(("existing", sn))

    n_existing = len(row_meta)

    # per-rank domain sets for custom keys come from the same NodePool x IT
    # requirement discovery the host oracle uses (_build_domain_groups);
    # zones additionally come from the concrete offering rows below
    n_ranks = max(len(templates), 1)
    rank_dom_vals: list[list[set[int]]] = [[set() for _ in range(Kd)] for _ in range(n_ranks)]

    def _req_in_values(reqs, key: str):
        r = reqs.get(key) if hasattr(reqs, "get") else None
        if r is not None and r.operator() == Operator.IN:
            return list(r.values)
        return []

    for rank, t in enumerate(templates):
        has_mv = any(r.min_values is not None for r in t.requirements.values())
        mv_caps: dict = {}  # zone -> cap vector | None, lazily per template
        groups = _compute_daemon_overhead_groups(t, snap.daemonset_pods)
        overhead_by_it = {}
        ports_by_it = {}
        for g in groups:
            gports = g.host_port_usage.all_ports()
            for it in g.instance_types:
                overhead_by_it[id(it)] = g.daemon_overhead
                ports_by_it[id(it)] = gports
        tmpl_label_ids = intern_labels(t.labels)
        tclass = taint_class(t.taints)
        tmpl_dom = [t.labels.get(key) for key in dom_keys]
        for it in t.instance_type_options:
            it_label_ids = dict(tmpl_label_ids)
            for key, r in it.requirements.items():
                if r.operator() == Operator.IN and len(r.values) == 1:
                    it_label_ids[vocab.key_id(key)] = vocab.value_id(key, r.any())
            it_dom = list(tmpl_dom)
            if Kd > 1:
                # template requirements NARROW instance-type domains — the
                # host intersects base with it.requirements before reading
                # values (buildDomainGroups: "zones from an instance type
                # don't expand the universe of valid domains")
                combined = t.requirements.copy()
                combined.add(*it.requirements.values())
                for k in range(1, Kd):
                    vs = _req_in_values(combined, dom_keys[k])
                    for v in vs:
                        rank_dom_vals[rank][k].add(dom_id(k, v))
                    if len(vs) == 1:
                        it_dom[k] = vs[0]
            alloc = res.subtract(it.allocatable(), overhead_by_it.get(id(it), {}))
            alloc_vec = rl_to_vec({k: v for k, v in alloc.items() if v.milli > 0})
            for i, _driver in csi_axes:
                alloc_vec[i] = CSI_AXIS_BIG
            # override offerings share their group's (cached, deduplicated)
            # allocatable instead of recomputing per offering
            ov_vec_of = {}
            for galloc, goffs in it.allocatable_offerings_list()[1:]:
                galloc = res.subtract(galloc, overhead_by_it.get(id(it), {}))
                gvec = rl_to_vec({k: v for k, v in galloc.items() if v.milli > 0})
                for i, _driver in csi_axes:
                    gvec[i] = CSI_AXIS_BIG
                for o in goffs:
                    ov_vec_of[id(o)] = gvec
            for o in it.offerings:
                if not o.available:
                    continue
                if t.requirements.intersects(o.requirements) is not None:
                    continue
                # offering-level overrides give this ROW its own allocatable
                # (nodeclaim.go:624-640 fits iterates AllocatableOfferingsList;
                # here each offering already has its own row, so the override
                # group's vector folds in directly)
                o_alloc_vec = ov_vec_of.get(id(o), alloc_vec)
                labels_o = dict(it_label_ids)
                for key, r in o.requirements.items():
                    if r.operator() == Operator.IN and len(r.values) == 1:
                        labels_o[vocab.key_id(key)] = vocab.value_id(key, r.any())
                o_dom = list(it_dom)
                z = o.zone()
                o_dom[0] = z if z else None
                for k in range(1, Kd):
                    vs = _req_in_values(o.requirements, dom_keys[k])
                    if len(vs) == 1:
                        o_dom[k] = vs[0]
                if has_mv:
                    # minValues envelope, per the row's zone (decode pins the
                    # committed zone into claim requirements, so the row must
                    # not fill past what ITS zone's types can span). This is
                    # what the host binds for zone-constrained claims; for
                    # unconstrained claims the host's bound is the GLOBAL
                    # envelope, so on zone-starved catalogs the tensor pack
                    # bins tighter than the host and opens more claims — a
                    # deliberate conservatism (bench_minvalues emits
                    # n_new_claims so the cost stays visible) traded for a
                    # repair-free pack on every committed zone.
                    zkey = z if z else None
                    if zkey not in mv_caps:
                        mv_caps[zkey] = min_values_cap(t, zkey, overhead_by_it)
                    cap = mv_caps[zkey]
                    if cap is not None:
                        o_alloc_vec = np.minimum(o_alloc_vec, cap)
                row_alloc_l.append(o_alloc_vec)
                row_price_l.append(o.price)
                row_labels_l.append(labels_o)
                row_dom_l.append([dom_id(k, v) if v else dom_sentinel[k] for k, v in enumerate(o_dom)])
                row_rank_l.append(rank)
                row_taint_l.append(tclass)
                row_daemon_ports.append(ports_by_it.get(id(it), []))
                row_meta.append(("offering", t, it, o))

    n_rows = len(row_meta)
    K = max(vocab.n_keys, 1)
    row_labels0 = np.zeros((n_rows, K), dtype=np.int32)
    for i, lbl in enumerate(row_labels_l):
        for kid, vid in lbl.items():
            row_labels0[i, kid] = vid
    row_dom = (
        np.array(row_dom_l, dtype=np.int32) if row_dom_l else np.zeros((0, Kd), np.int32)
    )

    # registered-domain universe per key, mirroring the host's
    # _build_domain_groups: per (NodePool, InstanceType) the base template
    # requirements INTERSECT the instance type's before values register
    # ("zones from an instance type don't expand the universe of valid
    # domains"), plus the base-only pass; values register even when no row
    # carries them — an empty registered domain pulls the spread minimum
    # down host-side, and must do the same on-device
    by_name = {p.metadata.name: p for p in snap.node_pools}
    universe_ids: set[int] = set()
    for np_name, its in snap.instance_types.items():
        pool = by_name.get(np_name)
        if pool is None:
            continue
        base = Requirements.from_node_selector_terms(pool.spec.template.requirements)
        base.add(*Requirements.from_labels(pool.spec.template.labels).values())
        for k in range(Kd):
            for v in _req_in_values(base, dom_keys[k]):
                universe_ids.add(dom_id(k, v))
        for it in its:
            combined = base.copy()
            combined.add(*it.requirements.values())
            for k in range(Kd):
                for v in _req_in_values(combined, dom_keys[k]):
                    universe_ids.add(dom_id(k, v))

    # domain axis is closed now
    D = len(dom_values)
    universe_dom = np.zeros(D, dtype=bool)
    for d in sorted(universe_ids):
        universe_dom[d] = True

    rank_domset = np.zeros((n_ranks, D), dtype=bool)
    for i in range(n_existing, n_rows):
        rank_domset[row_rank_l[i], row_dom[i, 0]] = True  # zones: concrete offerings
    for rank in range(len(templates)):
        for k in range(1, Kd):
            vals = rank_dom_vals[rank][k]
            if vals:
                for d in vals:
                    rank_domset[rank, d] = True
            else:
                # template rank carries no requirement on this key: a fresh
                # node will simply lack the label
                rank_domset[rank, dom_sentinel[k]] = True

    R = len(rnames)
    return _RowArtifacts(
        vocab=vocab,
        dom_key_names=list(dom_keys),
        dom_values=dom_values,
        dom_key_of_l=dom_key_of_l,
        dom_ids=dom_ids,
        dom_sentinel=dom_sentinel,
        universe_dom=universe_dom,
        taint_classes=taint_classes,
        taint_sets=taint_sets,
        templates=templates,
        row_alloc=np.stack(row_alloc_l) if row_alloc_l else np.zeros((0, R), np.float32),
        row_price=np.array(row_price_l, dtype=np.float32),
        row_labels0=row_labels0,
        row_dom=row_dom,
        row_pool_rank=np.array(row_rank_l, dtype=np.int32),
        row_taint_class=np.array(row_taint_l, dtype=np.int32),
        row_meta=row_meta,
        row_daemon_ports=row_daemon_ports,
        n_existing=n_existing,
        rank_domset=rank_domset,
        state_nodes=state_nodes,
        built_n_keys=vocab.n_keys,
        built_vmax=vocab.max_values(),
    )


def encode(snap, cache: EncodeCache | None = None) -> EncodedSnapshot:
    # -- whole-encode delta: previous pod set + appended known shapes ---------
    if cache is not None:
        delta = _try_delta_encode(snap, cache)
        if delta is not None:
            return delta

    # -- signature grouping (the hot O(P) pass: columnar — cheap tuple
    # building only, pod-object stamps skip even that, and everything heavy
    # below runs per unique signature)
    if cache is not None:
        sig_of = pod_signature_cached
    else:
        sig_of = pod_signature
    # stamped pods resolve inline in the loop below (one attribute read, no
    # call); only misses go through sig_of. Plain encode(snap) without a
    # cache never stamps — in-place pod mutation between uncached encodes
    # stays visible, exactly as before.
    use_stamp = cache is not None
    # grouping probes: stamped signatures are interned (equal content = same
    # object), so the per-pod dict probe hashes id() — an int — instead of a
    # nested tuple; the uncached path probes by content
    sig_ids: dict = {}
    rep_keys: list[tuple] = []  # signature key per rep (content, for classes)
    rep_pods: list = []
    P0 = len(snap.pods)
    sig_of_pod_l: list[int] = []
    # PVC-backed volumes (solver/volumes.py): pods with resolvable single-
    # alternative volume constraints stay in-window; the resolved component
    # extends the signature key (same claims-shape pods group together) and
    # later folds into the signature's requirements + synthetic attach axes
    from .volumes import VolumeLowering, window_reasons

    lowering: VolumeLowering | None = None
    vol_comp_of_sig: list = []  # parallel to rep_pods
    # (sig id | None, reason): sig-attributed issues feed the hybrid
    # partitioner; None marks snapshot-global ones (fallback.py decides tier)
    vol_issues: list[tuple[int | None, str]] = []
    pvc_owner: dict[str, tuple[str, int | None]] = {}  # pvc id -> (pod key, sig)

    grouped, garts = _columnar_group(snap.pods) if use_stamp and P0 else (None, None)
    if grouped is None:
        garts = None  # FFD-order caching rides the grouped path only
    if grouped is not None:
        # C-speed path: no PVC pods, every stamp fresh — the common
        # steady-state/large-cluster shape; the sequential loop below is
        # skipped entirely (its work list is empty)
        sig_of_pod_raw, rep_idx, rep_keys = grouped
        rep_pods = list(map(snap.pods.__getitem__, rep_idx.tolist()))
        vol_comp_of_sig = [None] * len(rep_pods)
        scan_pods = ()
    else:
        scan_pods = snap.pods
    # THE one sanctioned O(P) pass — cheap signature-tuple interning only
    # (stamped pods are one attribute read), and the stamped common case
    # bypasses it entirely via _columnar_group; every heavy lowering below
    # runs per unique signature. The `scan_pods` alias sits outside the
    # pod-axis rule's name list on purpose: a direct `snap.pods` walk added
    # later still trips the gate.
    for pod in scan_pods:
        if use_stamp:
            st = getattr(pod, "_sig_stamp", None)
            if st is not None and st.rv == pod.metadata.resource_version:
                k = st.sig
                pvc = st.pvc
            else:
                k = sig_of(pod)
                pvc = _sig_has_claims(k[8])
            probe = id(k)
        else:
            k = sig_of(pod)
            # the signature's volume column already says whether the pod
            # carries PVC-backed volumes — no second per-pod spec walk
            pvc = _sig_has_claims(k[8])
            probe = k
        comp = None
        pod_pvc_ids = ()
        if pvc:
            if getattr(snap, "store", None) is None:
                vol_issues.append((None, f"{pod.key()}: PVC-backed volumes (no store)"))
            else:
                if lowering is None:
                    lowering = VolumeLowering(snap.store)
                comp = lowering.component(pod)
            if comp is not None:
                k = (k, ("vol", comp.fingerprint))
                if use_stamp:
                    k = _intern_sig(k)
                    probe = id(k)
                else:
                    probe = k
                pod_pvc_ids = comp.pvc_ids
        sid = sig_ids.get(probe)
        if sid is None:
            sid = len(rep_pods)
            sig_ids[probe] = sid
            rep_keys.append(k)
            rep_pods.append(pod)
            vol_comp_of_sig.append(comp)
            if comp is not None:
                vol_issues.extend((sid, r) for r in window_reasons(comp, pod))
        # the attach axes are additive per pod; the host counts DISTINCT
        # claim ids, so a claim shared between solve pods (or k *new*
        # references to one) must stay host-side — both holders' signatures
        # are flagged so the host path sees every reference
        for pid in pod_pvc_ids:
            other_key, other_sid = pvc_owner.setdefault(pid, (pod.key(), sid))
            if other_key != pod.key():
                vol_issues.append((sid, f"{pod.key()}: pvc {pid} shared with {other_key}"))
                vol_issues.append((other_sid, f"{other_key}: pvc {pid} shared with {pod.key()}"))
        sig_of_pod_l.append(sid)
    if grouped is None:
        sig_of_pod_raw = np.asarray(sig_of_pod_l, dtype=np.int32) if sig_of_pod_l else np.empty(0, np.int32)
    S = len(rep_pods)
    if pvc_owner:
        # a solve pod's claim already attached on a node would double-count
        # against the node's axis (the host dedupes by id — volumeusage.go)
        for sn in snap.state_nodes:
            hit = sn.volume_usage.attached_ids() & pvc_owner.keys()
            for pid in hit:
                owner_key, owner_sid = pvc_owner[pid]
                vol_issues.append((owner_sid, f"{owner_key}: pvc {pid} already attached on {sn.name()}"))

    # requirement classes: signatures sharing (node_selector, affinity) lower
    # to the same Requirements — decode caches its per-claim instance-type
    # compat masks on these, not on full signatures (pods differing only in
    # requests share one class)
    req_class_ids: dict[tuple, int] = {}
    req_class_of_sig = np.zeros(S, dtype=np.int32)
    for sid, key in enumerate(rep_keys):
        # volume-extended keys are (base_sig, ("vol", fp)): the requirement
        # class must include the volume fingerprint — folded volume reqs make
        # otherwise-identical selectors lower differently
        if vol_comp_of_sig[sid] is not None:
            class_key = (key[0][0], key[1])
        else:
            class_key = key[0]
        cid = req_class_ids.setdefault(class_key, len(req_class_ids))
        req_class_of_sig[sid] = cid
    req_class_keys: list = [None] * len(req_class_ids)
    for key0, cid in req_class_ids.items():
        req_class_keys[cid] = key0

    report = capability_report(snap, rep_pods, vol_comps=vol_comp_of_sig)
    for sid, r in vol_issues:
        report.add(r, sig=sid)
    reasons = report.reasons

    # -- per-signature heavy lowering -----------------------------------------
    respect = getattr(snap, "preference_policy", "Respect") == "Respect"
    sig_requests = [res.pod_requests(p) for p in rep_pods]
    # tier-0 preference honoring: include the heaviest preferred node-affinity
    # term exactly like the un-relaxed FFD (requirements.go:74-110); strict
    # under the Ignore policy
    sig_requirements = [Requirements.from_pod(p, strict=not respect) for p in rep_pods]
    # fold each signature's single volume-topology alternative into its
    # requirement mask (host: _try_volume_alternative with one entry attaches
    # it to claim/node requirements; with no branching the two are equal)
    for s, comp in enumerate(vol_comp_of_sig):
        if comp is not None and comp.requirements is not None:
            sig_requirements[s].add(*comp.requirements.values())

    # -- resource axis ---------------------------------------------------------
    from .volumes import CSI_AXIS_PREFIX

    rnames = ["cpu", "memory", "pods", "ephemeral-storage"]
    seen = set(rnames)
    for rr in sig_requests:
        for k in rr:
            if k not in seen:
                seen.add(k)
                rnames.append(k)
    # per-driver attach axes, in raw slot counts (not Quantity-scaled)
    for comp in vol_comp_of_sig:
        if comp is not None:
            for driver, _n in comp.drivers:
                name = CSI_AXIS_PREFIX + driver
                if name not in seen:
                    seen.add(name)
                    rnames.append(name)
    ridx = {k: i for i, k in enumerate(rnames)}
    R = len(rnames)

    def rl_to_vec(rl: dict) -> np.ndarray:
        v = np.zeros(R, dtype=np.float32)
        for k, q in rl.items():
            i = ridx.get(k)
            if i is not None:
                v[i] = _scale(k, q)
        return v

    # -- row side: cached across solves on the cluster generation -------------
    # solve-pod uid set: O(P) to build, needed only by inverse anti-affinity
    # and the initial topology counts — built lazily, at most once
    _solve_uids: set | None = None

    def solve_uids_of() -> set:
        nonlocal _solve_uids
        if _solve_uids is None:
            _solve_uids = set(map(_UID_OF, snap.pods))
        return _solve_uids

    inverse_entries = _inverse_anti_entries(snap, solve_uids_of)
    dom_keys = _dom_keys_for(rep_pods, extra_keys=[e["key"] for e in inverse_entries])
    rows: _RowArtifacts | None = None
    row_key: tuple | None = None
    if cache is not None:
        row_key = _row_cache_key(snap, rnames, dom_keys)
        if cache.row_key == row_key:
            rows = cache.rows
        else:
            # like the signature stamps, row artifacts survive solver
            # restarts and cache clears: the content-addressed global table
            # hands a fresh EncodeCache the rows an earlier solver built for
            # the same cluster generation
            rows = _ROW_GLOBAL.get(row_key)
        # growth guard: pod-side interning widens the shared vocab; churn
        # with ever-new requirement values would widen the S x K x Vmax
        # masks without bound — rebuild once drift exceeds the slack
        if rows is not None and (
            rows.vocab.n_keys > rows.built_n_keys + 64 or rows.vocab.max_values() > rows.built_vmax + 256
        ):
            rows = None
    row_cache_hit = rows is not None  # solvetrace attribution (obs/trace.py)
    if rows is None:
        rows = _build_rows(snap, rnames, rl_to_vec, dom_keys)
    if cache is not None and cache.rows is not rows:
        cache.row_key, cache.rows = row_key, rows
        if len(_ROW_GLOBAL) >= 8 and row_key not in _ROW_GLOBAL:
            _ROW_GLOBAL.clear()  # bound: a handful of live row keys
        _ROW_GLOBAL[row_key] = rows
    vocab = rows.vocab
    dom_values = rows.dom_values
    dom_ids = rows.dom_ids
    dom_sentinel = rows.dom_sentinel
    dom_key_of = np.array(rows.dom_key_of_l, dtype=np.int32)
    taint_sets = rows.taint_sets
    templates = rows.templates
    state_nodes = rows.state_nodes
    row_meta = rows.row_meta
    n_existing = rows.n_existing
    row_labels = rows.row_labels0

    # -- pod queue order (FFD: cpu desc, mem desc, creation, uid) --------------
    # per-signature cpu/mem broadcast to pods by index, then one vectorized
    # lexsort — no 50k-tuple Python sort on the hot path
    sig_cpu = np.fromiter((-(rr.get("cpu", _Q0).milli) for rr in sig_requests), dtype=np.int64, count=S)
    sig_mem = np.fromiter((-(rr.get("memory", _Q0).milli) for rr in sig_requests), dtype=np.int64, count=S)
    if garts is not None and "order" in garts:
        # _GroupMemo hit: same pod objects at the same resource_versions ⇒
        # the creation/uid columns and therefore the whole FFD order are
        # unchanged (sig_cpu/sig_mem derive from the memoized grouping)
        order = garts["order"]
        pods = garts["pods_sorted"].copy()  # downstream owns its list
    else:
        # columnar extraction: attrgetter-driven C loops, no per-pod bytecode;
        # the uid tiebreak column reuses the outgoing group-memo generation's
        # bytes for shared pod objects (_uid_column) instead of materializing
        # P strings per cold sort
        created = np.fromiter(map(_CREATED_OF, snap.pods), dtype=np.float64, count=P0)
        uid = _uid_column(snap.pods, P0)
        # last lexsort key is primary
        order = np.lexsort((uid, created, sig_mem[sig_of_pod_raw], sig_cpu[sig_of_pod_raw]))
        pods = list(map(snap.pods.__getitem__, order.tolist()))
        if garts is not None:
            order.setflags(write=False)
            uid.setflags(write=False)
            garts["order"] = order
            garts["pods_sorted"] = pods.copy()
            garts["uid_raw"] = uid
    sig_of_pod = sig_of_pod_raw[order]
    P = P0

    sig_req = np.zeros((S, R), dtype=np.float32)
    for s, rr in enumerate(sig_requests):
        sig_req[s] = rl_to_vec(rr)
        comp = vol_comp_of_sig[s]
        if comp is not None:
            for driver, n in comp.drivers:
                sig_req[s, ridx[CSI_AXIS_PREFIX + driver]] = float(n)

    # vocabulary must be closed before masks are sized; pod requirement values
    # not present on any row still need ids (they simply never match)
    for reqs in sig_requirements:
        for key, r in reqs.items():
            vocab.key_id(key)
            for v in r.values:
                vocab.value_id(key, v)

    K = vocab.n_keys
    Vmax = vocab.max_values()
    W = words_for(Vmax)
    # re-pad row_labels to the final K
    if row_labels.shape[1] < K:
        row_labels = np.pad(row_labels, ((0, 0), (0, K - row_labels.shape[1])))

    bool_masks = np.ones((S, K, Vmax), dtype=bool)
    for s, reqs in enumerate(sig_requirements):
        for key, r in reqs.items():
            kid = vocab.keys[key]
            vals = vocab.values[kid]
            allowed = np.zeros(Vmax, dtype=bool)
            # absent-value semantics: row lacking the key is compatible iff the
            # operator permits absence (NotIn/DoesNotExist) or the key is
            # well-known (requirements.go:181-199 Compatible w/ AllowUndefined)
            op = r.operator()
            absent_ok = op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST) or key in wk.WELL_KNOWN_LABELS
            allowed[ABSENT] = absent_ok
            for value, vid in vals.items():
                allowed[vid] = r.has(value)
            bool_masks[s, kid] = allowed
    sig_mask = pack_bool_masks(bool_masks)

    C = len(taint_sets)
    sig_taint_ok = np.ones((S, C), dtype=bool)
    for s, pod in enumerate(rep_pods):
        for c, taints in enumerate(taint_sets):
            sig_taint_ok[s, c] = taints_tolerate_pod(taints, pod, include_prefer_no_schedule=True) is None

    D = len(dom_values)
    sig_dom_allowed = np.ones((S, D), dtype=bool)
    for s, reqs in enumerate(sig_requirements):
        for k, key in enumerate(rows.dom_key_names):
            if not reqs.has(key):
                continue
            r = reqs.get(key)
            # per-key sentinel ("row carries no value"): acceptable only when
            # the operator permits absence — the domain machinery is the
            # strict handler for these keys (they are excluded from the label
            # bitmask compat), so no well-known-undefined allowance here
            sig_dom_allowed[s, dom_sentinel[k]] = r.operator() in (Operator.NOT_IN, Operator.DOES_NOT_EXIST)
            for v, did in dom_ids[k].items():
                sig_dom_allowed[s, did] = r.has(v)

    # inverse anti-affinity from running pods: selected signatures may only
    # land in registered-but-unrecorded domains of each matching term's key
    # (and never on the running pod's own node for hostname terms)
    sig_host_blocked = _apply_inverse_anti_blocks(
        inverse_entries, rep_pods, rows, sig_dom_allowed, n_existing, state_nodes
    )

    # -- host-port vocabulary + masks -----------------------------------------
    from ..scheduling.hostports import pod_host_ports

    sig_ports = [pod_host_ports(p) for p in rep_pods]
    if any(sig_ports):
        # the state node already tracks its bound pods' ports
        # (statenode.py:154); add the PHANTOM daemon headroom ports computed
        # at row build (ExistingNode seeds the same set host-side)
        existing_ports = [
            list(sn.host_port_usage.all_ports()) + list(rows.row_daemon_ports[j])
            for j, sn in enumerate(state_nodes)
        ]
        # fresh slots of a row open with its daemon group's ports reserved
        # (suite_test.go:955; host analogue seeds DaemonOverheadGroup usage)
        daemon_row_ports = rows.row_daemon_ports
    else:
        existing_ports = [[] for _ in state_nodes]
        daemon_row_ports = [[] for _ in rows.row_meta]
    pk_ids: dict[tuple, int] = {}
    ps_ids: dict[tuple, int] = {}
    for ports in sig_ports + existing_ports + list(daemon_row_ports):
        for p in ports:
            pk_ids.setdefault((p.port, p.protocol), len(pk_ids))
            if p.ip != "0.0.0.0":
                ps_ids.setdefault((p.ip, p.port, p.protocol), len(ps_ids))
    P1, P2 = max(len(pk_ids), 1), max(len(ps_ids), 1)

    def port_masks(port_lists, n):
        any_ = np.zeros((n, P1), dtype=bool)
        wild = np.zeros((n, P1), dtype=bool)
        spec = np.zeros((n, P2), dtype=bool)
        for i, ports in enumerate(port_lists):
            for p in ports:
                k = pk_ids[(p.port, p.protocol)]
                any_[i, k] = True
                if p.ip == "0.0.0.0":
                    wild[i, k] = True
                else:
                    spec[i, ps_ids[(p.ip, p.port, p.protocol)]] = True
        return any_, wild, spec

    sig_port_any, sig_port_wild, sig_port_spec = port_masks(sig_ports, S)
    existing_port_any, existing_port_wild, existing_port_spec = port_masks(existing_ports, max(n_existing, 1))
    row_port_any, row_port_wild, row_port_spec = port_masks(daemon_row_ports, max(len(rows.row_meta), 1))

    dom_vocab_keys = tuple(vocab.keys.get(key, -1) for key in rows.dom_key_names)
    dom_key_idx = {key: k for k, key in enumerate(rows.dom_key_names)}

    # -- topology groups (identified from signature representatives) -----------
    group_defs: dict[tuple, dict] = {}  # identity -> {kind, dom_key, skew, ...}
    memberships: list[tuple[int, tuple]] = []  # (sig idx, identity)
    from ..controllers.provisioning.scheduling.topology import effective_spread_selector

    for s, pod in enumerate(rep_pods):
        for tsc in pod.spec.topology_spread_constraints:
            if tsc.topology_key == wk.HOSTNAME_LABEL_KEY:
                # hostname minDomains never forces the min to zero host-side
                # (_domain_min_count returns 0 for hostname regardless)
                kind, dk, md = KIND_HOST_SPREAD, -1, 0
            else:
                kind, dk = KIND_DOM_SPREAD, dom_key_idx[tsc.topology_key]
                md = tsc.min_domains or 0
            # matchLabelKeys values merge into the selector, so pods of
            # different sub-deployments form DISTINCT spread groups
            eff_sel = effective_spread_selector(pod, tsc)
            ident = (kind, dk, tsc.max_skew, md, _sel_key(eff_sel), pod.metadata.namespace)
            group_defs.setdefault(
                ident,
                {"kind": kind, "dom_key": dk, "skew": tsc.max_skew, "min_domains": md, "selector": eff_sel, "ns": pod.metadata.namespace},
            )
            memberships.append((s, ident))
        aff = pod.spec.affinity
        if aff is not None:
            for term in aff.pod_anti_affinity_required:
                if term.topology_key == wk.HOSTNAME_LABEL_KEY:
                    kind, dk = KIND_HOST_ANTI, -1
                else:
                    kind, dk = KIND_DOM_ANTI, dom_key_idx[term.topology_key]
                ident = (kind, dk, 0, 0, _sel_key(term.label_selector), pod.metadata.namespace)
                group_defs.setdefault(
                    ident,
                    {"kind": kind, "dom_key": dk, "skew": 0, "min_domains": 0, "selector": term.label_selector, "ns": pod.metadata.namespace},
                )
                memberships.append((s, ident))
            for term in aff.pod_affinity_required:
                # required pod affinity (topology.go:246-282): members
                # co-locate in recorded domains, bootstrapping one when none
                # is reachable
                if term.topology_key == wk.HOSTNAME_LABEL_KEY:
                    kind, dk = KIND_HOST_AFF, -1
                else:
                    kind, dk = KIND_DOM_AFF, dom_key_idx[term.topology_key]
                ident = (kind, dk, 0, 0, _sel_key(term.label_selector), pod.metadata.namespace)
                group_defs.setdefault(
                    ident,
                    {"kind": kind, "dom_key": dk, "skew": 0, "min_domains": 0, "selector": term.label_selector, "ns": pod.metadata.namespace},
                )
                memberships.append((s, ident))

    idents = list(group_defs.keys())
    gidx = {ident: g for g, ident in enumerate(idents)}
    G = len(idents)
    group_kind = np.array([group_defs[i]["kind"] for i in idents], dtype=np.int32) if G else np.zeros(0, np.int32)
    group_skew = np.array([group_defs[i]["skew"] for i in idents], dtype=np.int32) if G else np.zeros(0, np.int32)
    group_dom_key = np.array([group_defs[i]["dom_key"] for i in idents], dtype=np.int32) if G else np.zeros(0, np.int32)
    group_min_domains = np.array([group_defs[i]["min_domains"] for i in idents], dtype=np.int32) if G else np.zeros(0, np.int32)
    # membership (COUNTED: the group's selector selects the pod) vs ownership
    # (CONSTRAINED: the pod declares the constraint) — the host constrains
    # only owners (_matching_topologies is_owned_by) while counting every
    # selected pod. Hostname groups keep the split exactly; keyed-domain
    # groups are in-window only when the two sets coincide
    # (check_capability's symmetry rules).
    sig_member = np.zeros((S, G), dtype=bool)
    sig_owner = np.zeros((S, G), dtype=bool)
    for g, ident in enumerate(idents):
        d = group_defs[ident]
        for s, pod in enumerate(rep_pods):
            if pod.metadata.namespace == d["ns"] and d["selector"] is not None and match_label_selector(d["selector"], pod.metadata.labels):
                sig_member[s, g] = True
    for s, ident in memberships:
        sig_member[s, gidx[ident]] = True
        sig_owner[s, gidx[ident]] = True

    # initial counts from already-scheduled cluster pods (memoized on the
    # pod's (namespace, labels) — bound deployment replicas share labels)
    group_meta = [
        dict(
            ident=ident,
            kind=group_defs[ident]["kind"],
            dom_key=group_defs[ident]["dom_key"],
            selector=group_defs[ident]["selector"],
            ns=group_defs[ident]["ns"],
        )
        for ident in idents
    ]
    counts_dom_init, counts_host_existing = _group_scheduled_counts(
        snap, group_meta, group_dom_key, rows, state_nodes, solve_uids_of
    )

    # each group's registered-domain universe: the NodePool x IT discovery,
    # plus existing nodes' label values (topology.py _count_domains /
    # reference countDomains "capture new domain values from existing
    # nodes"), plus every domain that already counts pods (record()).
    # The per-group node filter reduces to the per-item allowed-domain mask
    # for in-window snapshots (key-only filters), so registration here is
    # unfiltered and za does the narrowing.
    group_registered = _group_registered_of(rows, group_dom_key, counts_dom_init, G if G else 0)

    sig_relaxable = np.fromiter((respect and _is_relaxable(p) for p in rep_pods), dtype=bool, count=S)
    pools_prefer = bool(pools_taint_prefer_no_schedule(snap.node_pools))
    enc_out = EncodedSnapshot(
        resource_names=rnames,
        vocab=vocab,
        n_existing=n_existing,
        row_alloc=rows.row_alloc,
        row_price=rows.row_price,
        row_labels=row_labels,
        row_dom=rows.row_dom,
        row_pool_rank=rows.row_pool_rank,
        row_taint_class=rows.row_taint_class,
        row_meta=row_meta,
        pods=pods,
        sig_of_pod=sig_of_pod,
        sig_req=sig_req,
        sig_mask=sig_mask,
        sig_taint_ok=sig_taint_ok,
        sig_dom_allowed=sig_dom_allowed,
        sig_member=sig_member,
        sig_owner=sig_owner,
        sig_requirements=sig_requirements,
        sig_requests=sig_requests,
        req_class_of_sig=req_class_of_sig,
        sig_host_blocked=sig_host_blocked,
        sig_port_any=sig_port_any,
        sig_port_wild=sig_port_wild,
        sig_port_spec=sig_port_spec,
        existing_port_any=existing_port_any,
        existing_port_wild=existing_port_wild,
        existing_port_spec=existing_port_spec,
        row_port_any=row_port_any,
        row_port_wild=row_port_wild,
        row_port_spec=row_port_spec,
        n_doms=D,
        dom_values=dom_values,
        dom_key_of=dom_key_of,
        dom_key_names=list(rows.dom_key_names),
        dom_vocab_keys=dom_vocab_keys,
        rank_domset=rows.rank_domset,
        group_kind=group_kind,
        group_skew=group_skew,
        group_dom_key=group_dom_key,
        group_min_domains=group_min_domains,
        group_registered=group_registered,
        counts_dom_init=counts_dom_init,
        counts_host_existing=counts_host_existing,
        fallback_reasons=reasons,
        fallback_sig_local=frozenset(report.sig_local),
        fallback_has_global=report.has_global,
        # PreferNoSchedule template taints block tier-0 and resolve via the
        # host relaxation toleration, so their presence makes any unplaced
        # pod a relaxation case (scheduler.go:146-151)
        has_relaxable=bool(sig_relaxable.any()) or pools_prefer,
        req_class_keys=req_class_keys,
        decode_cache=rows.decode_cache,
        sig_relaxable=sig_relaxable,
        pools_prefer=pools_prefer,
        group_meta=group_meta,
        port_key_ids=pk_ids,
        port_spec_ids=ps_ids,
        inverse_blocked=bool(inverse_entries),
        universe_dom=rows.universe_dom,
    )
    enc_out.row_cache_hit = row_cache_hit
    if cache is not None:
        cache.last_enc = enc_out
        cache.last_row_key = row_key if row_key is not None else _row_cache_key(snap, rnames, dom_keys)
        cache.last_raw_pods = list(snap.pods)
        # content-keyed (the grouping dict may be identity-probed): the delta
        # path looks appended pods' signatures up by VALUE
        cache.last_sig_ids = {k: i for i, k in enumerate(rep_keys)}
        cache.last_vol_rv = _volume_kind_revisions(snap)
    maybe_check_encoded(enc_out, where="encode")
    return enc_out


def _is_relaxable(pod) -> bool:
    """Pod carries soft constraints preferences.go would peel on failure."""
    aff = pod.spec.affinity
    na = aff.node_affinity if aff else None
    if na is not None and (na.preferred or len(na.required) > 1):
        return True
    return any(t.when_unsatisfiable != "DoNotSchedule" for t in pod.spec.topology_spread_constraints)


def _scale(resource: str, q: Quantity) -> float:
    """Exact-in-f32 scaling: cpu stays in milli; memory/storage in MiB."""
    if resource in ("memory", "ephemeral-storage"):
        return q.milli / 1000.0 / (1024.0**2)
    return float(q.milli)


def _sel_key(selector) -> tuple:
    if selector is None:
        return ()
    ml = tuple(sorted((selector.get("matchLabels") or {}).items()))
    me = tuple(
        sorted((e["key"], e["operator"], tuple(sorted(e.get("values", [])))) for e in (selector.get("matchExpressions") or []))
    )
    return (ml, me)
