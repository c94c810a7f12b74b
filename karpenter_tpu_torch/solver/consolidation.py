"""Multi-node consolidation on the device: the consolidation encoder and the
proposers, from candidates to the ranked delete-set proposals.

Counterpart of the reference's `solver/consolidation.py`.
`_candidate_vectors` reads the candidates (per-node price, cost, slack,
used resources and pod count, the (label-set, class) compatibility table,
the replacement rows, the pending-class mass) into a
`ConsolidationProblem` (`encode_problem`); `tensors_from_problem` pads it
into device tensors as the reference's `encode_candidates_lp` does, and
`encode_candidates_lp` / `encode_candidates` run both. Three proposers
mirror the reference step for step on a problem:

* `propose_problem_lp`: relaxed repack (kernel K5) from C random inits,
  host rounding of the fractional deletions into delete-sets, the discrete
  factored score of each (kernel K6), the ranked ladder.
  `propose_subsets_lp(candidates, instance_types)` is the reference's entry:
  the encoder, then this.
* `propose_problem_global`: the same with the pending pods as extra classes,
  the empty-set base row, eighths prefixes, and ranking by improvement over
  the base.
* `propose_problem_anneal`: the annealed subset search (kernel K7) over the
  dense compatibility matrix. `propose_subsets(candidates,
  instance_types)` is the reference's entry: the encoder, then this.

Without explicit inits (or streams) each draws the reference's own for its
seed (`utils.prng`, bit for bit `jax.random`'s). Every proposal is a
candidate subset only: exact validation stays with the caller.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..device import resolve_device
from ..models.consolidation_model import ConsolidationTensors, anneal, anneal_chains, lp_repack, score_subsets
from ..models.globalpack import (
    PENDING_WEIGHT,
    draw_gp_inits,
    global_repack,
    rank_ladder,
    score_subsets_global,
)
from ..scheduling.requirements import Requirements
from ..utils import resources as res
from .encode import _scale, pod_signature_cached

# LP solve shape: independent random inits x projected-gradient iterations
LP_INITS = 8
LP_ITERS = 300
# Adam steps per LP round, counted by karpenter_solver_consolidation_lp_iterations_total
LP_SOLVE_ITERATIONS = LP_INITS * LP_ITERS
# fractional-deletion cutoffs the host rounds at, per init
ROUND_THRESHOLDS = (0.9, 0.7, 0.5, 0.3)
ANNEAL_CHAINS = 64
ANNEAL_STEPS = 512


@dataclass
class ConsolidationProblem:
    """The consolidation encoder's output (`_candidate_vectors`): N candidate
    nodes, R resources, L label sets, Q classes, T replacement rows."""

    node_price: np.ndarray  # [N] f32
    node_cost: np.ndarray  # [N] f32
    node_slack: np.ndarray  # [N, R] f32
    node_used: np.ndarray  # [N, R] f32
    node_npods: np.ndarray  # [N] f32
    class_of_node: np.ndarray  # [N] i64
    label_of_node: np.ndarray  # [N] i64
    compat_lq: np.ndarray  # [L, Q] f32 0/1: label set l satisfies class q
    rows_alloc: np.ndarray  # [T, R] f32
    rows_price: np.ndarray  # [T] f32
    pend_mass: np.ndarray  # [Q, R] f32 unconditional (pending) class mass
    pend_active: np.ndarray  # [Q] f32 1 on pending classes
    pend_req: np.ndarray  # [R] f32
    n_classes: int
    pend_npods: float

    @property
    def n(self) -> int:
        return int(self.node_price.shape[0])

    @classmethod
    def from_reference(cls, v: dict) -> ConsolidationProblem:
        """Copy the arrays of a `_candidate_vectors` dict."""
        kw = {}
        for f in fields(cls):
            if f.name == "n_classes":
                kw[f.name] = int(v[f.name])
            elif f.name == "pend_npods":
                kw[f.name] = float(v[f.name])
            else:
                kw[f.name] = np.array(v[f.name])
        return cls(**kw)

    def arrays(self) -> dict:
        """The problem as a flat dict of numpy arrays (the npz layout)."""
        out = {f.name: getattr(self, f.name) for f in fields(self)}
        out["n_classes"] = np.int64(self.n_classes)
        out["pend_npods"] = np.float64(self.pend_npods)
        return out


def _candidate_vectors(candidates, instance_types, pending_pods=None) -> dict:
    """Per-candidate resource vectors + the (label-set, requirement-class)
    grouping that makes compatibility O(L x Q) instead of O(N^2). With
    `pending_pods`, each unique pending-pod signature becomes an EXTRA class
    on the same axis whose mass is unconditional (globalpack's provisioning
    side) instead of gated by a node's fractional deletion."""
    rnames = ["cpu", "memory", "pods", "ephemeral-storage"]
    seen = set(rnames)
    for c in candidates:
        for p in c.reschedulable_pods:
            for k in res.pod_requests(p):
                if k not in seen:
                    seen.add(k)
                    rnames.append(k)  # extended resources (accelerators etc.)
    for p in pending_pods or ():
        for k in res.pod_requests(p):
            if k not in seen:
                seen.add(k)
                rnames.append(k)
    ridx = {k: i for i, k in enumerate(rnames)}
    R = len(rnames)

    def vec(rl):
        v = np.zeros(R, dtype=np.float32)
        for k, q in rl.items():
            i = ridx.get(k)
            if i is not None:
                v[i] = _scale(k, q)
        return v

    N = len(candidates)
    node_price = np.array([c.price for c in candidates], dtype=np.float32)
    node_cost = np.array([c.disruption_cost for c in candidates], dtype=np.float32)
    node_slack = np.zeros((N, R), dtype=np.float32)
    node_used = np.zeros((N, R), dtype=np.float32)
    node_npods = np.zeros(N, dtype=np.float32)
    for i, c in enumerate(candidates):
        sn = c.state_node
        node_slack[i] = vec(res.subtract(sn.allocatable(), sn.total_pod_requests()))
        node_used[i] = vec(res.requests_for_pods(c.reschedulable_pods))
        node_npods[i] = len(c.reschedulable_pods)

    # compatibility classes: a node's displaced pod mass is characterized by
    # the MERGED strict requirements of its reschedulable pods, a pure
    # function of the SET of per-pod requirement contents; host labels group
    # by their item set. One `compatible()` check per unique (label-set,
    # class) pair.
    req_by_content: dict = {}  # per-pod requirement content -> Requirements
    class_key_of_node: list = []
    for c in candidates:
        keys = []
        for p in c.reschedulable_pods:
            k = pod_signature_cached(p)[0]  # the signature's requirements component
            if k not in req_by_content:
                req_by_content[k] = Requirements.from_pod(p, strict=True)
            keys.append(k)
        class_key_of_node.append(frozenset(keys))
    class_ids: dict = {}
    class_of_node = np.zeros(N, dtype=np.int64)
    class_reqs: list = []
    for i, ck in enumerate(class_key_of_node):
        q = class_ids.get(ck)
        if q is None:
            q = len(class_ids)
            class_ids[ck] = q
            merged = Requirements()
            for k in ck:
                merged.add(*req_by_content[k].values())
            class_reqs.append(merged)
        class_of_node[i] = q

    # pending classes: one per unique pod-signature content (a singleton of
    # the same frozenset key space, so a pending class COINCIDING with a
    # single-signature node class shares its routing row)
    pend_class_mass: dict = {}  # class id -> accumulated resource vector
    pend_npods = 0.0
    for p in pending_pods or ():
        k = pod_signature_cached(p)[0]
        if k not in req_by_content:
            req_by_content[k] = Requirements.from_pod(p, strict=True)
        ck = frozenset((k,))
        q = class_ids.get(ck)
        if q is None:
            q = len(class_ids)
            class_ids[ck] = q
            merged = Requirements()
            merged.add(*req_by_content[k].values())
            class_reqs.append(merged)
        acc = pend_class_mass.get(q)
        if acc is None:
            acc = pend_class_mass[q] = np.zeros(R, dtype=np.float32)
        acc += vec(res.pod_requests(p))
        pend_npods += 1.0
    Q = len(class_reqs)
    pend_mass = np.zeros((Q, R), dtype=np.float32)
    pend_active = np.zeros(Q, dtype=np.float32)
    for q, acc in pend_class_mass.items():
        pend_mass[q] = acc
        pend_active[q] = 1.0

    label_ids: dict = {}
    label_of_node = np.zeros(N, dtype=np.int64)
    label_reqs: list = []
    for j, c in enumerate(candidates):
        lbls = c.state_node.labels()
        lk = frozenset(lbls.items())
        li = label_ids.get(lk)
        if li is None:
            li = len(label_ids)
            label_ids[lk] = li
            label_reqs.append(Requirements.from_labels(lbls))
        label_of_node[j] = li
    L = len(label_reqs)
    compat_lq = np.zeros((L, Q), dtype=np.float32)
    for li in range(L):
        for q in range(Q):
            compat_lq[li, q] = 1.0 if label_reqs[li].compatible(class_reqs[q]) is None else 0.0

    rows_alloc, rows_price = [], []
    for it in instance_types:
        # per-offering overrides give a replacement row its own allocatable,
        # as on the provisioning path (types.go AllocatableOfferings)
        for galloc, goffs in it.allocatable_offerings_list():
            alloc = vec(galloc)
            for o in goffs:
                rows_alloc.append(alloc)
                rows_price.append(o.price)
    if not rows_alloc:
        rows_alloc = [np.zeros(R, dtype=np.float32)]
        rows_price = [np.float32(3.4e38)]
    rows_alloc_arr = np.stack(rows_alloc)
    rows_price_arr = np.array(rows_price, dtype=np.float32)

    return dict(
        node_price=node_price,
        node_cost=node_cost,
        node_slack=node_slack,
        node_used=node_used,
        node_npods=node_npods,
        class_of_node=class_of_node,
        label_of_node=label_of_node,
        compat_lq=compat_lq,
        rows_alloc=rows_alloc_arr,
        rows_price=rows_price_arr,
        n_classes=Q,
        pend_mass=pend_mass,
        pend_active=pend_active,
        pend_req=pend_mass.sum(axis=0),
        pend_npods=pend_npods,
    )


def encode_problem(candidates, instance_types, pending_pods=None) -> ConsolidationProblem:
    """The consolidation encoder: candidates (+ pending pods for the global
    mode) and the replacement catalog as a `ConsolidationProblem`."""
    v = _candidate_vectors(candidates, instance_types, pending_pods=pending_pods)
    return ConsolidationProblem(**{f.name: v[f.name] for f in fields(ConsolidationProblem)})


def save_npz(path, problem: ConsolidationProblem, **extra) -> None:
    """Write the problem (and any extra named arrays) to a compressed npz."""
    clash = set(extra) & set(problem.arrays())
    if clash:
        raise ValueError(f"extra arrays collide with problem fields: {sorted(clash)}")
    np.savez_compressed(path, **problem.arrays(), **extra)


def load_npz(path) -> tuple[ConsolidationProblem, dict]:
    """Read a file written by `save_npz`: (problem, extra arrays)."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    problem = ConsolidationProblem.from_reference({f.name: data.pop(f.name) for f in fields(ConsolidationProblem)})
    return problem, data


def reference_inits(problem: ConsolidationProblem, ref: dict):
    """A fixture's stored reference inits at the padded shapes: (d0 [C, Np],
    y0 [C, Qp, Np]). y0 is stored for the real classes and nodes only; the
    projection masks the rest, so any fill does (0.5)."""
    d0 = ref["ref_d0"]
    y0 = np.full((d0.shape[0], bucket_small(problem.n_classes), bucket(problem.n)), 0.5, np.float32)
    y0[:, :problem.n_classes, :problem.n] = ref["ref_y0"]
    return d0, y0


def reference_proposals(ref: dict) -> list[list[int]]:
    """A fixture's stored proposal list (members flat, then one length per
    proposal)."""
    flat, out, at = ref["ref_proposals"].tolist(), [], 0
    for k in ref["ref_proposal_lens"].tolist():
        out.append(flat[at:at + k])
        at += k
    return out


def bucket(n: int) -> int:
    """Node and row axes: the next power of two, at least 16."""
    b = 16
    while b < n:
        b *= 2
    return b


def bucket_small(n: int) -> int:
    """Class axis: the next power of two, at least 4."""
    b = 4
    while b < n:
        b *= 2
    return b


def tensors_from_problem(problem: ConsolidationProblem, device=None, dense_compat: bool = False):
    """The padding half of the reference's `encode_candidates_lp`: (tensors,
    aux) with aux = {onehot [Np, Qp], compat_qn [Qp, Np], compat_nq [Np, Qp],
    n, n_classes, pend_mass [Qp, R], pend_weight [Qp], pend_active [Qp],
    pend_req [R], pend_npods (a float)}. Pad nodes have price 0 and cost 1e6,
    pad rows zero allocatable and price 3.4e38. The dense [Np, Np]
    `pod_compat` (the anneal arm's) is built only with `dense_compat`."""
    dev = resolve_device(device)
    p = problem
    N = p.n
    Np = bucket(N)
    pad = Np - N
    node_price = np.pad(p.node_price, (0, pad))
    node_cost = np.pad(p.node_cost, (0, pad), constant_values=1e6)
    node_slack = np.pad(p.node_slack, ((0, pad), (0, 0)))
    node_used = np.pad(p.node_used, ((0, pad), (0, 0)))
    node_npods = np.pad(p.node_npods, (0, pad))
    T = p.rows_alloc.shape[0]
    Tp = bucket(T)
    rows_alloc = np.pad(p.rows_alloc, ((0, Tp - T), (0, 0)))
    rows_price = np.pad(p.rows_price, (0, Tp - T), constant_values=3.4e38)
    if dense_compat:
        compat = p.compat_lq[np.ix_(p.label_of_node, p.class_of_node)]  # [j host, i deleted]
        np.fill_diagonal(compat, 0.0)  # a deleted node cannot host its own pods
        compat = np.pad(compat, ((0, pad), (0, pad)))
    else:
        compat = np.zeros((1, 1), dtype=np.float32)
    Q = p.n_classes
    Qp = bucket_small(Q)
    onehot = np.zeros((Np, Qp), dtype=np.float32)
    onehot[np.arange(N), p.class_of_node] = 1.0
    compat_nq = np.zeros((Np, Qp), dtype=np.float32)
    compat_nq[:N, :Q] = p.compat_lq[p.label_of_node]
    R = node_used.shape[1]
    pend_mass = np.zeros((Qp, R), dtype=np.float32)
    pend_mass[:Q] = p.pend_mass
    pend_weight = np.ones(Qp, dtype=np.float32)
    pend_weight[:Q] = np.where(p.pend_active > 0, np.float32(PENDING_WEIGHT), np.float32(1.0))
    pend_active = np.zeros(Qp, dtype=np.float32)
    pend_active[:Q] = p.pend_active

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    t = ConsolidationTensors(node_price=up(node_price), node_cost=up(node_cost), node_slack=up(node_slack),
                             node_used=up(node_used), node_npods=up(node_npods), pod_compat=up(compat),
                             row_alloc=up(rows_alloc), row_price=up(rows_price))
    aux = dict(onehot=up(onehot), compat_qn=up(compat_nq.T), compat_nq=up(compat_nq), n=N, n_classes=Q,
               pend_mass=up(pend_mass), pend_weight=up(pend_weight), pend_active=up(pend_active),
               pend_req=up(p.pend_req), pend_npods=float(np.float32(p.pend_npods)))
    return t, aux


def encode_candidates_lp(candidates, instance_types, dense_compat: bool = False, pending_pods=None, device=None):
    """The reference's `encode_candidates_lp`: (tensors, aux) of the
    candidates on the device (see `tensors_from_problem`)."""
    return tensors_from_problem(encode_problem(candidates, instance_types, pending_pods), device, dense_compat)


def encode_candidates(candidates, instance_types, device=None) -> ConsolidationTensors:
    """The tensors with the dense [Np, Np] compatibility matrix the anneal
    arm reads."""
    return encode_candidates_lp(candidates, instance_types, dense_compat=True, device=device)[0]


def deletion_orders(d: np.ndarray, n: int) -> list[np.ndarray]:
    """Each init's deletion order: `np.argsort(-dc)` of its fractional
    deletions with the pad columns zeroed (ties in argsort's own order)."""
    N = d.shape[1]
    return [np.argsort(-np.where(np.arange(N) < n, d[c], 0.0)) for c in range(d.shape[0])]


def member_key(mask: np.ndarray, n: int) -> bytes | None:
    """The real-candidate member set of a delete-set row as a hashable key
    (None when it is empty)."""
    real = mask[:n]
    return np.packbits(real).tobytes() if real.any() else None


def round_fractional(d: np.ndarray, n: int, orders: list[np.ndarray] | None = None) -> list[np.ndarray]:
    """Fractional deletions [C, Np] -> deduped boolean delete-set rows:
    threshold cuts plus top-k prefixes along each init's deletion order
    (the reference's `_round_fractional`; the prefixes follow
    `deletion_orders`, ties included). Pad columns stay False."""
    N = d.shape[1]
    orders = deletion_orders(d, n) if orders is None else orders
    rows: list[np.ndarray] = []
    seen: set[bytes] = set()

    def add(mask: np.ndarray) -> None:
        key = member_key(mask, n)
        if key is not None and key not in seen:
            seen.add(key)
            m = np.zeros(N, dtype=bool)
            m[:n] = mask[:n]
            rows.append(m)

    for c in range(d.shape[0]):
        dc = np.where(np.arange(N) < n, d[c], 0.0)
        for tau in ROUND_THRESHOLDS:
            add(dc > tau)
        for k in {2, max(2, n // 4), max(2, n // 2), n}:
            m = np.zeros(N, dtype=bool)
            m[orders[c][:k]] = True
            add(m)
    return rows


class Stages:
    """Spans on a solve trace (`obs.trace.SolveTrace`); with `sync` the
    device (when it is a CUDA device) is synchronised at both edges of each,
    so a span times the device work it launched. A no-op when `trace` is
    None."""

    def __init__(self, trace, device: torch.device | None, sync: bool = False):
        self.trace, self.device, self.sync = trace, device, sync

    @contextmanager
    def __call__(self, name: str, **attrs):
        if self.trace is None:
            yield None
            return
        if self.sync:
            self._sync()
        with self.trace.span(name, **attrs) as sp:
            yield sp
            if self.sync:
                self._sync()

    def note(self, **kv) -> None:
        if self.trace is not None:
            self.trace.note(**kv)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _gp_inits(aux: dict, inits, seed: int, device):
    """Explicit (d0 [C, Np], y0 [C, Qp, Np]) moved to the device, or the
    reference's draws for `seed`."""
    if inits is not None:
        d0, y0 = inits
        return (torch.as_tensor(d0, dtype=torch.float32).to(device).contiguous(),
                torch.as_tensor(y0, dtype=torch.float32).to(device).contiguous())
    Np, Qp = aux["onehot"].shape
    return draw_gp_inits(LP_INITS, Np, Qp, seed, device)


def propose_subsets_lp(candidates, instance_types, seed: int = 0, max_proposals: int = 8, device=None,
                       trace=None, sync: bool = False) -> list[list[int]]:
    """The reference's LP proposer: encode the candidates, then
    `propose_problem_lp`. Returns candidate index subsets best-first. The
    reference's spans (`encode_candidates`, `lp_repack`, `round`) land on
    `trace` when one is passed, each with the port's finer stages inside;
    `sync` synchronises the device at every span edge."""
    if len(candidates) < 2:
        return []
    dev = resolve_device(device)
    with Stages(trace, dev, sync)("encode_candidates", n_candidates=len(candidates)):
        problem = encode_problem(candidates, instance_types)
    return propose_problem_lp(problem, dev, seed=seed, max_proposals=max_proposals, trace=trace, sync=sync)


def propose_problem_lp(problem: ConsolidationProblem, device=None, *, inits=None, seed: int = 0,
                       max_proposals: int = 8, trace=None, sync: bool = False) -> list[list[int]]:
    """The relaxed-LP proposer on an encoded problem: tensors, relaxed
    repack (K5), rounding, the discrete score of each rounded row (K6), the
    ladder. Returns candidate index subsets best-first, plus the full set
    when any proposal exists. Spans `lp_repack` (stages "tensors" and "K5
    globalpack") and `round` (`lp_ladder`'s) land on `trace`."""
    dev = resolve_device(device)
    n = problem.n
    if n < 2:
        return []
    stage = Stages(trace, dev, sync)
    with stage("lp_repack"):
        with stage("tensors"):
            t, aux = tensors_from_problem(problem, dev)
            d0, y0 = _gp_inits(aux, inits, seed, dev)
        with stage("K5 globalpack"):
            d, _scores = lp_repack(t, aux["onehot"], aux["compat_qn"], d0, y0, n_iters=LP_ITERS)
            d = d.cpu().numpy()  # solverlint: ok(host-sync-in-hot-path): K5's one deliberate download — the rounding ladder runs on host numpy
    return lp_ladder(t, aux, d, n, max_proposals, stage)[0]


def lp_ladder(t, aux: dict, d: np.ndarray, n: int, max_proposals: int = 8, stage=None):
    """The LP proposer from the fractional deletions d [C, Np] on, inside
    the `round` span: rounding, the discrete scores (K6), the ladder.
    Returns (proposals, X, scores, feasible); X is None when no row was
    rounded."""
    stage = stage or Stages(None, aux["onehot"].device)
    with stage("round"):
        with stage("rounding"):
            rows = round_fractional(d, n)
        if not rows:
            return [], None, None, None
        X = np.stack(rows)
        scores, feas = score_subsets(t, aux["onehot"], aux["compat_nq"], X, stage)
        with stage("ladder"):
            ladder, _ = rank_ladder(scores, feas, X, n, max_proposals)
            out = [s for s, _sc in ladder]
            full = list(range(n))
            if out and full not in out:
                out.append(full)
        stage.note(lp_proposals=len(out), lp_rounded=len(rows), ladder_scores=[round(sc, 3) for _s, sc in ladder])
    return out, X, scores, feas


def propose_subsets_global(candidates, instance_types, pending_pods=None, seed: int = 0, max_proposals: int = 8,
                           device=None, trace=None, sync: bool = False):
    """The reference's GLOBAL repack proposer (reference
    solver/consolidation.py:446): encode the candidates with the pending
    pods as unconditional class mass, then `propose_problem_global`. Returns
    (subsets best-first, info = {objective_improvement, rounded}). The
    reference's spans (`encode_candidates`, `globalpack`, `round`) and its
    notes land on `trace`; `sync` synchronises the device at every span
    edge."""
    info = dict(objective_improvement=0.0, rounded=0)
    if len(candidates) < 2:
        return [], info
    dev = resolve_device(device)
    stage = Stages(trace, dev, sync)
    with stage("encode_candidates", n_candidates=len(candidates), n_pending=len(pending_pods or ())):
        problem = encode_problem(candidates, instance_types, pending_pods=pending_pods)
    return propose_problem_global(problem, dev, seed=seed, max_proposals=max_proposals, trace=trace, sync=sync)


def propose_problem_global(problem: ConsolidationProblem, device=None, *, inits=None, seed: int = 0,
                           max_proposals: int = 8, trace=None, sync: bool = False):
    """The global repack proposer: the pending classes' mass is in the
    problem, row 0 is the empty delete-set (the base), the prefixes are
    densified to eighths, and rows rank by improvement over the base.
    Returns (subsets best-first, info) with info = {objective_improvement,
    rounded}. The reference's spans (`globalpack`, `round`) land on
    `trace`."""
    dev = resolve_device(device)
    n = problem.n
    if n < 2:
        return [], dict(objective_improvement=0.0, rounded=0)
    stage = Stages(trace, dev, sync)
    with stage("globalpack"):
        with stage("tensors"):
            t, aux = tensors_from_problem(problem, dev)
            d0, y0 = _gp_inits(aux, inits, seed, dev)
        with stage("K5 globalpack"):
            d, _scores = global_repack(t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0,
                                       y0, n_iters=LP_ITERS)
            d = d.cpu().numpy()  # solverlint: ok(host-sync-in-hot-path): K5's one deliberate download — the rounding ladder runs on host numpy
    with stage("round"):
        return global_ladder(t, aux, d, n, max_proposals, stage)[:2]


def global_ladder(t, aux: dict, d: np.ndarray, n: int, max_proposals: int = 8, stage=None):
    """The global proposer from d [C, Np] on: the empty-set base row, the
    rounding densified to eighths, the discrete scores (K6), the ladder
    ranked by improvement over the base. Returns (proposals, info, X,
    scores, feasible)."""
    stage = stage or Stages(None, aux["onehot"].device)
    info = dict(objective_improvement=0.0, rounded=0)
    with stage("rounding"):
        N = d.shape[1]
        orders = deletion_orders(d, n)
        rows = [np.zeros(N, dtype=bool)] + round_fractional(d, n, orders)  # row 0: the empty-set base
        # the winner is often a mid-size prefix the quarter ladder skips
        seen_rows = {member_key(r, n) for r in rows}
        for c in range(d.shape[0]):
            for k in sorted({max(2, (n * f) // 8) for f in range(1, 9)}):
                mrow = np.zeros(N, dtype=bool)
                mrow[orders[c][:k]] = True  # pad columns stay set, as in the reference
                key = member_key(mrow, n)
                if key is not None and key not in seen_rows:
                    seen_rows.add(key)
                    rows.append(mrow)
        X = np.stack(rows)
    scores, feas = score_subsets_global(t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"],
                                        aux["pend_active"], X, stage)
    with stage("ladder"):
        base = scores[0]
        ladder, best = rank_ladder(scores, feas, X, n, max_proposals, floor=float(base), skip_rows=frozenset((0,)))
        out = [s for s, _sc in ladder]
        full = list(range(n))
        if out and full not in out:
            out.append(full)
        if best > base:
            # an infeasible (-BIG) base: report the winner's absolute score
            info["objective_improvement"] = float(best - base) if base > -1e37 else float(best)
        info["rounded"] = len(rows) - 1
        stage.note(globalpack_proposals=len(out), globalpack_rounded=len(rows) - 1,
                   ladder_scores=[round(sc, 3) for _s, sc in ladder])
    return out, info, X, scores, feas


def propose_subsets(candidates, instance_types, seed: int = 0, max_proposals: int = 8,
                    device=None) -> list[list[int]]:
    """The reference's annealed proposer (reference solver/consolidation.py
    :321, the `KARPENTER_CONSOLIDATE_LP=anneal` arm): encode the candidates,
    then `propose_problem_anneal` with the reference's draws for `seed` (K7's
    pre-pass and chains, one launch each). Returns candidate index subsets
    best-first, plus the full set when any proposal exists."""
    if len(candidates) < 2:
        return []
    problem = encode_problem(candidates, instance_types)
    return propose_problem_anneal(problem, device, seed=seed, max_proposals=max_proposals)


def propose_problem_anneal(problem: ConsolidationProblem, device=None, *, streams=None, seed: int = 0,
                           max_proposals: int = 8, trace=None, sync: bool = False):
    """The annealed subset search (K7) over the dense compatibility matrix:
    64 chains x 512 flips from `streams` = (x0 [C, Np] bool, flips [C, S]
    int32, u [C, S] f32) or the reference's draws for `seed`. Returns
    subsets best-first, plus the full set when any proposal exists."""
    dev = resolve_device(device)
    n = problem.n
    if n < 2:
        return []
    stage = Stages(trace, dev, sync)
    with stage("tensors"):
        t, _aux = tensors_from_problem(problem, dev, dense_compat=True)
        if streams is not None:
            streams = [torch.as_tensor(a).to(dev).contiguous() for a in streams]
    with stage("K7 anneal"):
        if streams is not None:
            best_x, best_s = anneal_chains(t, *streams)
        else:
            best_x, best_s = anneal(t, seed, ANNEAL_CHAINS, ANNEAL_STEPS)
        # K7's deliberate downloads — the ladder ranks the chains on host numpy
        best_x = best_x.cpu().numpy()  # solverlint: ok(host-sync-in-hot-path): K7's chains, downloaded once for the host ladder
        best_s = best_s.cpu().numpy()  # solverlint: ok(host-sync-in-hot-path): K7's scores, downloaded once for the host ladder
    with stage("ladder"):
        order = np.argsort(-best_s)
        seen = set()
        out: list[list[int]] = []
        for idx in order:
            if best_s[idx] <= 0:
                continue
            subset = tuple(i for i in np.nonzero(best_x[idx])[0].tolist() if i < n)  # solverlint: ok(host-sync-in-hot-path): best_x is the host numpy copy made above; this is numpy's tolist
            if not subset or subset in seen:
                continue
            seen.add(subset)
            out.append(list(subset))
            if len(out) >= max_proposals:
                break
        full = tuple(range(n))
        if out and full not in seen:
            out.append(list(full))
    return out
