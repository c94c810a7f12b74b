"""detcheck: the runtime arm of the determinism check.

The repo's contract is BIT-IDENTICAL placement: two solves over the same
inputs must agree digest-for-digest — across the delta/full seam and across
replays of a recorded sequence. This module checks it at runtime:

- under ``KARPENTER_SOLVER_DETCHECK=1`` every `GPUSolver.solve` records a
  replayable dump of its input snapshot plus the node-name-free digest of
  its placement (`results_digest`);
- `GPUSolver.check_determinism()` re-executes the recorded solve SEQUENCE
  in a child process, on the parent solver's device, under a PERTURBED
  ``PYTHONHASHSEED`` with every dict and set in the rebuilt inputs
  adversarially re-inserted in reversed order (`perturb`) — the same
  problem, a hostile iteration order — and compares the digest lists. Any
  divergence raises `DetCheckError` naming the solve and the parent/child
  modes. A child on the CUDA device loads the kernel library the parent
  already built (`kernels/build.py` keys it by the sources' hash);
- pod object IDENTITY is preserved across the replayed sequence (the delta
  encoder's two-pointer walk is an `is` walk), so the child genuinely
  exercises the warm delta / hybrid-delta carries, not a full re-solve per
  step.

With the env var off, `detcheck_enabled()` is one cached-bool read on the
solve path. Perturbation only touches orders the contract declares
meaningless: dict insertion order and set iteration order. Lists and tuples
are ORDERED inputs and replay verbatim.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ENABLED: bool | None = None

# stdout marker line the parent parses out of the child replay
_MARKER = "KARPENTER-DETCHECK-RESULT "

# recorded solves kept per solver; beyond this the OLDEST drop (the child's
# first replayed solve then runs cold, which the bit-identical delta/full
# contract makes digest-equivalent)
_LOG_MAX = 128

# child-side store rebuild order: owners before dependents so the informers
# observe Pod bindings against already-known Nodes/NodeClaims
_KIND_ORDER = {"NodePool": 0, "NodeClaim": 1, "Node": 2, "Pod": 3}


def detcheck_enabled() -> bool:
    """Cached read of KARPENTER_SOLVER_DETCHECK (call `_refresh()` after
    changing the env var mid-process, e.g. in tests)."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("KARPENTER_SOLVER_DETCHECK", "").strip().lower() in ("1", "true", "on")
    return _ENABLED


def _refresh() -> None:
    global _ENABLED
    _ENABLED = None


class DetCheckError(AssertionError):
    """A determinism-contract violation: the dual run produced a different
    placement digest, or the sanitizer could not complete the replay."""


# -- adversarial input perturbation -------------------------------------------

_ATOMIC = (str, bytes, bytearray, int, float, bool, complex, type(None))


def perturb(obj, _memo: dict | None = None):
    """Rebuild `obj`'s object graph with every dict and set re-inserted in
    REVERSED iteration order — the same content under the most hostile
    insertion order the contract permits. Identity-preserving (shared
    references stay shared, via an id memo) and order-preserving for lists
    and tuples, which are meaningful sequences. Objects carrying a plain
    ``__dict__`` are perturbed in place (attribute dict rotated); anything
    else (arrays, locks, slotted objects) passes through untouched."""
    memo = _memo if _memo is not None else {}
    if isinstance(obj, _ATOMIC):
        return obj
    oid = id(obj)
    if oid in memo:
        return memo[oid]
    if isinstance(obj, dict):
        out: dict = {}
        memo[oid] = out
        for k in reversed(list(obj.keys())):
            out[perturb(k, memo)] = perturb(obj[k], memo)
        return out
    if isinstance(obj, (set, frozenset)):
        items = [perturb(v, memo) for v in reversed(list(obj))]
        out = frozenset(items) if isinstance(obj, frozenset) else set(items)
        memo[oid] = out
        return out
    if isinstance(obj, list):
        out = []
        memo[oid] = out
        out.extend(perturb(v, memo) for v in obj)
        return out
    if isinstance(obj, tuple):
        out = tuple(perturb(v, memo) for v in obj)
        memo[oid] = out
        return out
    d = getattr(obj, "__dict__", None)
    if type(d) is dict:
        # in place: the object keeps its identity; its attribute dict is
        # re-inserted reversed, and every attribute value recurses
        memo[oid] = obj
        for k in reversed(list(d.keys())):
            v = d.pop(k)
            d[k] = perturb(v, memo)
        return obj
    memo[oid] = obj
    return obj


# -- digests ------------------------------------------------------------------


def results_digest(results) -> str:
    """Node-name-free content digest of a solve's placement structure:
    new claims as (nodepool, sorted instance-type options, sorted pod keys),
    existing-node assignments as (node name, sorted pod keys), and the pod
    errors. Random claim-name suffixes never enter, so two replays of the
    same inputs digest identically iff their placements match — comparable
    ACROSS processes, and across the port and the JAX solver."""
    claims = sorted(
        [
            nc.nodepool_name,
            sorted(it.name for it in nc.instance_type_options),
            sorted(p.key() for p in nc.pods),
        ]
        for nc in results.new_node_claims
    )
    existing = sorted([n.name(), sorted(p.key() for p in n.pods)] for n in results.existing_nodes if n.pods)
    errors = sorted([k, str(v)] for k, v in results.pod_errors.items())
    payload = {"claims": claims, "existing": existing, "errors": errors, "timed_out": bool(results.timed_out)}
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()


# -- snapshot dump / rebuild --------------------------------------------------


def plan_digest(subsets) -> str:
    """Digest of a global-repack proposal list (`global_repack_plan`'s
    subsets, best-first): candidate-index lists in rank order."""
    return hashlib.sha256(json.dumps([list(map(int, s)) for s in subsets]).encode()).hexdigest()


def dump_snapshot(snap, token_of) -> bytes:
    """Serialize everything a child process needs to re-run this solve from
    scratch. `token_of(obj)` maps pods AND instance types to stable
    identity tokens (see `_SolveLog`): the delta encoder's two-pointer walk
    compares pod IDENTITY, and the row cache key carries `id(instance_type)`
    and the cluster's epoch — so the replay must be told which objects of
    consecutive snapshots were the same parent-side. Tokened objects are
    pickled individually; the child reuses its previous unpickle for a
    token only while the bytes still match, mirroring in-place mutation
    parent-side. The store content is dumped as one inner blob so the child
    can recognize an unchanged cluster and keep ONE Store/Cluster stack
    (stable epoch) across the replayed sequence."""
    with snap.store._lock:
        kinds = sorted(snap.store._objects.keys())
    payload = {
        # store.list deep-copies on the way out: this is a point-in-time dump
        "store_blob": pickle.dumps({k: snap.store.list(k) for k in kinds}),
        "clock": float(snap.clock.now()),
        "pods": [(token_of(p), pickle.dumps(p)) for p in snap.pods],
        "node_pools": snap.node_pools,
        "instance_types": {
            name: [(token_of(it), pickle.dumps(it)) for it in its]
            for name, its in snap.instance_types.items()
        },
        "state_node_names": [sn.name() for sn in snap.state_nodes],
        "daemonset_pods": snap.daemonset_pods,
        "deleting_node_names": sorted(snap.deleting_node_names),
        "flags": {
            "preference_policy": snap.preference_policy,
            "min_values_policy": snap.min_values_policy,
            "enforce_consolidate_after": snap.enforce_consolidate_after,
            "dra_enabled": snap.dra_enabled,
            "reserved_capacity_enabled": snap.reserved_capacity_enabled,
            "reserved_offering_mode": snap.reserved_offering_mode,
            "collect_zone_metrics": snap.collect_zone_metrics,
        },
    }
    return pickle.dumps(payload)


def _linked(token: int, blob: bytes, seen: dict):
    """Token-stable unpickle: the first sighting of a token unpickles (and
    perturbs) fresh; later sightings keep that object's IDENTITY. When the
    bytes changed, the parent mutated the same object in place between
    solves — mirror that by overwriting the retained object's ``__dict__``
    from the fresh unpickle instead of swapping objects."""
    prev = seen.get(token)
    if prev is None:
        obj = perturb(pickle.loads(blob))
        seen[token] = [blob, obj]
        return obj
    if prev[0] != blob:
        fresh = perturb(pickle.loads(blob))
        d = getattr(prev[1], "__dict__", None)
        if type(fresh) is type(prev[1]) and type(d) is dict and type(getattr(fresh, "__dict__", None)) is dict:
            d.clear()
            d.update(fresh.__dict__)
        else:  # slotted or retyped: identity cannot be kept, content wins
            prev[1] = fresh
        prev[0] = blob
    return prev[1]


def _reintern_stamps(pods) -> None:
    """A pod dumped after an encode carries the encoder's signature stamp,
    whose signature must be the interned instance: the encoder groups pods
    by the signature object's identity. Unpickled, each pod holds its own
    copy, so the replay would give every pod a signature of its own and
    pack them differently. Intern them in this process (the reference's
    detcheck does not, and reports such a replay as a divergence)."""
    from ..solver.encode import _intern_sig

    for pod in pods:
        st = getattr(pod, "_sig_stamp", None)
        if st is not None:
            st.sig = _intern_sig(st.sig)


def load_snapshot(blob: bytes, seen: dict, ctx: dict):
    """Child-side rebuild: a Store/Cluster/informer stack replayed from the
    dump, every rebuilt input perturbed (`perturb`) on the way in. `seen`
    carries token -> (bytes, object) for pods and instance types across the
    replayed sequence, and `ctx` carries the previous solve's rebuilt
    store/cluster — reused while the store content blob is unchanged, so
    the row cache key's cluster epoch stays stable and the warm delta /
    hybrid-delta carries genuinely replay."""
    from ..kube.store import Store
    from ..solver.snapshot import SolverSnapshot
    from ..state.cluster import Cluster
    from ..state.informer import start_informers
    from ..utils.clock import FakeClock

    data = pickle.loads(blob)
    if ctx.get("store_blob") == data["store_blob"]:
        store, cluster, clock = ctx["store"], ctx["cluster"], ctx["clock"]
        drift = data["clock"] - clock.now()
        if drift:
            clock.step(drift)
    else:
        store = Store()
        clock = FakeClock(start=data["clock"])
        cluster = Cluster(store, clock)
        start_informers(store, cluster)
        content = pickle.loads(data["store_blob"])
        for kind in sorted(content, key=lambda k: (_KIND_ORDER.get(k, 99), k)):
            for obj in perturb(content[kind]):
                store.create(obj, adopt=True)
        ctx.update(store_blob=data["store_blob"], store=store, cluster=cluster, clock=clock)
    pods = [_linked(token, pod_blob, seen) for token, pod_blob in data["pods"]]
    _reintern_stamps(pods)
    instance_types = {
        name: [_linked(token, it_blob, seen) for token, it_blob in entries]
        for name, entries in data["instance_types"].items()
    }
    # the SNAPSHOT's node selection in its recorded order (disruption sims
    # filter candidates out of state_nodes without touching the cluster)
    by_name = {sn.name(): sn for sn in cluster.nodes()}
    state_nodes = [by_name[n] for n in data["state_node_names"] if n in by_name]
    return SolverSnapshot(
        store=store,
        cluster=cluster,
        node_pools=perturb(data["node_pools"]),
        instance_types=instance_types,
        state_nodes=state_nodes,
        daemonset_pods=perturb(data["daemonset_pods"]),
        pods=pods,
        clock=clock,
        deleting_node_names=perturb(set(data["deleting_node_names"])),
        **data["flags"],
    )


# -- parent-side recording ----------------------------------------------------


class _SolveLog:
    """Per-solver recording state, attached lazily by `record_solve`. Pins a
    reference to every tokened pod so CPython can never reuse an id while
    the log is live (the token IS the identity record)."""

    def __init__(self):
        self.entries: list[dict] = []
        self.dropped = 0
        self._tokens: dict[int, int] = {}
        self._pins: list = []

    def token_of(self, pod) -> int:
        tok = self._tokens.get(id(pod))
        if tok is None:
            tok = len(self._pins)
            self._tokens[id(pod)] = tok
            self._pins.append(pod)
        return tok

    def append(self, entry: dict) -> None:
        self.entries.append(entry)
        if len(self.entries) > _LOG_MAX:
            del self.entries[0]
            self.dropped += 1


def solve_log(solver) -> _SolveLog:
    log = getattr(solver, "_detcheck_log", None)
    if log is None:
        log = solver._detcheck_log = _SolveLog()
    return log


def record_solve(solver, blob: bytes, results) -> None:
    """Append one recorded solve (input dump + placement digest + mode)."""
    solve_log(solver).append(
        {"payload": blob, "digest": results_digest(results), "mode": solver.last_solve_mode}
    )


def _perturbed_hash_seed() -> str:
    """A hash seed guaranteed to differ from this process's: PYTHONHASHSEED
    unset/random means any fixed seed differs with overwhelming odds; a
    pinned parent seed gets seed+1."""
    cur = os.environ.get("PYTHONHASHSEED", "")
    if cur.isdigit():
        return str((int(cur) + 1) % 4294967295 or 1)
    return "4242"


def run_dual(solver, timeout: float = 600.0, clear: bool = True) -> dict:
    """The dual-run check: replay this solver's recorded solve sequence in a
    subprocess under a perturbed hash seed + adversarially reordered inputs
    and compare placement digests. Raises `DetCheckError` on any divergence;
    returns a summary dict on success (and clears the log by default so
    repeated checks don't re-verify old solves)."""
    if not detcheck_enabled():
        raise DetCheckError("KARPENTER_SOLVER_DETCHECK is not enabled — no solves were recorded")
    log = getattr(solver, "_detcheck_log", None)
    if log is None or not log.entries:
        raise DetCheckError("no recorded solves to check — run solve() with KARPENTER_SOLVER_DETCHECK=1 first")
    job = {
        # the child replays on the parent's device
        "solver": {"device": str(solver.device), "force": solver.force, "recover": solver.recover},
        "solves": [e["payload"] for e in log.entries],
    }
    env = dict(os.environ)
    # the child computes digests directly — recording there would only
    # recurse on a nested check_determinism
    env.pop("KARPENTER_SOLVER_DETCHECK", None)
    env["PYTHONHASHSEED"] = _perturbed_hash_seed()
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = root + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else root
    fd, jobfile = tempfile.mkstemp(prefix="detcheck-", suffix=".job")
    try:
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(job, fh)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "karpenter_tpu_torch.obs.detcheck", jobfile],
            env=env,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
        child_seconds = time.perf_counter() - t0
    finally:
        try:
            os.unlink(jobfile)
        except OSError:
            pass
    marker = next((ln for ln in proc.stdout.splitlines() if ln.startswith(_MARKER)), None)
    if proc.returncode != 0 or marker is None:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-12:]
        raise DetCheckError(
            "detcheck replay child failed (exit %s) under PYTHONHASHSEED=%s:\n%s"
            % (proc.returncode, env["PYTHONHASHSEED"], "\n".join(tail))
        )
    child = json.loads(marker[len(_MARKER):])
    parent_digests = [e["digest"] for e in log.entries]
    parent_modes = [e["mode"] for e in log.entries]
    if len(child["digests"]) != len(parent_digests):
        raise DetCheckError(
            f"replay produced {len(child['digests'])} digests for {len(parent_digests)} recorded solves"
        )
    bad = [i for i, (a, b) in enumerate(zip(parent_digests, child["digests"])) if a != b]
    if bad:
        detail = "; ".join(
            f"solve #{i} (parent mode={parent_modes[i]!r}, child mode={child['modes'][i]!r}): "
            f"{parent_digests[i][:12]} != {child['digests'][i][:12]}"
            for i in bad
        )
        raise DetCheckError(
            f"placement digest diverged under perturbed hash seed {env['PYTHONHASHSEED']} "
            f"+ reversed insertion order — the bit-identical-placement contract is broken: {detail}"
        )
    out = {
        "solves": len(parent_digests),
        "digests": parent_digests,
        "parent_modes": parent_modes,
        "child_modes": child["modes"],
        "hash_seed": env["PYTHONHASHSEED"],
        "dropped": log.dropped,
        "device": job["solver"]["device"],
        "child_seconds": child_seconds,
    }
    if clear:
        log.entries.clear()
        log.dropped = 0
    return out


def check_globalpack(solver, candidates, instance_types, pending_pods=None, seed: int = 0) -> dict:
    """In-process dual run of the global-repack proposer: the same plan must
    come back digest-identical when every dict/set in its inputs is
    re-inserted in reversed order. Candidates are live state objects (not
    picklable), so this arm perturbs in place instead of forking."""
    first, _ = solver.global_repack_plan(candidates, instance_types, pending_pods=pending_pods, seed=seed)
    memo: dict = {}
    second, _ = solver.global_repack_plan(
        perturb(candidates, memo),
        perturb(instance_types, memo),
        pending_pods=perturb(pending_pods, memo),
        seed=seed,
    )
    a, b = plan_digest(first), plan_digest(second)
    if a != b:
        raise DetCheckError(
            f"global repack plan diverged under reversed insertion order: {a[:12]} != {b[:12]}"
        )
    return {"proposals": len(first), "digest": a}


# -- the child replay entry point ---------------------------------------------


def _child_main(argv: list[str]) -> int:
    from ..solver.gpu import GPUSolver

    with open(argv[0], "rb") as fh:
        job = pickle.load(fh)
    solver = GPUSolver(**job["solver"])
    seen: dict = {}
    ctx: dict = {}
    digests, modes = [], []
    for blob in job["solves"]:
        snap = load_snapshot(blob, seen, ctx)
        results = solver.solve(snap)
        digests.append(results_digest(results))
        modes.append(solver.last_solve_mode)
    print(_MARKER + json.dumps({"digests": digests, "modes": modes}))
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1:]))
