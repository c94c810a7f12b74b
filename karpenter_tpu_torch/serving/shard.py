"""shardfleet: horizontal multi-process fleet sharding with warm-cache scale-out.

The fleet front-end (serving/fleet.py) multiplexes K tenants in ONE process
and names horizontal sharding as its growth axis: one serve loop is the hard
ceiling on aggregate events/sec, and the bounded tenant-label cap collapses
to "overflow" past TENANT_LABEL_CAP tenants. This module is the tenant →
PROCESS scale-out: a `ShardRouter` spawns N shard worker processes (each
running its own `FleetFrontend` serve loop over a private slice of tenants)
and fronts them as one fleet.

Mechanisms, in dependency order:

- CONSISTENT-HASH PLACEMENT (`ShardRing`): tenant→shard assignment hashes
  both shard vnodes and tenant ids onto one 64-bit ring with
  `hashlib.blake2b` — NEVER the builtin `hash()`, whose per-process
  PYTHONHASHSEED randomization would scatter assignments across router
  restarts. Adding/removing a shard only re-homes the tenants whose ring
  successor changed (the moved fraction is bounded near T/N), and the
  assignment is a pure function of the shard-id set: bit-stable across
  restarts and identical in every process.
- WARM-CACHE SCALE-OUT: every shard worker inherits one shared
  `KARPENTER_SOLVER_COMPILE_CACHE` directory, the kernels' build directory
  (solver.gpu.configure_compile_cache claims it first-writer-wins, and
  kernels.build holds a file lock across each build), so the kernels are
  built once and every later shard loads the built library.
- DEVICE PARTITIONING: the router passes its `device` to every worker
  (`KARPENTER_SOLVER_SHARD_DEVICE`), and each worker gets
  `KARPENTER_SOLVER_SHARD_DEVICES="<index>/<n>"` so
  `parallel.sharded.default_mesh` keeps that shard's contiguous slice of
  the cards. On one card every slice is `cuda:0`, and each worker is its
  own CUDA process. A worker asked for the card that finds none fails; it
  never runs on the CPU instead.
- CROSS-SHARD AGGREGATION: each worker runs a loopback OperatorServer; the
  router scrapes and merges /debug/tenants (rows stamped with their shard),
  proxies /debug/solves + /debug/events by ?tenant= to the owning shard,
  and merges the `karpenter_solver_fleet_*` metric families with an
  injected bounded `shard` label (`shard_label`, the `shard` entry in
  solverlint's bounded_label_producers).
- SHARD FAILURE DOMAINS: a per-shard `CircuitBreaker` (the faultline
  pattern, reused verbatim from serving/faults.py) quarantines a shard
  whose pings/commands fail and exponential-backoff re-probes it. A dead
  shard's tenants RE-HOME: the router replays each tenant's recorded
  ChurnSpec JSONL — filtered to that tenant via
  `ChurnSpec.from_event_log(tenant=...)` — into a surviving (or respawned)
  shard, and the rebuilt placement digests bit-identically to the dead
  shard's last run (`placement_digest`).

Wire protocol: one JSON object per line over the worker's stdin/stdout,
each response line prefixed with "KSHARD " so stray library output can
never corrupt framing. The worker emits a ready line before importing
anything heavy; torch/fleet imports are paid lazily on the first add_tenant.

Threading (racecheck): `ShardRouter._drive_shard` threads fan run_all out
across shards (one writer per results key), `ShardRouter._monitor_loop` is
the optional health prober, and the worker-side `_tick_loop` steps live
tenant environments — all registered in [tool.solverlint] thread-shared.
Locks: `shard-router` and `shard-handle` are LEAF locks (never held across
a solve or another lock); handle I/O serializes per shard under
`shard-handle` so concurrent router calls cannot interleave frames.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import os
import subprocess
import sys
import time

from ..obs.racecheck import make_event, make_lock, spawn_thread
from .faults import TENANT_STATES, CircuitBreaker

_WIRE = "KSHARD "

# distinct shard label values the bounded `shard` metric label may carry
# before collapsing to "overflow" — same contract as fleet.TENANT_LABEL_CAP
# (and the same solverlint max-label-values ceiling backstops both)
SHARD_LABEL_CAP = 12
_SHARD_LABELS: dict[str, str] = {}
_SHARD_LABELS_LOCK = make_lock("shard-labels")


def shard_label(shard_id: str) -> str:
    """The BOUNDED metric label for a shard id: first SHARD_LABEL_CAP
    distinct ids keep their sanitized form, later ones collapse to
    "overflow"; colliding sanitized forms get a numeric disambiguator.
    This is the `shard` entry in solverlint's bounded_label_producers —
    every `shard=` label value on a counter/histogram must come from
    here (or carry a justified pragma)."""
    shard_id = str(shard_id)
    with _SHARD_LABELS_LOCK:
        label = _SHARD_LABELS.get(shard_id)
        if label is not None:
            return label
        if len(_SHARD_LABELS) >= SHARD_LABEL_CAP:
            label = "overflow"
        else:
            base = "".join(c if (c.isalnum() or c in "-_.") else "-" for c in shard_id)[:60] or "default"
            used = set(_SHARD_LABELS.values()) | {"overflow"}
            label, n = base, 2
            while label in used:
                label, n = f"{base}-{n}", n + 1
        _SHARD_LABELS[shard_id] = label
        return label


def reset_shard_labels() -> None:
    """Drop the process-global shard-label assignments (test isolation)."""
    with _SHARD_LABELS_LOCK:
        _SHARD_LABELS.clear()


def placement_digest(env) -> str:
    """Content digest of a tenant's node-name-free placement structure:
    one (instance-type, zone, sorted pod names) triple per node, sorted.
    Random claim-name suffixes never enter, so two independent replays of
    the same log digest identically iff their placements match — the
    bit-identical re-homing check, comparable ACROSS processes."""
    from ..apis import labels as wk

    nodes = {n.metadata.name: n for n in env.store.list("Node")}
    groups: dict[str, list] = {}
    for p in env.store.list("Pod"):
        if p.spec.node_name:
            groups.setdefault(p.spec.node_name, []).append(p.metadata.name)
    shape = []
    for name, pods in groups.items():
        labels = nodes[name].metadata.labels if name in nodes else {}
        shape.append(
            (labels.get(wk.INSTANCE_TYPE_LABEL_KEY) or "", labels.get(wk.ZONE_LABEL_KEY) or "", sorted(pods))
        )
    shape.sort()
    return hashlib.sha256(json.dumps(shape, sort_keys=True).encode()).hexdigest()


class ShardRing:
    """Consistent-hash ring mapping tenant ids onto shard ids. Each shard
    contributes `replicas` vnodes; a tenant is owned by its clockwise
    successor. Points come from blake2b (process/seed-independent — the
    builtin hash() is PYTHONHASHSEED-randomized and would break cross-
    process agreement), so the whole assignment is a pure, bit-stable
    function of the shard-id set. Not itself thread-safe: the router
    mutates it only under the shard-router lock."""

    def __init__(self, shards=(), replicas: int = 64):
        self.replicas = int(replicas)
        self._points: list[tuple[int, str]] = []
        self._shards: set[str] = set()
        for s in shards:
            self.add(s)

    @staticmethod
    def _point(key: str) -> int:
        return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")

    def add(self, shard_id: str) -> None:
        shard_id = str(shard_id)
        if shard_id in self._shards:
            return
        self._shards.add(shard_id)
        for r in range(self.replicas):
            bisect.insort(self._points, (self._point(f"shard:{shard_id}:{r}"), shard_id))

    def remove(self, shard_id: str) -> None:
        shard_id = str(shard_id)
        if shard_id not in self._shards:
            return
        self._shards.discard(shard_id)
        self._points = [p for p in self._points if p[1] != shard_id]

    def shards(self) -> list[str]:
        return sorted(self._shards)

    def assign(self, tenant_id: str) -> str:
        if not self._points:
            raise ValueError("ShardRing has no shards")
        p = self._point(f"tenant:{tenant_id}")
        # (p,) sorts before every (p, shard) pair, so bisect_right lands on
        # the first vnode with point >= p — the clockwise successor
        i = bisect.bisect_right(self._points, (p,))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def assignments(self, tenant_ids) -> dict[str, str]:
        return {t: self.assign(t) for t in tenant_ids}


class ShardDead(RuntimeError):
    """The shard process is gone (EOF/broken pipe/never started)."""


class ShardError(RuntimeError):
    """The shard is alive but the command failed (ok=false response)."""


def _http_get(port: int, path: str, timeout: float = 5.0) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.read().decode()


class ShardHandle:
    """The router's end of one shard worker process: owns the Popen and
    serializes the line protocol. All pipe I/O runs under the handle lock,
    so two router threads calling into the same shard can never interleave
    request/response frames (the readline is plain pipe I/O, not a listed
    blocking call — safe under a leaf lock)."""

    GUARDED_FIELDS = {"_proc": "_lock"}

    def __init__(self, shard_id: str, cmd: list[str], env: dict):
        self.shard_id = shard_id
        self._lock = make_lock("shard-handle")
        with self._lock:
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True, bufsize=1
            )

    @staticmethod
    def _read_msg(proc) -> dict:
        # skip any non-protocol line a library printed to stdout; EOF means
        # the worker died (crash cmd, kill, import failure)
        while True:
            line = proc.stdout.readline()
            if not line:
                raise ShardDead("worker closed its protocol stream")
            if line.startswith(_WIRE):
                return json.loads(line[len(_WIRE):])

    def wait_ready(self) -> dict:
        """Block for the worker's boot banner (emitted before any heavy
        import, so a successful spawn acks fast; a failed interpreter start
        surfaces as EOF→ShardDead rather than a hang)."""
        return self.call("__ready__")

    def call(self, cmd: str, **kw) -> dict:
        with self._lock:
            proc = self._proc
            if proc is None or proc.poll() is not None:
                raise ShardDead(f"shard {self.shard_id} is not running")
            try:
                if cmd != "__ready__":
                    proc.stdin.write(json.dumps({"cmd": cmd, **kw}) + "\n")
                    proc.stdin.flush()
                resp = self._read_msg(proc)
            except (OSError, ValueError) as e:
                raise ShardDead(f"shard {self.shard_id} died mid-call: {e}") from e
        if not resp.get("ok"):
            raise ShardError(f"shard {self.shard_id}: {resp.get('error', 'unknown shard error')}")
        return resp

    def alive(self) -> bool:
        with self._lock:
            return self._proc is not None and self._proc.poll() is None

    def kill(self) -> None:
        """Hard-kill the worker (shard-death injection for tests/bench)."""
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.kill()
        if proc is not None:
            proc.wait(timeout=10)

    def close(self, graceful: bool = True) -> None:
        if graceful and self.alive():
            try:
                self.call("shutdown")
            except (ShardDead, ShardError):
                pass  # already dying — the kill below reaps it either way
        self.kill()


class ShardRouter:
    """The fleet-of-fleets front: spawns N shard worker processes, assigns
    tenants by consistent hashing, shares one persistent compile cache
    across them, aggregates their debug/metric surfaces, and re-homes a
    dead shard's tenants by tenant-filtered log replay (see module doc).
    Deterministic drivers call run_all()/run_tenant(); live deployments
    call start_serving() + start_monitor()."""

    GUARDED_FIELDS = {
        "_handles": "_lock",
        "_ports": "_lock",
        "_indexes": "_lock",
        "_tenants": "_lock",
        "_breakers": "_lock",
        "_monitor_thread": "_lock",
        "_monitor_stop": "_lock",
    }

    def __init__(
        self,
        n_shards: int = 2,
        registry=None,
        cache_dir: str | None = None,
        solver: str = "gpu",
        worker_env: dict | None = None,
        breaker_failures: int = 1,
        breaker_backoff_seconds: float = 0.2,
        breaker_backoff_max: float = 30.0,
        device=None,
    ):
        """`device`: the GPU solver's device in every worker (None: the CUDA
        device, "cuda"; "cpu" runs the plain versions), passed to each
        worker explicitly."""
        from ..metrics import make_registry

        self.n_shards = int(n_shards)
        self.registry = registry if registry is not None else make_registry()
        self.cache_dir = cache_dir
        self.solver = solver
        self.device = "cuda" if device is None else str(device)
        self.worker_env = dict(worker_env or {})
        self.breaker_failures = int(breaker_failures)
        self.breaker_backoff_seconds = float(breaker_backoff_seconds)
        self.breaker_backoff_max = float(breaker_backoff_max)
        self.ring = ShardRing()
        self._lock = make_lock("shard-router")
        self._handles: dict[str, ShardHandle] = {}
        self._ports: dict[str, int] = {}
        self._indexes: dict[str, int] = {}
        # tenant registry: log/overrides/solver for re-homing replay, owning
        # shard, and the last known placement digest
        self._tenants: dict[str, dict] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        self._monitor_thread = None
        self._monitor_stop = None

    # -- shard lifecycle -------------------------------------------------------
    def spawn(self) -> list[str]:
        """Spawn all N shard workers and seat them on the ring."""
        for i in range(self.n_shards):
            self._spawn_shard(f"shard-{i}", i)
        self._publish_topology()
        return self.shards()

    def _spawn_shard(self, shard_id: str, index: int) -> ShardHandle:
        env = dict(os.environ)
        env.update(self.worker_env)
        env["KARPENTER_SOLVER_SHARD_ID"] = shard_id
        # contiguous device slice i of N (parallel.sharded.default_mesh)
        env["KARPENTER_SOLVER_SHARD_DEVICES"] = f"{index}/{self.n_shards}"
        env["KARPENTER_SOLVER_SHARD_DEVICE"] = self.device
        if self.cache_dir:
            env["KARPENTER_SOLVER_COMPILE_CACHE"] = self.cache_dir
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        handle = ShardHandle(shard_id, [sys.executable, "-m", "karpenter_tpu_torch.serving.shard"], env)
        handle.wait_ready()
        breaker = CircuitBreaker(
            failures_to_open=self.breaker_failures,
            backoff_seconds=self.breaker_backoff_seconds,
            backoff_max=self.breaker_backoff_max,
        )
        with self._lock:
            self._handles[shard_id] = handle
            self._indexes[shard_id] = index
            # a respawned shard keeps its breaker history (opens count)
            self._breakers.setdefault(shard_id, breaker)
            self.ring.add(shard_id)
        return handle

    def respawn(self, shard_id: str) -> ShardHandle:
        """Replace a dead shard's process (the breaker's probe path brings
        it back to healthy on the next successful check)."""
        from .. import metrics as m

        with self._lock:
            old = self._handles.pop(shard_id, None)
            self._ports.pop(shard_id, None)
            index = self._indexes.get(shard_id, len(self._indexes))
        if old is not None:
            old.kill()
        handle = self._spawn_shard(shard_id, index)
        self.registry.counter(m.SOLVER_SHARD_RESTARTS_TOTAL).inc(shard=shard_label(shard_id))
        self._publish_topology()
        return handle

    def shards(self) -> list[str]:
        with self._lock:
            return sorted(self._handles)

    def _handle(self, shard_id: str) -> ShardHandle:
        with self._lock:
            handle = self._handles.get(shard_id)
        if handle is None:
            raise ShardDead(f"shard {shard_id} has no process")
        return handle

    def ready(self) -> bool:
        """Router readiness: every seated shard's breaker is healthy and at
        least one shard process is up."""
        with self._lock:
            handles = dict(self._handles)
            breakers = dict(self._breakers)
        if not handles:
            return False
        alive = any(h.alive() for h in handles.values())
        return alive and all(b.state_name() == "healthy" for b in breakers.values())

    # -- tenant placement ------------------------------------------------------
    def assign(self, tenant_id: str) -> str:
        with self._lock:
            return self.ring.assign(tenant_id)

    def add_tenant(self, tenant_id: str, log_path: str | None = None, overrides: dict | None = None, solver: str | None = None) -> str:
        """Seat a tenant on its ring-assigned shard. With `log_path`, the
        shard builds a ChurnHarness replaying that log filtered to this
        tenant (the deterministic drive + re-homing substrate); without it,
        a live wall-clock tenant session."""
        sid = self.assign(tenant_id)
        handle = self._handle(sid)
        resp = handle.call(
            "add_tenant",
            tenant=tenant_id,
            log=log_path,
            overrides=dict(overrides or {}),
            solver=solver or self.solver,
        )
        with self._lock:
            self._tenants[tenant_id] = {
                "log": log_path,
                "overrides": dict(overrides or {}),
                "solver": solver or self.solver,
                "shard": sid,
                "digest": None,
            }
            if resp.get("port"):
                self._ports[sid] = int(resp["port"])
        return sid

    def tenants(self) -> dict[str, str]:
        with self._lock:
            return {t: rec["shard"] for t, rec in self._tenants.items()}

    # -- deterministic drive ---------------------------------------------------
    def run_tenant(self, tenant_id: str) -> dict:
        with self._lock:
            rec = self._tenants.get(tenant_id)
        if rec is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        resp = self._handle(rec["shard"]).call("run_tenant", tenant=tenant_id)
        with self._lock:
            self._tenants[tenant_id]["digest"] = resp.get("digest")
        return resp

    def run_all(self) -> dict[str, dict]:
        """Replay every shard's tenants, all shards IN PARALLEL (each shard
        is its own process — this is the scale-out measurement path).
        Returns {shard_id: run_all response}; failed shards get an
        ok=False row and a breaker failure."""
        with self._lock:
            handles = dict(self._handles)
        results: dict[str, dict] = {}
        threads = [
            spawn_thread(self._drive_shard, name=f"karpenter-shard-drive-{sid}", args=(sid, h, results))
            for sid, h in sorted(handles.items())
        ]
        for t in threads:
            t.join()
        with self._lock:
            for sid, res in results.items():
                if res.get("ok"):
                    for tid, row in (res.get("tenants") or {}).items():
                        if tid in self._tenants:
                            self._tenants[tid]["digest"] = row.get("digest")
        return results

    def _drive_shard(self, sid: str, handle: ShardHandle, results: dict) -> None:
        # one writer per key: this thread exclusively owns results[sid]
        try:
            results[sid] = handle.call("run_all")
        except (ShardDead, ShardError) as e:
            results[sid] = {"ok": False, "error": str(e)}
            self._record_shard_failure(sid, e)

    # -- failure domains -------------------------------------------------------
    def _breaker(self, shard_id: str) -> CircuitBreaker | None:
        with self._lock:
            return self._breakers.get(shard_id)

    def _record_shard_failure(self, shard_id: str, err) -> None:
        breaker = self._breaker(shard_id)
        if breaker is not None:
            breaker.record_failure(err)
            self._publish_shard_states()

    def check_shards(self) -> dict[str, str]:
        """One health pass: ping every shard whose breaker admits traffic;
        failures quarantine the shard (backoff-gated re-probes, exactly the
        per-tenant faultline ladder). Returns {shard_id: breaker state}."""
        with self._lock:
            rows = [(sid, self._handles.get(sid), self._breakers.get(sid)) for sid in sorted(self._breakers)]
        out: dict[str, str] = {}
        for sid, handle, breaker in rows:
            if breaker is None:
                continue
            if not breaker.allow():
                out[sid] = breaker.state_name()
                continue
            try:
                if handle is None:
                    raise ShardDead(f"shard {sid} has no process")
                handle.call("ping")
                breaker.record_success()
            except (ShardDead, ShardError) as e:
                breaker.record_failure(e)
            out[sid] = breaker.state_name()
        self._publish_shard_states()
        return out

    def rehome_tenants(self, shard_id: str, respawn: bool = False) -> dict:
        """Re-home a dead shard's tenants (the shard-death contract): pull
        the shard off the ring (or respawn it fresh), then for each
        orphaned tenant replay its recorded log — filtered to that tenant —
        into its new ring home and check the rebuilt placement digests
        BIT-IDENTICALLY against the dead shard's last run. Returns
        {tenant: {shard, digest, matches}}."""
        from .. import metrics as m

        with self._lock:
            handle = self._handles.pop(shard_id, None)
            self._ports.pop(shard_id, None)
            orphans = [(t, dict(rec)) for t, rec in self._tenants.items() if rec.get("shard") == shard_id]
            if not respawn:
                # decommission: off the ring AND out of the breaker map — a
                # shard that no longer exists must not hold ready() hostage
                self.ring.remove(shard_id)
                self._breakers.pop(shard_id, None)
                self._indexes.pop(shard_id, None)
        if handle is not None:
            handle.close(graceful=False)
        if not respawn:
            # stale-series hygiene (the remove_tenant pattern): zero every
            # state series for the decommissioned shard
            g = self.registry.gauge(m.SOLVER_SHARD_STATE)
            for s in TENANT_STATES:
                g.set(0.0, shard=shard_label(shard_id), state=s)  # solverlint: ok(metric-label-cardinality): state iterates the static TENANT_STATES enum (shard is already the bounded shard_label producer)
        if respawn:
            self.respawn(shard_id)
        self._publish_topology()
        out: dict[str, dict] = {}
        for tid, rec in sorted(orphans):
            new_sid = self.assign(tid)
            new_handle = self._handle(new_sid)
            new_resp = new_handle.call(
                "add_tenant", tenant=tid, log=rec["log"], overrides=rec["overrides"], solver=rec["solver"]
            )
            row: dict = {"shard": new_sid}
            if rec.get("log"):
                replay = new_handle.call("run_tenant", tenant=tid)
                row["digest"] = replay.get("digest")
                row["matches"] = rec.get("digest") is None or rec["digest"] == row["digest"]
            with self._lock:
                self._tenants[tid]["shard"] = new_sid
                if "digest" in row:
                    self._tenants[tid]["digest"] = row["digest"]
                if new_resp.get("port"):
                    self._ports[new_sid] = int(new_resp["port"])
            self.registry.counter(m.SOLVER_SHARD_REHOMED_TOTAL).inc(shard=shard_label(new_sid))
            out[tid] = row
        return out

    # -- aggregation -----------------------------------------------------------
    def _shard_ports(self) -> dict[str, int]:
        with self._lock:
            return {sid: p for sid, p in self._ports.items() if p}

    def debug_tenants(self) -> dict:
        """The merged /debug/tenants payload: every shard's per-tenant
        breaker/backlog rows, each stamped with its shard id; tenants whose
        shard is unreachable still get a row naming the owner."""
        out: dict = {}
        for sid, port in sorted(self._shard_ports().items()):
            try:
                body = json.loads(_http_get(port, "/debug/tenants"))
            except (OSError, ValueError) as e:
                out[f"__shard_{sid}__"] = {"shard": sid, "error": str(e)}
                continue
            for tid, row in (body.get("tenants") or {}).items():
                row["shard"] = sid
                out[tid] = row
        for tid, sid in self.tenants().items():
            out.setdefault(tid, {"shard": sid, "error": "shard unreachable"})
        return out

    def debug_shards(self) -> dict:
        """Per-shard router rows: liveness, breaker snapshot, debug port,
        ring index, and seated tenants."""
        with self._lock:
            sids = sorted(set(self._handles) | set(self._breakers))
            handles = dict(self._handles)
            ports = dict(self._ports)
            indexes = dict(self._indexes)
            breakers = dict(self._breakers)
            owners: dict[str, list] = {}
            for tid, rec in self._tenants.items():
                owners.setdefault(rec["shard"], []).append(tid)
        out: dict = {}
        for sid in sids:
            handle = handles.get(sid)
            row = {
                "index": indexes.get(sid),
                "port": ports.get(sid, 0),
                "alive": handle.alive() if handle is not None else False,
                "tenants": sorted(owners.get(sid, [])),
            }
            breaker = breakers.get(sid)
            if breaker is not None:
                row.update(breaker.snapshot())
            out[sid] = row
        return out

    def _proxy(self, route: str, tenant: str, n=None) -> str:
        """Proxy a per-tenant debug route to the shard that serves it:
        owner-first (by registered tenant id), then fan out — queries
        address tenants by their metric LABEL, which each shard assigns
        locally, so the id→label mapping is only a heuristic."""
        import urllib.parse

        query = f"?tenant={urllib.parse.quote(str(tenant))}"
        if n is not None:
            query += f"&n={int(n)}"
        ports = self._shard_ports()
        owner = self.tenants().get(tenant)
        order = ([owner] if owner in ports else []) + [s for s in sorted(ports) if s != owner]
        last_err: Exception | None = None
        for sid in order:
            try:
                return _http_get(ports[sid], route + query)
            except OSError as e:
                last_err = e
        raise KeyError(f"no shard serves tenant {tenant!r}: {last_err}")

    def debug_solves(self, tenant: str, n=None) -> str:
        return self._proxy("/debug/solves", tenant, n)

    def debug_events(self, tenant: str, n=None) -> str:
        return self._proxy("/debug/events", tenant, n)

    def merged_metrics(self) -> str:
        """The router's /metrics body: its own registry (shard topology,
        restarts, re-homed counts) plus every shard's
        `karpenter_solver_fleet_*` samples with an injected bounded
        `shard` label, HELP/TYPE headers deduplicated across shards."""
        parts = [self.registry.expose()]
        # the router's own registry registers the same metric families every
        # make_registry() build does, so its HELP/TYPE headers seed the dedupe
        seen_meta: set = set()
        for line in parts[0].splitlines():
            if line.startswith("#"):
                toks = line.split()
                if len(toks) >= 3:
                    seen_meta.add((toks[1], toks[2]))
        for sid, port in sorted(self._shard_ports().items()):
            try:
                text = _http_get(port, "/metrics")
            except OSError:
                continue  # a dead shard's series simply drop out of the scrape
            label = shard_label(sid)
            lines = []
            for line in text.splitlines():
                if line.startswith("#"):
                    toks = line.split()
                    if len(toks) >= 3 and toks[2].startswith("karpenter_solver_fleet_"):
                        if (toks[1], toks[2]) not in seen_meta:
                            seen_meta.add((toks[1], toks[2]))
                            lines.append(line)
                    continue
                if not line.startswith("karpenter_solver_fleet_"):
                    continue
                if "{" in line:
                    name, rest = line.split("{", 1)
                    lines.append(f'{name}{{shard="{label}",{rest}')
                else:
                    name, _, val = line.partition(" ")
                    lines.append(f'{name}{{shard="{label}"}} {val}')
            if lines:
                parts.append("\n".join(lines))
        return "\n".join(parts)

    def stats(self) -> dict:
        """Cross-shard stats merge (the deterministic-driver counterpart of
        merged_metrics): {shard: stats response or error row}."""
        out: dict = {}
        for sid in self.shards():
            try:
                out[sid] = self._handle(sid).call("stats")
            except (ShardDead, ShardError) as e:
                out[sid] = {"ok": False, "error": str(e)}
                self._record_shard_failure(sid, e)
        return out

    # -- live serving ----------------------------------------------------------
    def start_serving(self, tick_seconds: float = 0.5) -> None:
        """Start every shard's wall-clock serve loop + env tick thread."""
        for sid in self.shards():
            self._handle(sid).call("start", tick_seconds=tick_seconds)

    def start_monitor(self, interval_seconds: float = 1.0) -> None:
        with self._lock:
            if self._monitor_thread is not None:
                return
            self._monitor_stop = make_event()
            self._monitor_thread = spawn_thread(
                self._monitor_loop,
                name="karpenter-shard-monitor",
                args=(self._monitor_stop, float(interval_seconds)),
            )

    def stop_monitor(self) -> None:
        with self._lock:
            t, self._monitor_thread = self._monitor_thread, None
            stop, self._monitor_stop = self._monitor_stop, None
        if stop is not None:
            stop.set()
        if t is not None:
            t.join(timeout=5)

    def _monitor_loop(self, stop, interval: float) -> None:
        while not stop.wait(timeout=interval):
            self.check_shards()

    def close(self) -> None:
        self.stop_monitor()
        with self._lock:
            handles = dict(self._handles)
            self._handles.clear()
            self._ports.clear()
        for h in handles.values():
            h.close()

    # -- metric publication ----------------------------------------------------
    def _publish_topology(self) -> None:
        from .. import metrics as m

        with self._lock:
            n = len(self._handles)
        self.registry.gauge(m.SOLVER_FLEET_SHARDS).set(n)

    def _publish_shard_states(self) -> None:
        from .. import metrics as m

        with self._lock:
            states = {sid: b.state_name() for sid, b in self._breakers.items()}
        g = self.registry.gauge(m.SOLVER_SHARD_STATE)
        for sid, state in states.items():
            label = shard_label(sid)
            for s in TENANT_STATES:
                g.set(1.0 if s == state else 0.0, shard=label, state=s)  # solverlint: ok(metric-label-cardinality): state iterates the static TENANT_STATES enum; shard label is a shard_label() output


# -- the shard worker process -------------------------------------------------


def _emit(payload: dict) -> None:
    sys.stdout.write(_WIRE + json.dumps(payload) + "\n")
    sys.stdout.flush()


def _tick_loop(stop, fleet, tick_seconds: float) -> None:
    """Live-mode controller tick for every tenant env in this shard
    (lifecycle/binder progress; the serve loop owns solves). Registered in
    [tool.solverlint] thread-shared."""
    while not stop.wait(timeout=tick_seconds):
        for sess in fleet.sessions().values():
            sess.env.tick(provision=False)


class _ShardWorker:
    """One shard process's command executor: a private FleetFrontend over
    this shard's tenants, a ChurnHarness per replay-driven tenant, and a
    lazily-started loopback OperatorServer the router scrapes. Heavy
    imports (torch, the fleet) are deferred to the first add_tenant so spawn
    acks fast. Single protocol thread: commands execute strictly in
    arrival order, so no locking beyond what fleet/loop already carry."""

    def __init__(self, shard_id: str, device: str = "cuda"):
        self.shard_id = shard_id
        # the router's device, passed explicitly: a worker asked for the card
        # that finds none fails at its first GPU tenant (resolve_device)
        self.device = device
        self.fleet = None
        self.harnesses: dict[str, object] = {}
        self.server = None
        self.port = 0
        self._tick_stop = None
        self._tick_thread = None

    def _ensure_fleet(self):
        if self.fleet is None:
            from .fleet import FleetFrontend

            self.fleet = FleetFrontend(device=self.device)
        return self.fleet

    def _ensure_server(self) -> int:
        if self.server is None and self.fleet is not None:
            sessions = self.fleet.sessions()
            if sessions:
                from ..operator.server import OperatorServer

                sess = next(iter(sessions.values()))
                self.server = OperatorServer(sess.env, port=0, bind="127.0.0.1")
                self.port = self.server.start()
        return self.port

    # -- commands (cmd_<name>, dispatched by _worker_main) ---------------------
    def cmd_ping(self, req: dict) -> dict:
        return {"shard": self.shard_id, "pid": os.getpid(), "tenants": sorted(self.harnesses)}

    def cmd_add_tenant(self, req: dict) -> dict:
        from ..cloudprovider.fake import instance_types_assorted
        from ..operator.options import Options
        from .churn import ChurnHarness, ChurnSpec

        fleet = self._ensure_fleet()
        tid = req["tenant"]
        solver = req.get("solver", "gpu")
        overrides = dict(req.get("overrides") or {})
        if req.get("log"):
            # replay-driven tenant: the recorded log, filtered to THIS
            # tenant's ops (the re-homing contract), drives the harness
            spec = ChurnSpec.from_event_log(req["log"], tenant=tid, **overrides)
            opts = Options(
                solver_backend=solver,
                batch_idle_duration=spec.batch_idle_seconds,
                batch_max_duration=10.0,
            )
            sess = fleet.add_tenant(tid, options=opts, instance_types=instance_types_assorted(spec.n_types))
            self.harnesses[tid] = ChurnHarness(spec).attach(sess, fleet=fleet)
        else:
            from ..utils.clock import Clock

            fleet.add_tenant(tid, options=Options(solver_backend=solver), clock=Clock())
        return {"tenant": tid, "port": self._ensure_server()}

    def _run_one(self, tid: str) -> dict:
        import random

        h = self.harnesses[tid]
        # re-seed per REPLAY, not just per attach: successive replays in one
        # worker consume the global RNG, so without this a tenant's placement
        # would depend on its position in the run order — and a re-homed
        # replay on a warm survivor shard could never digest bit-identically
        random.seed(h.spec.seed)
        rep = h.run()
        return {"report": rep.as_dict(), "digest": placement_digest(h.env)}

    def cmd_run_tenant(self, req: dict) -> dict:
        tid = req["tenant"]
        if tid not in self.harnesses:
            raise KeyError(f"tenant {tid!r} has no replay harness on shard {self.shard_id}")
        row = self._run_one(tid)
        return {"tenant": tid, **row}

    def cmd_run_all(self, req: dict) -> dict:
        t0 = time.perf_counter()
        rows = {tid: self._run_one(tid) for tid in sorted(self.harnesses)}
        events = sum(r["report"]["events"] for r in rows.values())
        return {"tenants": rows, "events": events, "wall_seconds": round(time.perf_counter() - t0, 3)}

    def cmd_stats(self, req: dict) -> dict:
        fleet = self.fleet
        return {
            "shard": self.shard_id,
            "port": self.port,
            "tenants": sorted(self.harnesses),
            "fleet": fleet.stats() if fleet is not None else {},
        }

    def cmd_start(self, req: dict) -> dict:
        from ..obs.racecheck import make_event as mk_event

        fleet = self._ensure_fleet()
        fleet.start()
        if self._tick_thread is None:
            self._tick_stop = mk_event()
            self._tick_thread = spawn_thread(
                _tick_loop,
                name="karpenter-shard-tick",
                args=(self._tick_stop, fleet, float(req.get("tick_seconds", 0.5))),
            )
        return {"serving": True}

    def cmd_crash(self, req: dict) -> dict:
        # shard-death injection: die WITHOUT a response, so the router's
        # in-flight call sees EOF (ShardDead), exactly like a real crash
        os._exit(1)

    def cmd_shutdown(self, req: dict) -> dict:
        return {"bye": True}

    def close(self) -> None:
        if self._tick_stop is not None:
            self._tick_stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=5)
        if self.server is not None:
            self.server.stop()
        if self.fleet is not None:
            self.fleet.close()


def _worker_main() -> int:
    shard_id = os.environ.get("KARPENTER_SOLVER_SHARD_ID", "shard-0")
    # boot banner BEFORE any heavy import: the router's wait_ready acks on
    # this line, so spawn latency is interpreter start, not torch import
    _emit({"ok": True, "event": "ready", "shard": shard_id, "pid": os.getpid()})
    worker = _ShardWorker(shard_id, os.environ.get("KARPENTER_SOLVER_SHARD_DEVICE", "cuda"))
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        cmd = ""
        try:
            req = json.loads(line)
            cmd = req.get("cmd", "")
            fn = getattr(worker, f"cmd_{cmd}", None)
            if fn is None or cmd.startswith("_"):
                _emit({"ok": False, "error": f"unknown command {cmd!r}"})
                continue
            resp = fn(req)
        except Exception as e:
            # recorded (stderr log) and serialized onto the wire — the
            # router raises it as ShardError and its breaker counts it
            logging.getLogger("karpenter.shard").error("shard %s command %r failed: %s", shard_id, cmd, e)
            _emit({"ok": False, "error": f"{type(e).__name__}: {e}"})
            continue
        _emit({"ok": True, **(resp or {})})
        if cmd == "shutdown":
            break
    worker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker_main())
