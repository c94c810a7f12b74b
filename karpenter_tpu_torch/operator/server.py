"""Operator HTTP surface: health probes + Prometheus metrics (+ profiles).

Reference: operator.go:203-219 — metrics server on --metrics-port, healthz/
readyz probes on --health-probe-port, pprof handlers behind
--enable-profiling. Here one threaded stdlib server carries all routes:
/healthz, /readyz, /metrics, /debug/solves (the solvetrace flight-recorder
dump: recent SolveTraces + rolling per-(mode, phase) quantiles, see
obs/trace.py; `?n=<k>` limits to the newest k solves and `?tenant=<label>`
selects a fleet tenant's private recorder), /debug/events (the podtrace
event-lifecycle dump: completed EventRecords with the per-stage e2e
decomposition, SLO budget, and wake-cause split, per tenant — obs/
podtrace.py; same `?n=`/`?tenant=` filters), /debug/tenants (faultline:
per-tenant circuit-breaker state, backoff, last error, and backlog across
every live FleetFrontend — the failure-domain-isolation surface), and
/debug/profile (a py-spy-less stand-in that dumps running thread stacks,
the diagnostic the reference's pprof routes serve in e2e debugging —
karpenter_profiler.go:40-56).
"""

from __future__ import annotations

import json
import sys
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..obs.racecheck import make_lock, spawn_thread


class OperatorServer:
    # racecheck guarded-field registry: start/stop may race (signal handler
    # vs. shutdown path), so the server/thread handles are claimed under a lock
    GUARDED_FIELDS = {"_httpd": "_lock", "_thread": "_lock"}

    def __init__(self, env, port: int = 8080, enable_profiling: bool = False, bind: str = "0.0.0.0", router=None):
        """With `router` (a serving.shard.ShardRouter), this server is the
        fleet-of-fleets AGGREGATION front: /metrics merges every shard's
        fleet families (bounded `shard` label injected), /debug/tenants
        merges shard-stamped rows, /debug/solves|events proxy by ?tenant=
        to the owning shard, /readyz reflects shard breaker health, and
        /debug/shards exposes the router's per-shard breaker rows. `env`
        may be None in router mode (the router has no local tenants)."""
        self.env = env
        self.router = router
        self.port = port
        self.bind = bind  # probes/scrapes come from off-host (operator.go:180-183)
        self.enable_profiling = enable_profiling
        self._lock = make_lock("operator-server")
        self._httpd: ThreadingHTTPServer | None = None
        self._thread = None

    def start(self) -> int:
        env = self.env
        router = self.router
        enable_profiling = self.enable_profiling

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: str, ctype: str = "text/plain; charset=utf-8"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, "ok")
                elif self.path == "/readyz":
                    if router is not None:
                        ready = router.ready()
                        self._send(200 if ready else 503, "ok" if ready else "shard fleet not healthy")
                        return
                    ready = env.cluster.synced()
                    self._send(200 if ready else 503, "ok" if ready else "cluster state not synced")
                elif self.path == "/metrics" and router is not None:
                    # router mode: the shard-merged exposition (every shard's
                    # fleet families with the bounded `shard` label injected)
                    self._send(200, router.merged_metrics(), "text/plain; version=0.0.4")
                elif self.path == "/metrics":
                    # podtrace quantile gauges publish per SCRAPE (sorting
                    # the stage windows rides this handler, never the
                    # serving hot path)
                    from ..obs.podtrace import tenant_surfaces

                    own_tracer = getattr(env, "podtracer", None)
                    if own_tracer is not None:
                        own_tracer.publish_quantiles()
                    for _label, (_rec, tenant_tracer) in tenant_surfaces().items():
                        tenant_tracer.publish_quantiles()
                    self._send(200, env.registry.expose(), "text/plain; version=0.0.4")
                elif router is not None and self.path.split("?", 1)[0] in ("/debug/solves", "/debug/events"):
                    # router mode: proxy the per-tenant dump to the shard
                    # that serves that tenant (?tenant= is REQUIRED — the
                    # router has no local recorder to fall back on)
                    route = self.path.split("?", 1)[0]
                    qs = parse_qs(urlparse(self.path).query)
                    tenant = qs["tenant"][0] if "tenant" in qs else None
                    try:
                        limit = int(qs["n"][0]) if "n" in qs else None
                    except ValueError:
                        self._send(400, "bad ?n= value")
                        return
                    if tenant is None:
                        self._send(400, f"router mode: {route} requires ?tenant=")
                        return
                    try:
                        proxy = router.debug_solves if route == "/debug/solves" else router.debug_events
                        self._send(200, proxy(tenant, n=limit), "application/json")
                    except KeyError:
                        self._send(404, f"unknown tenant {tenant!r}")
                elif self.path.split("?", 1)[0] == "/debug/solves":
                    # served unconditionally (unlike /debug/profile, which the
                    # reference gates behind --enable-profiling): the trace
                    # dump's sensitivity class matches the unauthenticated
                    # /metrics exposition on this same port
                    from ..obs.podtrace import tenant_surfaces
                    from ..obs.trace import default_recorder

                    qs = parse_qs(urlparse(self.path).query)
                    try:
                        limit = int(qs["n"][0]) if "n" in qs else None
                    except ValueError:
                        self._send(400, "bad ?n= value")
                        return
                    tenant = qs["tenant"][0] if "tenant" in qs else None
                    if tenant is not None:
                        # per-tenant recorders (fleet mode): resolve through
                        # the podtrace tenant-surface registry
                        surf = tenant_surfaces().get(tenant)
                        if surf is None:
                            self._send(404, f"unknown tenant {tenant!r}")
                            return
                        rec = surf[0]
                    else:
                        rec = getattr(env, "trace_recorder", None) or default_recorder()
                    self._send(200, json.dumps(rec.dump(limit=limit), indent=1), "application/json")
                elif self.path.split("?", 1)[0] == "/debug/events":
                    # the podtrace event-lifecycle dump: per-tenant rings of
                    # completed EventRecords + rolling per-stage quantiles,
                    # SLO budget, and wake-cause attribution
                    from ..obs.podtrace import tenant_surfaces

                    qs = parse_qs(urlparse(self.path).query)
                    try:
                        limit = int(qs["n"][0]) if "n" in qs else None
                    except ValueError:
                        self._send(400, "bad ?n= value")
                        return
                    tracers = {}
                    own = getattr(env, "podtracer", None)
                    if own is not None:
                        tracers[own.tenant or "default"] = own
                    for label, (_rec, tracer) in tenant_surfaces().items():
                        tracers.setdefault(label, tracer)
                    tenant = qs["tenant"][0] if "tenant" in qs else None
                    if tenant is not None:
                        if tenant not in tracers:
                            self._send(404, f"unknown tenant {tenant!r}")
                            return
                        tracers = {tenant: tracers[tenant]}
                    body = {"tenants": {label: t.dump(limit=limit) for label, t in sorted(tracers.items())}}
                    self._send(200, json.dumps(body, indent=1), "application/json")
                elif self.path.split("?", 1)[0] == "/debug/tenants":
                    # faultline: per-tenant failure-domain state — breaker
                    # state/backoff/last-error, backlog, wakes — merged
                    # across every live FleetFrontend in this process, or in
                    # router mode across every SHARD (rows stamped with the
                    # owning shard id)
                    if router is not None:
                        self._send(200, json.dumps({"tenants": router.debug_tenants()}, indent=1), "application/json")
                        return
                    from ..serving.fleet import fleet_debug_surfaces

                    self._send(200, json.dumps({"tenants": fleet_debug_surfaces()}, indent=1), "application/json")
                elif self.path == "/debug/shards" and router is not None:
                    # shardfleet: per-shard liveness, breaker snapshot, debug
                    # port, ring index, and seated tenants
                    self._send(200, json.dumps({"shards": router.debug_shards()}, indent=1), "application/json")
                elif self.path == "/debug/profile" and enable_profiling:
                    frames = {}
                    for tid, frame in sys._current_frames().items():
                        frames[str(tid)] = traceback.format_stack(frame)
                    self._send(200, json.dumps(frames, indent=1), "application/json")
                else:
                    self._send(404, "not found")

        # construct AND install under one lock hold: a stop() racing the
        # bind window must either run before any socket exists (no-op, and
        # start proceeds as a legitimate later start) or see the installed
        # handles — never find None while a bound listener is about to be
        # published after it returned
        with self._lock:
            if self._httpd is not None:
                return self.port  # already serving: start() is idempotent
            httpd = ThreadingHTTPServer((self.bind, self.port), Handler)
            self._httpd = httpd
            self.port = httpd.server_address[1]  # resolve port 0
            self._thread = spawn_thread(httpd.serve_forever, name="karpenter-operator-http")
        return self.port

    def stop(self) -> None:
        """Idempotent and double-call-safe: the handles are claimed
        atomically, so a second (or concurrent) stop() finds None and
        returns instead of double-shutting the stdlib server."""
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)
