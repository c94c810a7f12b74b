"""The KWOK operator binary (reference: kwok/main.go:29-51).

Boots the full control plane against the in-process store with the embedded
KWOK instance-type catalog, serves health/metrics endpoints, and runs the
leader-elected reconcile loop on the wall clock until interrupted:

    python -m karpenter_tpu_torch [--solver gpu|ffd] [--device cuda|cpu] [--port 8080]
    python -m karpenter_tpu_torch --fleet-tenants 4 [--port 0]
    python -m karpenter_tpu_torch --fleet-shards 2 --fleet-tenants 4 [--port 0]

Options also come from the environment (operator/options.py from_env):
FEATURE_GATES, SOLVER_BACKEND, BATCH_*_DURATION, PREFERENCE_POLICY, ...
The "gpu" solver backend (the default) runs on `--device`, the CUDA device
unless the caller names "cpu" (the kernels' plain versions); without CUDA
and without `--device cpu` the operator fails at start-up.
"""

from __future__ import annotations

import argparse
import signal

from .obs.racecheck import make_event
from .operator import Environment
from .operator.options import Options
from .operator.server import OperatorServer
from .utils.clock import Clock


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="karpenter-tpu-torch")
    parser.add_argument("--solver", choices=("ffd", "gpu"), default=None, help="solver backend (SOLVER_BACKEND)")
    parser.add_argument("--device", default=None,
                        help="the gpu solver's device: cuda (the default) or cpu (the kernels' plain versions)")
    parser.add_argument("--port", type=int, default=None, help="health + metrics port (0 = ephemeral; default --metrics-port)")
    parser.add_argument("--bind", default="0.0.0.0", help="health + metrics bind address")
    parser.add_argument("--tick-seconds", type=float, default=1.0, help="controller round interval")
    parser.add_argument(
        "--fleet-tenants",
        type=int,
        default=0,
        help="N>0 boots the multi-tenant fleet front-end instead of the single-cluster "
        "loop: N tenant control planes in this process, push-driven wake, shared "
        "kernel shapes, one /metrics (tenant-labeled). Tenant ids are tenant-0..N-1; "
        "KARPENTER_SOLVER_COMPILE_CACHE=<dir> keeps the built kernels across restarts.",
    )
    parser.add_argument(
        "--fleet-shards",
        type=int,
        default=0,
        help="N>0 boots the SHARDED fleet (serving/shard.py): N shard worker "
        "processes, each a FleetFrontend over its consistent-hash slice of the "
        "--fleet-tenants tenants, sharing one KARPENTER_SOLVER_COMPILE_CACHE. "
        "This process runs the ShardRouter + the aggregated /metrics, "
        "/debug/tenants, /debug/shards, and ?tenant=-proxied debug surfaces.",
    )
    # every reference flag (options.go AddFlags: --metrics-port,
    # --kube-client-qps, --log-level, --disable-leader-election,
    # --enable-profiling, --feature-gates, ...) parses via Options.from_args
    args, rest = parser.parse_known_args(argv)

    options = Options.from_args(rest)
    if args.solver:
        options.solver_backend = args.solver
    port = args.port if args.port is not None else options.metrics_port

    import logging
    import sys as _sys

    handlers = []
    for path in options.log_output_paths.split(","):
        path = path.strip()
        if path in ("stdout", "stderr"):
            handlers.append(logging.StreamHandler(getattr(_sys, path)))
        elif path:
            handlers.append(logging.FileHandler(path))
    logging.basicConfig(
        level={"debug": logging.DEBUG, "info": logging.INFO, "error": logging.ERROR}[options.log_level],
        handlers=handlers or None,
    )

    if args.fleet_shards > 0:
        return _run_sharded(args, options, port)
    if args.fleet_tenants > 0:
        return _run_fleet(args, options, port)

    env = Environment(options=options, clock=Clock(), device=args.device)
    server = OperatorServer(env, port=port, enable_profiling=options.enable_profiling, bind=args.bind)
    port = server.start()
    # dedicated health-probe listener (options.go --health-probe-port) when it
    # differs from the metrics port, so k8s probes pointed at the flag work
    health_server = None
    if options.health_probe_port not in (port, 0):
        health_server = OperatorServer(env, port=options.health_probe_port, enable_profiling=False, bind=args.bind)
        try:
            health_server.start()
        except (OSError, OverflowError) as e:
            print(f"health-probe port {options.health_probe_port} unavailable: {e}", flush=True)
            health_server = None
    print(f"karpenter-tpu-torch operator up: solver={options.solver_backend} http={args.bind}:{port}", flush=True)

    stop = make_event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread
    try:
        env.run(
            stop_event=stop,
            tick_seconds=args.tick_seconds,
            leader_election=not options.disable_leader_election,
        )
    finally:
        server.stop()
        if health_server is not None:
            health_server.stop()
    return 0


def _run_sharded(args, options, port: int) -> int:
    """Sharded fleet mode: this process is the ShardRouter — it spawns
    --fleet-shards worker processes (each its own FleetFrontend serve loop
    over a consistent-hash slice of the tenants, sharing one persistent
    kernel build directory and a contiguous device slice), seats tenant-0..K-1 on
    the ring, starts every shard serving, and fronts the aggregated
    debug/metrics surfaces plus the breaker-driven health monitor."""
    import os

    from .serving.shard import ShardRouter

    n_tenants = args.fleet_tenants if args.fleet_tenants > 0 else args.fleet_shards
    router = ShardRouter(
        n_shards=args.fleet_shards,
        solver=options.solver_backend,
        cache_dir=os.environ.get("KARPENTER_SOLVER_COMPILE_CACHE", "").strip() or None,
        device=args.device,
    )
    router.spawn()
    server = None
    try:
        for i in range(n_tenants):
            router.add_tenant(f"tenant-{i}")
        router.start_serving(tick_seconds=args.tick_seconds)
        router.start_monitor()
        server = OperatorServer(None, port=port, enable_profiling=options.enable_profiling, bind=args.bind, router=router)
        port = server.start()
        print(
            f"karpenter-tpu-torch sharded fleet up: shards={args.fleet_shards} tenants={n_tenants} "
            f"solver={options.solver_backend} http={args.bind}:{port}",
            flush=True,
        )
        stop = make_event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, lambda *_: stop.set())
            except ValueError:
                pass  # not the main thread
        stop.wait()
    finally:
        if server is not None:
            server.stop()
        router.close()
    return 0


def _run_fleet(args, options, port: int) -> int:
    """Fleet mode: one process, N tenant control planes, the push-driven
    DRR serve loop, and a single metrics/debug endpoint over the shared
    registry (the first tenant's environment fronts the HTTP surface — its
    registry IS the fleet registry). Leader election is per-cluster state
    the fleet does not arbitrate; run one fleet per shard."""
    from .metrics import make_registry
    from .serving.fleet import FleetFrontend

    registry = make_registry()
    fleet = FleetFrontend(registry=registry, device=args.device)
    sessions = []
    for i in range(args.fleet_tenants):
        sessions.append(fleet.add_tenant(f"tenant-{i}", options=options, clock=Clock()))
    server = OperatorServer(sessions[0].env, port=port, enable_profiling=options.enable_profiling, bind=args.bind)
    port = server.start()
    # same dedicated health-probe listener contract as the single-cluster
    # path: k8s probes pointed at --health-probe-port must answer
    health_server = None
    if options.health_probe_port not in (port, 0):
        health_server = OperatorServer(sessions[0].env, port=options.health_probe_port, enable_profiling=False, bind=args.bind)
        try:
            health_server.start()
        except (OSError, OverflowError) as e:
            print(f"health-probe port {options.health_probe_port} unavailable: {e}", flush=True)
            health_server = None
    print(
        f"karpenter-tpu-torch fleet up: tenants={args.fleet_tenants} solver={options.solver_backend} "
        f"http={args.bind}:{port}",
        flush=True,
    )
    stop = make_event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread
    fleet.start()
    try:
        # the fleet serve loop owns ALL solves; this thread runs the
        # per-tenant controller rounds (lifecycle/bind/GC) at the tick
        # cadence with provisioning skipped (tick(provision=False))
        while not stop.is_set():
            for sess in sessions:
                sess.env.tick(provision=False)
            stop.wait(args.tick_seconds)
    finally:
        fleet.close()
        server.stop()
        if health_server is not None:
            health_server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
