"""`python -m karpenter_tpu_torch` in its three modes, on the CPU through
the explicit `--device cpu` (the GPU solver's plain versions): the
single-cluster operator behind its server, `--fleet-tenants 2` (one process,
two tenant control planes) and `--fleet-shards 2 --fleet-tenants 3` (the
shard router over two worker processes). Each binds `--port 0`, prints its
bound port on the "up" line, answers `/healthz`, `/readyz`, `/metrics` and
`/debug/tenants` (and `/debug/shards` in shard mode) once it is ready, and
exits 0 on SIGTERM. Without CUDA and without `--device cpu` the operator
fails at start-up: it never runs on the CPU on its own."""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MODES = {
    "single": [],
    "fleet": ["--fleet-tenants", "2"],
    "shards": ["--fleet-shards", "2", "--fleet-tenants", "3"],
}


def _start(args: list[str]) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT), "KARPENTER_SOLVER_DOUBLEBUF": "1"}
    return subprocess.Popen([sys.executable, "-m", "karpenter_tpu_torch", "--port", "0", "--health-probe-port", "0",
                             "--tick-seconds", "0.2", *args], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _up_port(proc: subprocess.Popen, timeout: float = 120.0) -> tuple[int, str]:
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        m = re.search(r" up: .*http=[^:]*:(\d+)", line)
        if m:
            return int(m.group(1)), line
    raise AssertionError("no 'up' line: " + "".join(seen)[-3000:])


def _get(port: int, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_entry_point_serves_routes_and_exits_on_sigterm(mode):
    proc = _start(["--device", "cpu", *MODES[mode]])
    try:
        port, line = _up_port(proc)
        assert "solver=gpu" in line
        assert _get(port, "/healthz") == (200, "ok")
        deadline = time.monotonic() + 60
        while _get(port, "/readyz")[0] != 200:
            assert time.monotonic() < deadline, "never ready"
            time.sleep(0.2)
        code, metrics = _get(port, "/metrics")
        assert code == 200 and "# TYPE" in metrics
        code, body = _get(port, "/debug/tenants")
        tenants = json.loads(body)["tenants"]
        assert code == 200
        if mode == "single":
            assert tenants == {}
        else:
            n = int(MODES[mode][-1])
            assert sorted(tenants) == [f"tenant-{i}" for i in range(n)]
        if mode == "shards":
            assert "karpenter_solver_fleet_shards 2" in metrics
            shards = json.loads(_get(port, "/debug/shards")[1])["shards"]
            assert set(shards) == {"shard-0", "shard-1"} and all(r["alive"] for r in shards.values())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_entry_point_needs_cuda_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device starts")
    proc = _start([])
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "CUDA" in out
