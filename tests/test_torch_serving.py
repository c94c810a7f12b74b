"""Serving on the port (`karpenter_tpu_torch.serving`) against the
reference's, on the CPU.

A seeded `ChurnHarness` (200 base pods, 20 instance types, the reference's
churn mix scaled as `bench.py` scales it, `concurrent_seconds=0`, its event
log recorded) runs with the port's GPU solver on the CPU and with the
reference's harness. Both must give the same JSONL event log line for line
(apart from each op's wall offset `t`), the same mode for every solve, the
same placement digest (`serving.placement_digest`) after every bind flush
and the same wall-clock-free report fields (`testing.serving.
REPORT_FIELDS`); the port's steady window records no kernel-library load
(its `RecompileSentinel`). The port's harness replays the reference's log
(`ChurnSpec.from_event_log`) to the same digests, and after the first node
is revoked, `repack_savings("global")` (kernels K5 and K6's plain versions
here) equals the reference's. Exact.

The card's fixture `karpenter_tpu_torch/fixtures/serving/churn_5000x100.json`
holds the reference's headline churn (`testing.serving.HEADLINE`: every
solve's mode, the digest after every bind flush, the report's fields, the
repack after a revocation) and its four-tenant fleet (`FLEET`: each
tenant's modes, digests and report); `chip_smoke.check_serving` holds the
port on the card to it. Write it with

    JAX_PLATFORMS=cpu python tests/test_torch_serving.py --write
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import sys
import tempfile
import time
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from karpenter_tpu_torch.obs.trace import sentinel  # noqa: E402
from karpenter_tpu_torch.testing import serving as sv  # noqa: E402

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "karpenter_tpu_torch", "fixtures",
                       "serving", "churn_5000x100.json")
# bench.py's scaling of the churn mix to a 200-pod fleet
SMALL = dict(n_base_pods=200, n_types=20, arrivals=60, cancels=45, departures=60, bind_every=4, iterations=8,
             warmup_cycles=1, concurrent_seconds=0.0, seed=0)


def ref_api() -> types.SimpleNamespace:
    from karpenter_tpu.cloudprovider.fake import instance_types_assorted
    from karpenter_tpu.operator.options import Options
    from karpenter_tpu.serving import ChurnHarness, ChurnSpec, FleetFrontend, placement_digest

    return types.SimpleNamespace(ChurnSpec=ChurnSpec, Options=Options, instance_types_assorted=instance_types_assorted,
                                 backend="tpu", placement_digest=placement_digest, harness=ChurnHarness,
                                 fleet=FleetFrontend)


def ref_fresh_state() -> None:
    """The reference's counterpart of `testing.serving.fresh_state`."""
    from karpenter_tpu.controllers.provisioning.scheduling import nodeclaim
    from karpenter_tpu.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu.serving.fleet import reset_tenant_labels
    from karpenter_tpu.solver.encode import clear_encode_globals

    nodeclaim._hostname_seq = itertools.count(1)
    clear_encode_globals()
    reset_bucket_highwater()
    reset_tenant_labels()


def run_side(api, fresh, spec_kw: dict, log: str) -> dict:
    """One side's seeded churn: the recorded run, the steady window's
    sentinel delta, then the repack after a revocation."""
    fresh()
    h = api.harness(api.ChurnSpec(**spec_kw, record_path=log))
    try:
        out = sv.run_recorded(api, h)
        rep = out.pop("_report")
        out["steady_recompiles"] = rep.steady_recompiles
        out["repack"] = sv.revoke_and_repack(api, h)
    finally:
        h.close()
    with open(log) as f:
        out["log"] = [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]
    return out


@functools.lru_cache(maxsize=None)
def both_sides() -> tuple[dict, dict, str]:
    tmp = tempfile.mkdtemp(prefix="serving-")
    want = run_side(ref_api(), ref_fresh_state, SMALL, os.path.join(tmp, "ref.jsonl"))
    mark = sentinel().snapshot()
    got = run_side(sv.port_api("cpu"), sv.fresh_state, SMALL, os.path.join(tmp, "port.jsonl"))
    got["sentinel_delta"] = sentinel().delta(mark)
    return want, got, os.path.join(tmp, "ref.jsonl")


def test_event_log_matches_reference():
    want, got, _ = both_sides()
    assert len(got["log"]) == len(want["log"]) > 100
    for k, (g, w) in enumerate(zip(got["log"], want["log"])):
        assert g == w, f"op {k}"


def test_modes_and_digests_match_reference():
    want, got, _ = both_sides()
    assert got["modes"] == want["modes"] and "delta" in got["modes"]
    assert got["digests"] == want["digests"] and len(got["digests"]) > 4


def test_report_matches_reference():
    want, got, _ = both_sides()
    assert got["report"] == want["report"]
    assert got["report"]["delta_hit_rate"] > 0.3


def test_steady_window_loads_no_kernel_library():
    _, got, _ = both_sides()
    assert got["steady_recompiles"] == 0 and got["sentinel_delta"] == {}


def test_repack_after_revocation_matches_reference():
    want, got, _ = both_sides()
    assert got["repack"] == want["repack"]
    assert got["repack"]["revoked_events"] > 0


def test_port_replays_reference_log():
    """The reference's recorded log, replayed by the port's harness, gives
    the reference's digests after every bind flush."""
    want, _, log = both_sides()
    api = sv.port_api("cpu")
    sv.fresh_state()
    h = api.harness(api.ChurnSpec.from_event_log(log))
    try:
        out = sv.run_recorded(api, h)
    finally:
        h.close()
    assert out["digests"] == want["digests"]
    assert out["modes"] == want["modes"]


def test_harness_default_device_is_the_card():
    """Without a device the harness builds on CUDA, and raises without it."""
    from karpenter_tpu_torch.serving import ChurnHarness, ChurnSpec

    h = ChurnHarness(ChurnSpec(n_base_pods=4, n_types=4))
    assert h.device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            h.build()


# -- the card's fixture --------------------------------------------------------------
def write_fixture(path: str = FIXTURE) -> dict:
    """The reference's headline churn and fleet (module docstring)."""
    api = ref_api()
    t0 = time.perf_counter()
    ref_fresh_state()
    h = api.harness(sv.headline_spec(api))
    try:
        head = sv.run_recorded(api, h)
        head.pop("_report")
        head["repack"] = sv.revoke_and_repack(api, h)
    finally:
        h.close()
    t1 = time.perf_counter()
    ref_fresh_state()
    fleet = api.fleet()
    try:
        tenants = sv.run_fleet(api, fleet)
    finally:
        fleet.close()
    for rec in tenants.values():
        rec.pop("_report")
    out = dict(headline=dict(spec=sv.HEADLINE, **head), fleet=dict(spec=sv.FLEET, tenants=tenants),
               seconds=dict(headline=round(t1 - t0, 1), fleet=round(time.perf_counter() - t1, 1)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return out


def test_fixture_is_the_scenario():
    """The fixture was written for the scenario `testing.serving` defines."""
    with open(FIXTURE) as f:
        fx = json.load(f)
    assert fx["headline"]["spec"] == sv.HEADLINE and fx["fleet"]["spec"] == sv.FLEET
    assert len(fx["fleet"]["tenants"]) == sv.FLEET_TENANTS
    assert len(fx["headline"]["modes"]) >= fx["headline"]["report"]["solves"] > 0
    assert os.path.getsize(FIXTURE) < 1 << 20


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        res = write_fixture()
        print(json.dumps(res["seconds"]), os.path.getsize(FIXTURE), "bytes")
    else:
        raise SystemExit("usage: JAX_PLATFORMS=cpu python tests/test_torch_serving.py --write")
