"""The seeded operator scenario of `test_torch_operator.py`, the port's arm
and the parts both arms share, importing nothing of JAX (the card's test,
`test_torch_cuda.py::test_operator_scenario_on_card`, runs it too).

`build_snapshot(200, 20)`'s nodepool, instance types and pending pods
(pod names from pod-1, uids from a generator seeded with `SNAPSHOT_SEED`)
in an operator `Environment`, ticked (`chip_smoke.OperatorWatch`) until
`SCENARIO_QUIET` ticks in a row change nothing; then a seeded half of the
pods is deleted and it is ticked again until quiet, through consolidation.
"""

from __future__ import annotations

import itertools
import random
import uuid

import numpy as np

from chip_smoke import SNAPSHOT_SEED, OperatorWatch, operator_env, operator_start, operator_ticks

SCENARIO = (200, 20)  # pods x instance types
SCENARIO_MAX_TICKS = 60  # a phase that is not quiet by then fails
# a phase is quiet after this many ticks in a row change nothing: longer than
# the disruption controller's 10 s poll and a command's 15 s validation delay
SCENARIO_QUIET = 13
REMOVE_SEED = 1  # picks the half of the pods the second phase deletes


def seeded(shape: tuple, build, names):
    """`build(*shape)` with pod names from pod-1 (`names._seq`) and uids
    from a generator seeded with `SNAPSHOT_SEED`."""
    names._seq = itertools.count(1)
    rng = random.Random(SNAPSHOT_SEED)
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
    try:
        return build(*shape)
    finally:
        uuid.uuid4 = real


def port_watch(shape: tuple = SCENARIO, device="cpu") -> OperatorWatch:
    """The port's arm: `Environment(Options(), device=device)` over the
    seeded snapshot, from fresh module state, watched."""
    from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.obs import trace
    from karpenter_tpu_torch.operator import Environment
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver.encode import clear_encode_globals
    from karpenter_tpu_torch.testing import scenarios

    clear_encode_globals()
    reset_bucket_highwater()
    trace._DEFAULT = trace.TraceRecorder()
    snap = seeded(shape, scenarios.build_snapshot, scenarios)
    watch = OperatorWatch(operator_env(snap, Environment, Options(), device=device))
    operator_start(nodeclaim)
    return watch


def remove_half(env) -> None:
    """Delete a seeded half of the pods (in the store's order)."""
    pods = env.store.list("Pod")
    drop = set(np.random.default_rng(REMOVE_SEED).choice(len(pods), len(pods) // 2, replace=False).tolist())
    for i, p in enumerate(pods):
        if i in drop:
            env.store.delete("Pod", p.metadata.name, p.metadata.namespace, grace=False)


def run_phases(watch: OperatorWatch) -> list[dict]:
    """Both phases: per phase each tick's record and the last state."""
    phases = []
    for phase in range(2):
        if phase:
            remove_half(watch.env)
        records, state = operator_ticks(watch, SCENARIO_MAX_TICKS, quiet=SCENARIO_QUIET)
        assert not any(r["changed"] for r in records[-SCENARIO_QUIET:]), f"phase {phase} not quiet"
        phases.append(dict(records=records, state=state))
    return phases
