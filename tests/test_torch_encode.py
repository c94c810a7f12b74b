"""The port's encoder (`karpenter_tpu_torch.solver.encode.encode`) against
the reference's, on the CPU.

- Every scenario of `tests/test_torch_scheduler.py` (up to 300 pods) and the
  benchmark snapshot at 1000 pods x 20 instance types, carried over into the
  port's classes (`testing.carry_over.snapshot_from_reference`), encodes to
  the reference's encoding (its default, columnar arm; the legacy arm,
  `KARPENTER_ENCODE_COLUMNAR=0`, is held to it by
  `tests/test_torch_twins_switches.py` and `tests/test_torch_switches.py`):
  every numpy array with its dtype and exact values, every name list, and
  every other field in canonical form (pods by key and uid, rows by node,
  template, instance type and offering, requirements and requests by
  content).
- One delta step through each package's `EncodeCache` (pods removed and
  pods appended): the delta encode is equal too, its `EncodedDelta` fields
  (`delta_added_sigs`, `delta_removed_enc`, `delta_row_diff`) included.
  `GPUSolver(device="cpu").solve_encoded` on the port's two encodings (the
  second solved from the first's resident carry) gives the reference
  `TPUSolver`'s mode, assignment and open count at both steps.
- The seeded headline fixture (`karpenter_tpu_torch/fixtures/snapshot/
  headline_5000x100_seeded.npz`, read by `chip_smoke.py`'s snapshot phase)
  equals a fresh port-side build and encode of the same seeded snapshot.

Tolerance: exact everywhere (every array is an integer, bool or float32
array built by the same numpy operations).

Write the fixture with the JAX package (about a minute on the CPU):

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_encode.py --write
"""

from __future__ import annotations

import os
import random
import sys
from enum import Enum

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import helpers  # noqa: E402
from chip_smoke import SNAPSHOT_FIXTURE, SNAPSHOT_SEED, delta_step_pods, expect_encoding, seeded_snapshot  # noqa: E402
from karpenter_tpu.solver import encode as ref_encode_mod  # noqa: E402
from karpenter_tpu_torch.solver import encode as port_encode_mod  # noqa: E402
from karpenter_tpu_torch.solver.encoded import encoding_arrays, from_reference  # noqa: E402
from karpenter_tpu_torch.solver.gpu import GPUSolver  # noqa: E402
from karpenter_tpu_torch.testing.carry_over import carry_objects, snapshot_from_reference  # noqa: E402
from test_torch_scheduler import SCENARIOS  # noqa: E402

torch.set_num_threads(1)

CORPUS = {**SCENARIOS, "bench_1000": lambda: bench.build_snapshot(1000, 20)}
# scenarios whose reference solve stays on the tensor path (no fallback),
# so both steps of a delta have a resident carry, and the mode of the
# delta step (anti_affinity removes required-affinity members: the delta
# solve rejects it as irreversible and packs whole)
DELTA_SCENARIOS = {"anti_affinity": "full", "bench_plain": "delta", "existing_nodes": "delta", "host_ports": "delta",
                   "topology_spread": "delta"}


# -- canonical form --------------------------------------------------------------

def canon(x, top: bool = False):
    """An encoding's value as plain, comparable data."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("scalar", x.dtype.str, x.item())
    if x is None or type(x) in (str, int, float, bool):
        return x
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(canon(v)) for v in x)))
    if isinstance(x, dict):
        return ("dict", tuple((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, Enum):
        return ("enum", type(x).__name__, x.name)
    name = type(x).__name__
    if name == "Pod":
        return ("Pod", x.key(), x.metadata.uid)
    if name == "StateNode":
        return ("StateNode", x.name())
    if name == "InstanceType":
        return ("InstanceType", x.name)
    if name == "NodeClaimTemplate":
        return ("NodeClaimTemplate", x.nodepool_name)
    if name == "EncodedSnapshot" and not top:
        return ("EncodedSnapshot",)
    slots = [s for c in type(x).__mro__ for s in c.__dict__.get("__slots__", ())]
    state = {s: getattr(x, s) for s in slots if hasattr(x, s)}
    state.update(getattr(x, "__dict__", {}))
    return (name, tuple((k, canon(v)) for k, v in sorted(state.items())))


# what a solver's device path and decode cache on an encoding it solved:
# not part of the encoder's output
SOLVER_CACHES = frozenset({"_sig_restrict", "decode_cache"})


def assert_same_encoding(got, want, what: str) -> None:
    """Every attribute equal in canonical form; arrays reported by name."""
    g = {k: v for k, v in vars(got).items() if k not in SOLVER_CACHES}
    w = {k: v for k, v in vars(want).items() if k not in SOLVER_CACHES}
    assert sorted(g) == sorted(w), what
    for name in w:
        if name == "delta_base":
            continue
        a, b = g[name], w[name]
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f"{what}: {name} dtype"
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
        else:
            assert canon(a, top=True) == canon(b, top=True), f"{what}: {name}"


def clear_globals() -> None:
    """Both encoders' module caches emptied, and the `random` stream both
    packages share (`Requirement.any`) started again."""
    ref_encode_mod.clear_encode_globals()
    port_encode_mod.clear_encode_globals()
    random.seed(0)


# -- full encode -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CORPUS))
def test_encode_matches_reference(name):
    ref = CORPUS[name]()
    port = snapshot_from_reference(ref)
    clear_globals()
    want = ref_encode_mod.encode(ref)
    clear_globals()
    got = port_encode_mod.encode(port)
    assert want.n_pods == len(ref.pods) or want.fallback_reasons
    assert_same_encoding(got, want, name)
    assert {k: v.dtype for k, v in encoding_arrays(got).items()} == \
        {k: v.dtype for k, v in encoding_arrays(want).items()}


# -- one delta step --------------------------------------------------------------

def _added_pods(name: str) -> list:
    """Pods for the delta step: shapes of the scenario's own pods, new
    objects with new names (the reference's builders)."""
    base = CORPUS[name]().pods
    out = []
    for i, p in enumerate(base[: max(2, len(base) // 4)]):
        q = type(p)(metadata=type(p.metadata)(name=f"{name}-added-{i}", namespace=p.metadata.namespace,
                                              labels=dict(p.metadata.labels)), spec=p.spec)
        out.append(q)
    return out


@pytest.mark.parametrize("name", sorted(DELTA_SCENARIOS))
def test_delta_encode_and_solve_match_reference(name):
    from karpenter_tpu.solver.tpu import TPUSolver

    ref = CORPUS[name]()
    port = snapshot_from_reference(ref)
    added_ref = _added_pods(name)
    added_port = carry_objects(added_ref)
    n_removed = max(1, len(ref.pods) // 5)
    clear_globals()
    jax_solver, port_cache, gpu = TPUSolver(force=True), port_encode_mod.EncodeCache(), GPUSolver(device="cpu")
    problems = []
    for step in range(2):
        if step == 1:
            ref.pods = delta_step_pods(ref.pods, added_ref, step, n_removed)
            port.pods = delta_step_pods(port.pods, added_port, step, n_removed)
        jax_solver.solve(ref)
        want = jax_solver.encode_cache.last_enc
        got = port_encode_mod.encode(port, cache=port_cache)
        what = f"{name} step {step}"
        assert_same_encoding(got, want, what)
        if step == 1:
            # (the reference's solver drops `delta_base` once it used it)
            assert got.delta_base is problems[0][1] and getattr(want, "delta_added_sigs", None) is not None, what
        problem = from_reference(got, base=problems[-1][0] if step else None)
        problems.append((problem, got))
        res = gpu.solve_encoded(problem)
        resident = jax_solver._resident
        assert jax_solver.last_solve_mode == (DELTA_SCENARIOS[name] if step else "full"), what
        assert gpu.last_solve_mode == jax_solver.last_solve_mode, what
        assert res.errors == [], what
        np.testing.assert_array_equal(res.assignment, np.asarray(resident["assignment"]), err_msg=what)
        assert res.open_count == int(np.asarray(resident["state"][6])), what


# -- the seeded headline fixture -------------------------------------------------

def test_seeded_headline_fixture_matches_port():
    """A fresh port-side build and encode of the seeded headline (and its
    delta step) equals the fixture the reference wrote, array by array."""
    with np.load(SNAPSHOT_FIXTURE, allow_pickle=False) as z:
        stored = {k: z[k] for k in z.files}
    assert int(stored["seed"]) == SNAPSHOT_SEED
    clear_globals()
    snap, added, _one = seeded_snapshot(SNAPSHOT_SEED)
    cache = port_encode_mod.EncodeCache()
    encs = [port_encode_mod.encode(snap, cache=cache)]
    snap.pods = delta_step_pods(snap.pods, added, SNAPSHOT_SEED)
    encs.append(port_encode_mod.encode(snap, cache=cache))
    for step, enc in enumerate(encs):
        expect_encoding(enc, stored, step)
    assert encs[1].delta_base is encs[0]


def write_fixture() -> None:
    """The seeded headline and its delta step through the JAX `TPUSolver`:
    the seed, both encodings (`s<i>.<name>`, `encoding_arrays`) and after
    each step the reference's mode, assignment and open count
    (`s<i>.ref_*`)."""
    import jax

    from karpenter_tpu.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu.solver.tpu import TPUSolver

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    reset_bucket_highwater()
    clear_globals()
    snap, added, _one = seeded_snapshot(SNAPSHOT_SEED, bench.build_snapshot, helpers)
    solver = TPUSolver(force=True)
    out = {"seed": np.int64(SNAPSHOT_SEED)}
    for step in range(2):
        if step == 1:
            snap.pods = delta_step_pods(snap.pods, added, SNAPSHOT_SEED)
        solver.solve(snap)
        enc = solver.encode_cache.last_enc
        resident = solver._resident
        pre = f"s{step}."
        out.update({pre + k: v for k, v in encoding_arrays(enc).items()})
        out.update({
            pre + "ref_mode": np.str_(solver.last_solve_mode),
            pre + "ref_assignment": np.asarray(resident["assignment"]),
            pre + "ref_open_count": np.int64(np.asarray(resident["state"][6])),
        })
        print(f"step {step}: {enc.n_pods} pods, mode {solver.last_solve_mode}, "
              f"open {int(out[pre + 'ref_open_count'])}", file=sys.stderr)
    SNAPSHOT_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(SNAPSHOT_FIXTURE, **out)


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_fixture()
    else:
        print(__doc__)
