"""The reference's C++ requirement-table suite (`tests/test_native.py`) as
twins on the port (`torch_twins`): the fuzz against `Requirements.intersects`,
the catalog, unseen query values and two negatives, each run on the
reference's table and on the port's. Tolerance: exact.

One class cannot run as it is, and tests of the same claim stand in for it
here:

- `TestSchedulerUsesNative.test_ffd_solve_matches_with_and_without_native`
  runs its FFD solve in two child processes whose script inserts a fixed
  checkout path into `sys.path`, so a twin of it would import the port and
  the tests of whatever tree lies at that path, not of its own checkout. Its
  400 assorted instance types also leave 100 compatible ones, below the 200
  rows from which the table is used, so both of its runs would take the
  Python algebra. Its claim, that the FFD's placements are the same with and
  without the table, is made here over 1000 instance types, where the table
  is used:
  - `test_ffd_solve_matches_with_and_without_table`: the script's recipe
    (120 pods, seed 5, uids pinned) in this process, the port with the
    table (its filter count above 0) and with the threshold patched above
    1000 rows (count 0), both equal to the reference's FFD.
  - `test_disable_native_switch`: the same solve under
    `KARPENTER_DISABLE_NATIVE=1`, the switch the script sets, builds no
    table, `load_error()` names the switch, and the placements are the
    reference's; unset again, the next solve uses the table.

`tests/test_torch_native.py` holds the same claim for the seeded hybrid
shape, FFD and `GPUSolver` both.
"""

from __future__ import annotations

import random

import pytest

from torch_twins import assert_every_case_covered, assert_twin_case, params_of, reference_cases

MODULES = ("test_native",)
NOT_AS_IS = ("TestSchedulerUsesNative",)
CASES = [(m, c) for m in MODULES for c in reference_cases(m, skip_classes=NOT_AS_IS)]


@pytest.mark.parametrize("module,case", params_of(CASES))
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
    assert reference_cases("test_native", only_classes=NOT_AS_IS) == [
        "TestSchedulerUsesNative.test_ffd_solve_matches_with_and_without_native"]


def _ffd(pkg: str, n_types: int, threshold: int | None = None):
    """The reference script's FFD solve in package `pkg` over `n_types`
    assorted instance types: (its canonical Results, the port's table
    counts)."""
    import importlib
    import itertools

    wk = importlib.import_module(f"{pkg}.apis.labels")
    catalog = importlib.import_module(f"{pkg}.cloudprovider.catalog")
    fake = importlib.import_module(f"{pkg}.cloudprovider.fake")
    kube = importlib.import_module(f"{pkg}.kube")
    solver = importlib.import_module(f"{pkg}.solver.ffd")
    snapshot = importlib.import_module(f"{pkg}.solver.snapshot")
    state = importlib.import_module(f"{pkg}.state")
    informer = importlib.import_module(f"{pkg}.state.informer")
    clock_mod = importlib.import_module(f"{pkg}.utils.clock")
    nodeclaim = importlib.import_module(f"{pkg}.controllers.provisioning.scheduling.nodeclaim")
    if pkg == "karpenter_tpu":
        import helpers as names
    else:
        names = importlib.import_module(f"{pkg}.testing.scenarios")
    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.testing.canonical import canonical_results, json_form

    linux = [{"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
             {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]}]
    names._seq = itertools.count(1)
    store, clock = kube.Store(), clock_mod.FakeClock()
    cluster = state.Cluster(store, clock)
    informer.start_informers(store, cluster)
    np_ = names.make_nodepool(requirements=linux)
    store.create(np_)
    rng = random.Random(5)
    pods = [names.make_pod(cpu=rng.choice(["500m", "1", "2"]), memory="1Gi",
                           node_selector={wk.ZONE_LABEL_KEY: rng.choice(catalog.ZONES)} if rng.random() < 0.3 else None)
            for _ in range(120)]
    for i, p in enumerate(pods):
        p.metadata.uid = f"uid-{i:04d}"
    snap = snapshot.SolverSnapshot(store=store, cluster=cluster, node_pools=[np_],
                                 instance_types={np_.metadata.name: fake.instance_types_assorted(n_types)},
                                 state_nodes=[], daemonset_pods=[], pods=pods, clock=clock)
    random.seed(0)
    nodeclaim._hostname_seq = itertools.count(1)
    native.reset_counts()
    saved = nodeclaim.NATIVE_MIN_TABLE_ROWS
    if threshold is not None:
        nodeclaim.NATIVE_MIN_TABLE_ROWS = threshold
    try:
        r = solver.FFDSolver().solve(snap)
    finally:
        nodeclaim.NATIVE_MIN_TABLE_ROWS = saved
    assert r.all_pods_scheduled()
    return json_form(canonical_results(r)), dict(native.COUNTS)


def test_ffd_solve_matches_with_and_without_table():
    want, _ = _ffd("karpenter_tpu", 1000)
    with_table, counts = _ffd("karpenter_tpu_torch", 1000)
    without, no_counts = _ffd("karpenter_tpu_torch", 1000, threshold=1001)
    assert with_table == without == want
    assert counts["filters"] > 0 and no_counts == {"tables": 0, "filters": 0}


def test_disable_native_switch(monkeypatch):
    from karpenter_tpu_torch import native

    want, _ = _ffd("karpenter_tpu", 1000)
    monkeypatch.setenv("KARPENTER_DISABLE_NATIVE", "1")
    assert native.disabled() and not native.available()
    assert native.load_error() == native.DISABLED == "disabled via KARPENTER_DISABLE_NATIVE"
    with pytest.raises(native.NativeBuildError, match="KARPENTER_DISABLE_NATIVE"):
        native.ReqTable([])
    off, off_counts = _ffd("karpenter_tpu_torch", 1000)
    assert off == want and off_counts == {"tables": 0, "filters": 0}
    monkeypatch.delenv("KARPENTER_DISABLE_NATIVE")
    assert native.load_error() is None
    on, on_counts = _ffd("karpenter_tpu_torch", 1000)
    assert on == want and on_counts["filters"] > 0
