"""The port's consolidation encoder against the reference's, on the CPU.

The candidates of one consolidation round (`test_torch_consolidation_fixtures`'
fleets: `tests/test_consolidation_tpu.build_fleet` at 4, 6 and 7 nodes, the
6-node fleet with 3 pending pods, the 300-node spot/on-demand fleet of
`bench._build_consolidation_fleet`), their instance types and pending pods
are carried over into the port's classes (`testing.carry_over`). Then,
exact:

* `_candidate_vectors` array by array (with the pending pods: the global
  mode's extra classes);
* `encode_candidates_lp`'s tensors and aux arrays, and `encode_candidates`'
  dense compatibility matrix, against the reference's;
* `propose_subsets_lp(candidates, instance_types)`, with no inits given, the
  reference's proposals: the port draws the reference's own inits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import karpenter_tpu.solver.consolidation as jcons
import karpenter_tpu_torch.solver.consolidation as tcons
from karpenter_tpu_torch.testing.carry_over import carry_objects
from test_torch_consolidation_fixtures import AUX_FIELDS, FLEETS, T_FIELDS
from test_torch_solve import clear_globals

torch.set_num_threads(1)

NAMES = ["small_4", "small_6", "small_6_pending", "small_7", "bench_300_hetero"]
_ROUNDS: dict = {}


def round_of(name):
    """(reference (candidates, types, pending), port's carried copy), built
    once per fleet."""
    if name not in _ROUNDS:
        ref = FLEETS[name]()
        _ROUNDS[name] = (ref, carry_objects(list(ref)))
    return _ROUNDS[name]


@pytest.mark.parametrize("name", NAMES)
def test_candidate_vectors(name):
    (cands, its, pending), (pc, pits, ppend) = round_of(name)
    clear_globals()
    want = jcons._candidate_vectors(cands, its, pending_pods=pending or None)
    got = tcons._candidate_vectors(pc, pits, pending_pods=ppend or None)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and np.array_equal(g, v), k
        else:
            assert g == v, k
    problem = tcons.encode_problem(pc, pits, ppend or None)
    assert problem.n == len(pc) and problem.n_classes == want["n_classes"]


@pytest.mark.parametrize("name", NAMES)
def test_encode_candidates_lp(name):
    (cands, its, pending), (pc, pits, ppend) = round_of(name)
    clear_globals()
    t, aux = jcons.encode_candidates_lp(cands, its, pending_pods=pending or None)
    pt, paux = tcons.encode_candidates_lp(pc, pits, pending_pods=ppend or None, device="cpu")
    for f in T_FIELDS:
        assert np.array_equal(getattr(pt, f).numpy(), np.asarray(getattr(t, f))), f
    for f in AUX_FIELDS + ("compat_qn",):
        a = paux[f].numpy() if isinstance(paux[f], torch.Tensor) else np.float32(paux[f])
        assert np.array_equal(a, np.asarray(aux[f])), f
    assert (paux["n"], paux["n_classes"]) == (aux["n"], aux["n_classes"])


def test_encode_candidates_dense():
    (cands, its, _p), (pc, pits, _pp) = round_of("small_7")
    clear_globals()
    want = np.asarray(jcons.encode_candidates(cands, its).pod_compat)
    got = tcons.encode_candidates(pc, pits, device="cpu").pod_compat.numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["small_4", "small_6", "small_7", "bench_300_hetero"])
def test_propose_subsets_lp_from_candidates(name):
    (cands, its, _p), (pc, pits, _pp) = round_of(name)
    clear_globals()
    from karpenter_tpu.obs.trace import SolveTrace as RefTrace
    from karpenter_tpu_torch.obs.trace import SolveTrace

    ref_trace = RefTrace(enabled=True)
    want = jcons.propose_subsets_lp(cands, its, trace=ref_trace)
    trace = SolveTrace(enabled=True)
    got = tcons.propose_subsets_lp(pc, pits, device="cpu", trace=trace)
    assert got == want
    assert list(trace.phase_totals)[:3] == ["encode_candidates", "tensors", "K5 globalpack"]
    # the reference's spans and notes, the port's stages inside them
    assert [s.name for s in trace.spans] == [s.name for s in ref_trace.spans] == ["encode_candidates", "lp_repack",
                                                                                 "round"]
    assert trace.spans[0].attrs == ref_trace.spans[0].attrs and trace.attribution == ref_trace.attribution


def test_one_candidate_proposes_nothing():
    (_c, _i, _p), (pc, pits, _pp) = round_of("small_4")
    assert tcons.propose_subsets_lp(pc[:1], pits, device="cpu") == []
