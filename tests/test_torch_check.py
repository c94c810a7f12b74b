"""The port's `fast_validate` returns the same violations as the reference's
on sound and on deliberately corrupted placements."""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.models import scheduler_model as jsm
from karpenter_tpu.solver.check import fast_validate as ref_fast_validate
from karpenter_tpu.solver.encode import encode
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.solver.check import fast_validate
from karpenter_tpu_torch.solver.encoded import from_reference
from karpenter_tpu_torch.solver.gpu import GPUSolver
from test_torch_fixtures import CORPUS, corpus_snapshot

CASES = ("small_spread_anti_ports", "small_existing_ports_inverse", "small_existing_affinity", "small_min_domains_hostname")


def _corruptions(p, res):
    """(label, assignment, slot_basis, slot_zoneset) variants of a sound
    placement, each breaking one family of checks."""
    a, basis, zs = res.assignment, res.slot_basis, res.slot_zoneset
    placed = np.nonzero(a >= 0)[0]
    out = [("sound", a, basis, zs)]
    b = a.copy()
    b[placed[:2]] = basis.shape[0] - 1  # closed slot
    out.append(("closed-slot", b, basis, zs))
    b = a.copy()
    b[placed] = a[placed[0]]  # everything on one slot
    out.append(("pile-up", b, basis, zs))
    z2 = zs.copy()
    z2[np.unique(a[placed])] = True  # uncommit every used slot's domains
    out.append(("uncommitted", a, basis, z2))
    z3 = zs.copy()
    z3[np.unique(a[placed])] = False
    out.append(("no-domain", a, basis, z3))
    b2 = basis.copy()
    used = np.unique(a[placed])
    b2[used] = p.n_existing + (b2[used] + 1 - p.n_existing) % max(p.n_rows - p.n_existing, 1)  # other rows
    out.append(("other-basis", a, b2, zs))
    if p.n_existing:
        b = a.copy()
        b[placed] = 0  # onto the first existing node
        out.append(("existing-node", b, basis, zs))
    return out


@pytest.mark.parametrize("name", CASES)
def test_fast_validate_matches_reference(name):
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    enc = encode(corpus_snapshot(name))
    p = from_reference(enc)
    res = GPUSolver(device="cpu").solve_encoded(p)
    assert res.errors == []
    seen_errors = 0
    for label, a, basis, zs in _corruptions(p, res):
        want = ref_fast_validate(enc, a, basis, zs)
        got = fast_validate(p, a, basis, zs)
        assert got == want, label
        seen_errors += bool(want)
    assert seen_errors >= 4
