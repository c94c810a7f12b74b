"""The per-pod pack of the PyTorch port against the JAX reference.

The reference's per-pod FFD scan (`karpenter_tpu.models.scheduler_model.
greedy_pack`) leaves out host ports, required pod affinity and inverse
anti-affinity blocks by design, so on some fixtures its placement fails
the reference's own `fast_validate`. Parity here means the reference's
five outputs exactly and the reference's validation errors exactly, not
0 errors.

- `select`: `first_true_index` / `masked_argmin` against the JAX ones on
  seeded inputs with ties and all-False masks.
- `make_pod_tensors` against the per-pod fields of the JAX `make_tensors`.
- K1 over the pods: the batched key against the reference's in-step
  `row_choose_key` (one pod's [R] request at a time), bit for bit.
- The plain scan against the JAX `_greedy_pack_impl` on seeded synthetic
  tensors that reach the scan's corners: ties of the row key, no row
  fitting, the slot axis running out, every domain costing INF (z_star
  falls to the sentinel 0), closed slots and hostname counts.
- The six small fixtures live (JAX encode, JAX pack, port pack from
  `from_reference`), the two headlines against the stored outputs in
  `karpenter_tpu_torch/fixtures/perpod/<name>.npz`. Each such file holds
  only the JAX `greedy_pack` outputs and the reference's `fast_validate`
  errors (pod keys as in the problem file), keyed to the problem npz of
  the same name. Regenerate them with

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_perpod.py --write [name ...]

The kernels themselves (K1 over the pods, K8) run only on the card:
`tests/test_torch_cuda.py -m gpu` and `chip_smoke.py`.
"""

from __future__ import annotations

import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu.ops import select as jselect  # noqa: E402
import chip_smoke  # noqa: E402
from karpenter_tpu_torch.kernels import build  # noqa: E402
from karpenter_tpu_torch.kernels import perpod_pack as perpod_pack_module  # noqa: E402
from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain  # noqa: E402
from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from karpenter_tpu_torch.ops import select as tselect  # noqa: E402
from karpenter_tpu_torch.solver.check import fast_validate  # noqa: E402
from karpenter_tpu_torch.solver.encoded import from_reference, load_npz  # noqa: E402
from test_torch_fixtures import CORPUS, FIXTURE_DIR, corpus_snapshot  # noqa: E402

# the plain scan is thousands of tiny ops: one intra-op thread per test worker
torch.set_num_threads(1)

PERPOD_DIR = FIXTURE_DIR / "perpod"
HEADLINES = ("headline_5000x100", "headline_aff_5000x100")
SMALL = tuple(sorted(n for n in CORPUS if n not in HEADLINES))
OUTPUTS = ("assignment", "slot_basis", "slot_domset", "slot_rank", "open_count")


def _encode(name: str):
    """A fresh JAX encode of a corpus entry (pinned uids), with both
    packages' high-water marks reset."""
    from karpenter_tpu.solver.encode import encode

    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    return encode(corpus_snapshot(name))


def reference_perpod(enc) -> tuple[list, list]:
    """The JAX per-pod pack on an encode (the reference's default slot
    axis) and the reference's validation of its placement."""
    from karpenter_tpu.solver.check import fast_validate as ref_fast_validate

    out = [np.asarray(x) for x in jsm.greedy_pack(jsm.make_tensors(enc))]
    return out, ref_fast_validate(enc, out[0], out[1], out[2])


def _assert_outputs(got, want, what: str) -> None:
    for name, a, b in zip(OUTPUTS, got, want):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.asarray(b).dtype or name == "open_count", (what, name, a.dtype)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{what}: {name}")


# -- select ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_select_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    values = rng.choice(np.array([0.0, -1.0, 3.5, 1e9, -2e8, 3.4e38], np.float32), size=n).astype(np.float32)
    for p_true in (0.0, 0.3, 1.0):
        mask = rng.random(n) < p_true
        got = tselect.first_true_index(torch.as_tensor(mask))
        assert got.dtype == torch.int32
        assert int(got) == int(jselect.first_true_index(jnp.asarray(mask)))
        got = tselect.masked_argmin(torch.as_tensor(values), torch.as_tensor(mask))
        assert got.dtype == torch.int32
        assert int(got) == int(jselect.masked_argmin(jnp.asarray(values), jnp.asarray(mask)))


def test_masked_argmin_sentinel_and_ties():
    v = torch.tensor([5.0, 2.0, 2.0, 3.4e38], dtype=torch.float32)
    assert int(tselect.masked_argmin(v, torch.tensor([True, True, True, True]))) == 1  # ties to the lowest
    assert int(tselect.masked_argmin(v, torch.tensor([False, False, False, False]))) == -1
    # a masked-in value at BIG loses the tie to a masked-out entry below it
    assert int(tselect.masked_argmin(v, torch.tensor([False, False, False, True]))) == -1
    assert int(tselect.first_true_index(torch.tensor([False, False]))) == -1


# -- tensors and K1 over the pods -------------------------------------------------


@pytest.mark.parametrize("name", SMALL)
def test_make_pod_tensors_matches_reference(name):
    enc = _encode(name)
    jt = jsm.make_tensors(enc)
    p = from_reference(enc)
    t = tsm.make_tensors(p, "cpu")
    pods = tsm.make_pod_tensors(p, "cpu", t)
    assert t.n_slots == jt.n_slots
    np.testing.assert_array_equal(pods.pod_mask.numpy(), np.asarray(jt.pod_mask).view(np.int32))
    for field in ("pod_req", "pod_taint_ok", "pod_dom_allowed", "pod_restrict", "member", "owner"):
        got, want = getattr(pods, field).numpy(), np.asarray(getattr(jt, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_batched_key_equals_in_step_key(name):
    """K1's plain version over all pods at once equals the reference's
    compat matrix and its in-step row key (one [R] request per step), bit
    for bit: the division and `rank * 1e9 - score` round the same way."""
    problem, _ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    tsm.reset_bucket_highwater()
    t = tsm.make_tensors(problem, "cpu")
    pods = tsm.make_pod_tensors(problem, "cpu", t)
    build.reset_launches()
    compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    assert build.LAUNCHES["feasibility"] == 0  # CPU tensors: the plain version
    c2, k2 = compat_and_key_plain(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    assert torch.equal(compat, c2) and torch.equal(key, k2)
    ra, rr = t.row_alloc.numpy(), t.row_pool_rank.numpy()
    in_step = jax.jit(lambda reqs: jax.lax.map(lambda q: jsm.row_choose_key(ra, rr, q), reqs))
    want_k = np.asarray(in_step(pods.pod_req.numpy()))
    np.testing.assert_array_equal(key.numpy().view(np.int32), want_k.view(np.int32))
    want_c = np.asarray(jsm.compat_matrix(t.row_labels.numpy(), t.row_taint_class.numpy(),
                                          pods.pod_mask.numpy().view(np.uint32), pods.pod_taint_ok.numpy(),
                                          t.dom_keys))
    np.testing.assert_array_equal(compat.numpy(), want_c)


# -- the scan on synthetic tensors ----------------------------------------------------


def _synthetic(seed: int) -> dict:
    """Small scheduler tensors and pods (numpy) with the scan's corners
    made likely: repeated rows (key ties), few slots, pods whose allowed
    domains miss their key's (restrict drawn apart from them, so INF
    costs and the sentinel commit happen), tight capacities."""
    rng = np.random.default_rng(seed)
    n_ex, Nrows, n_real, R, K, C, Q, G = 3, 16, 13, 4, 3, 2, 3, 6
    dom_key_of = np.array([0, 1, 0, 0, 0, 1, 1], np.int32)  # ids 0, 1: the per-key sentinels
    D, Kd = dom_key_of.shape[0], 2
    N = int(rng.choice([8, 12]))
    P = 40
    alloc = rng.choice(np.array([2.0, 4.0, 8.0], np.float32), size=(Nrows, R)).astype(np.float32)
    alloc[:, -1] = np.float32(1e30)  # a pad resource
    alloc[6:9] = alloc[5]  # identical rows: the key ties
    alloc[n_real:] = np.float32(-3.4e38)
    rank = np.concatenate([np.full(n_ex, -1), rng.integers(0, Q, Nrows - n_ex)]).astype(np.int32)
    rank[n_real:] = 0
    rank[6:9] = rank[5]
    labels = rng.integers(0, 20, size=(Nrows, K)).astype(np.int32)
    labels[6:9] = labels[5]
    taint_class = rng.integers(0, C, Nrows).astype(np.int32)
    taint_class[6:9] = taint_class[5]
    rank_domset = rng.random((Q, D)) < 0.6
    kinds = rng.choice(np.array([0, 0, 1, 2, 3, -1], np.int32), size=G).astype(np.int32)
    dom_key = np.where((kinds == 0) | (kinds == 3), rng.integers(0, Kd, G), -1).astype(np.int32)
    ex_dom = np.zeros((n_ex, D), bool)
    for j in range(n_ex):
        ex_dom[j, rng.choice(np.nonzero(dom_key_of == 0)[0])] = True
        ex_dom[j, rng.choice(np.nonzero(dom_key_of == 1)[0])] = True
    counts_host = np.zeros((G, N), np.int32)
    counts_host[:, :n_ex] = rng.integers(0, 2, size=(G, n_ex))
    pod_req = rng.choice(np.array([0.5, 1.0, 2.0, 3.0], np.float32), size=(P, R)).astype(np.float32)
    pod_req[:, -1] = 0.0
    pod_req[rng.random(P) < 0.1] = np.float32(9.0)  # fits no row
    return dict(
        n_ex=n_ex, n_real=n_real, N=N, alloc=alloc, rank=rank, labels=labels, taint_class=taint_class,
        rank_domset=rank_domset, dom_key_of=dom_key_of, kinds=kinds, skew=rng.integers(1, 3, G).astype(np.int32),
        dom_key=dom_key, min_domains=np.where(rng.random(G) < 0.3, 3, 0).astype(np.int32),
        registered=rng.random((G, D)) < 0.8, counts_dom=rng.integers(0, 3, size=(G, D)).astype(np.int32),
        counts_host=counts_host, ex_dom=ex_dom, pod_req=pod_req,
        pod_mask=rng.integers(0, 2**32, size=(P, K, 1), dtype=np.uint64).astype(np.uint32),
        pod_taint_ok=rng.random((P, C)) < 0.9, pod_dom_allowed=rng.random((P, D)) < 0.7,
        pod_restrict=rng.random((P, Kd)) < 0.4, member=rng.random((P, G)) < 0.3, owner=rng.random((P, G)) < 0.3,
    )


def _jax_tensors(s: dict):
    Nrows, R = s["alloc"].shape
    P1 = np.zeros((Nrows, 4), bool)
    ex_ports = np.zeros((s["n_ex"], 4), bool)
    return jsm.SchedulerTensors(
        n_rows_real=jnp.int32(s["n_real"]), row_alloc=jnp.asarray(s["alloc"]), row_labels=jnp.asarray(s["labels"]),
        row_pool_rank=jnp.asarray(s["rank"]), row_taint_class=jnp.asarray(s["taint_class"]),
        rank_domset=jnp.asarray(s["rank_domset"]),
        rank_dom_cap=jnp.zeros((s["rank_domset"].shape[0], s["dom_key_of"].shape[0], R), jnp.float32),
        dom_key_of=jnp.asarray(s["dom_key_of"]), pod_req=jnp.asarray(s["pod_req"]),
        pod_mask=jnp.asarray(s["pod_mask"]), pod_taint_ok=jnp.asarray(s["pod_taint_ok"]),
        pod_dom_allowed=jnp.asarray(s["pod_dom_allowed"]), pod_restrict=jnp.asarray(s["pod_restrict"]),
        member=jnp.asarray(s["member"]), owner=jnp.asarray(s["owner"]), group_kind=jnp.asarray(s["kinds"]),
        group_skew=jnp.asarray(s["skew"]), group_dom_key=jnp.asarray(s["dom_key"]),
        group_min_domains=jnp.asarray(s["min_domains"]), group_registered=jnp.asarray(s["registered"]),
        counts_dom_init=jnp.asarray(s["counts_dom"]), counts_host_init=jnp.asarray(s["counts_host"]),
        existing_domset=jnp.asarray(s["ex_dom"]), existing_port_any=jnp.asarray(ex_ports),
        existing_port_wild=jnp.asarray(ex_ports), existing_port_spec=jnp.asarray(ex_ports),
        row_port_any=jnp.asarray(P1), row_port_wild=jnp.asarray(P1), row_port_spec=jnp.asarray(P1),
        dom_keys=(2, -1), n_existing=s["n_ex"], n_slots=s["N"],
    )


def _port_tensors(s: dict):
    return chip_smoke.perpod_tensors(s, "cpu")


@pytest.mark.parametrize("seed", range(10))
def test_plain_scan_matches_reference_on_synthetic_tensors(seed):
    s = _synthetic(seed)
    want = [np.asarray(x) for x in jsm._greedy_pack_impl(_jax_tensors(s), (2, -1), s["N"])]
    t, pods = _port_tensors(s)
    build.reset_launches()
    got = tsm.greedy_pack(t, pods)
    assert all(v == 0 for v in build.LAUNCHES.values())
    _assert_outputs(got, want, f"seed {seed}")


def test_synthetic_cases_reach_the_scan_corners():
    """Across the seeds: unplaced pods, a full slot axis, tied best rows
    (rows 5-8 are identical: only row 5 may back a slot) and commits with no
    costed domain (z_star = 0) all occur."""
    unplaced = full = ties = sentinel = 0
    for seed in range(10):
        s = _synthetic(seed)
        t, pods = _port_tensors(s)
        a, basis, _dom, _rank, open_count, *_ = tsm.greedy_pack(t, pods)
        unplaced += int((a < 0).sum())
        full += int(open_count) == s["N"]
        assert not ((basis >= 6) & (basis <= 8)).any()
        ties += int((basis == 5).any())
        _, dm, kmask = tsm.group_feasibility(t, pods.member)
        spread = (pods.member & (t.group_kind == 0)).any(dim=1)
        no_key_dom = ~(pods.pod_dom_allowed & kmask).any(dim=1)
        sentinel += int((dm & spread & no_key_dom & (a >= 0)).sum())
    assert unplaced and full and ties and sentinel
    # K8's warp path (at most WARP_REACH open slots) and the block's past it:
    # open-slot counts on both sides, the switch, and on each side a pod that
    # opens a slot right after a pod that took an open one
    reach = perpod_pack_module.WARP_REACH
    firsts, lasts, after = [], [], set()
    for seed, n_ex, N, P in chip_smoke.PERPOD_REGIME_CASES.values():
        t, pods = _port_tensors(chip_smoke.perpod_regime_arrays(seed, n_ex, N, P))
        a = tsm.greedy_pack(t, pods)[0].numpy()
        seen, opened = chip_smoke.open_before(a, n_ex)
        firsts.append(int(seen[0]))
        lasts.append(int(seen[-1]))
        took = (a >= 0) & ~opened
        after |= {bool(seen[i] > reach) for i in range(1, len(a)) if opened[i] and took[i - 1]}
    assert any(x <= reach for x in lasts) and any(x > reach for x in firsts)
    assert any(f <= reach < x for f, x in zip(firsts, lasts)) and reach in firsts
    assert after == {False, True}


@pytest.mark.parametrize("case", sorted(chip_smoke.PERPOD_REGIME_CASES))
def test_plain_scan_matches_reference_across_the_warp_reach(case):
    """The plain scan against JAX on the synthetic problems whose open-slot
    counts stay below, cross and start past K8's warp path reach."""
    s = chip_smoke.perpod_regime_arrays(*chip_smoke.PERPOD_REGIME_CASES[case])
    want = [np.asarray(x) for x in jsm._greedy_pack_impl(_jax_tensors(s), (2, -1), s["N"])]
    t, pods = _port_tensors(s)
    got = tsm.greedy_pack(t, pods)
    _assert_outputs(got, want, case)


def test_warp_reach_is_the_kernels():
    """The wrapper's WARP_REACH (which the synthetic cases cross) is the
    one the CUDA source defines."""
    src = (Path(perpod_pack_module.__file__).parent / "csrc" / "perpod_pack.cu").read_text()
    assert re.search(r"^#define WARP_REACH (\d+)", src, re.M).group(1) == str(perpod_pack_module.WARP_REACH)


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    s = _synthetic(0)
    t, pods = _port_tensors(s)
    compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    build.reset_launches()
    out = perpod_pack(t, pods, compat, key)
    assert len(out) == 8 and all(v == 0 for v in build.LAUNCHES.values())
    meta = tsm.PodTensors(**{k: v.to("meta") for k, v in vars(pods).items()})
    with pytest.raises(ValueError):
        perpod_pack(t, meta, compat, key)
    with pytest.raises(ValueError):
        compat_and_key(t, meta.pod_mask, meta.pod_taint_ok, meta.pod_req)


def test_entry_needs_cuda_unless_asked_for_cpu(monkeypatch):
    problem, _ref = load_npz(FIXTURE_DIR / "small_multigroup.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsm.greedy_pack_encoded(problem)


# -- the fixtures -----------------------------------------------------------------------


def _stored(name: str) -> dict:
    with np.load(PERPOD_DIR / f"{name}.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _stored_outputs(ref: dict) -> list:
    return [ref[f"ref_{k}"] for k in OUTPUTS]


@pytest.mark.parametrize("name", SMALL)
def test_small_fixture_matches_reference_live(name):
    """The JAX per-pod pack and the port's (plain, from `from_reference`)
    give the same five outputs and the same validation errors; the stored
    file holds the same outputs and errors."""
    enc = _encode(name)
    want, want_errors = reference_perpod(enc)
    p = from_reference(enc)
    tsm.reset_bucket_highwater()
    got = tsm.greedy_pack_encoded(p, device="cpu")
    _assert_outputs(got, want, name)
    assert fast_validate(p, *(x.numpy() for x in got[:3])) == want_errors
    ref = _stored(name)
    _assert_outputs(_stored_outputs(ref), want, f"{name} stored")
    stored_problem, _ = load_npz(FIXTURE_DIR / f"{name}.npz")
    assert list(ref["ref_errors"]) == _rekey(want_errors, p.pod_keys, stored_problem.pod_keys)


@pytest.mark.parametrize("name", HEADLINES)
def test_headline_matches_stored_reference(name):
    """The port's plain per-pod pack at the 5000-pod headlines equals the
    stored JAX outputs, and its validation errors the reference's (0 and
    12, capped, in the affinity variant: the scan ignores required
    affinity)."""
    problem, _ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    ref = _stored(name)
    assert str(ref["problem"]) == f"{name}.npz" and int(ref["n_pods"]) == problem.n_pods
    tsm.reset_bucket_highwater()
    got = tsm.greedy_pack_encoded(problem, device="cpu")
    _assert_outputs(got, _stored_outputs(ref), name)
    errors = fast_validate(problem, *(x.numpy() for x in got[:3]))
    assert errors == list(ref["ref_errors"])
    assert len(errors) == {"headline_5000x100": 0, "headline_aff_5000x100": 12}[name]


def _rekey(errors: list, keys: list, to_keys: list) -> list:
    """Validation errors with the pods named as in another copy of the same
    problem (pod names come from a process-global counter)."""
    ren = dict(zip(keys, to_keys))
    return [re.sub(r"^pod (\S+):", lambda m: f"pod {ren[m.group(1)]}:", e) for e in errors]


@pytest.mark.slow
@pytest.mark.parametrize("name", HEADLINES)
def test_headline_fixture_matches_fresh_reference(name):
    """The stored headline outputs equal a fresh JAX encode and pack."""
    enc = _encode(name)
    want, want_errors = reference_perpod(enc)
    ref = _stored(name)
    _assert_outputs(_stored_outputs(ref), want, name)
    stored_problem, _ = load_npz(FIXTURE_DIR / f"{name}.npz")
    assert list(ref["ref_errors"]) == _rekey(want_errors, [p.key() for p in enc.pods], stored_problem.pod_keys)


def write_all(names=None) -> None:
    """Write `fixtures/perpod/<name>.npz` for the named corpus entries (all
    of them by default). The problem files are read, never written: each
    fresh encode must equal its stored problem."""
    from karpenter_tpu_torch.solver.encoded import problem_arrays

    jax.config.update("jax_platforms", "cpu")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    PERPOD_DIR.mkdir(parents=True, exist_ok=True)
    for name in CORPUS:
        if names and name not in names:
            continue
        enc = _encode(name)
        p = from_reference(enc)
        stored, _ = load_npz(FIXTURE_DIR / f"{name}.npz")
        fresh, kept = problem_arrays(p), problem_arrays(stored)
        for key in fresh:
            if key != "pod_keys":
                np.testing.assert_array_equal(fresh[key], kept[key], err_msg=f"{name}: {key}")
        out, errors = reference_perpod(enc)
        ref = {f"ref_{k}": np.asarray(v) for k, v in zip(OUTPUTS, out)}
        ref["ref_errors"] = np.asarray(_rekey(errors, p.pod_keys, stored.pod_keys), dtype=np.str_).reshape(-1)
        np.savez_compressed(PERPOD_DIR / f"{name}.npz", problem=np.str_(f"{name}.npz"), n_pods=np.int64(p.n_pods),
                            ref_n_slots=np.int64(out[1].shape[0]), **ref)
        print(name, p.n_pods, "pods", int((out[0] >= 0).sum()), "placed", int(out[4]), "open", len(errors), "errors",
              file=sys.stderr)


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_all([a for a in sys.argv[1:] if a != "--write"])
    else:
        print(__doc__)
