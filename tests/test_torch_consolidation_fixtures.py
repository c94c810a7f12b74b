"""Consolidation fixtures of the PyTorch port: encoder outputs with the JAX
proposers' outputs.

Each `karpenter_tpu_torch/fixtures/consolidation/<name>.npz` holds a
`ConsolidationProblem` (the reference's `_candidate_vectors` dict, written
by `save_npz`) and, under `ref_*`, what the JAX package made of it:

* the padded tensors of `encode_candidates_lp` (`ref_t_*`, `ref_aux_*`);
* for the LP and global proposers (`kind` "lp" / "global"): the random
  inits replayed from `jax.random.PRNGKey(seed)` with the reference's own
  splits (`ref_d0` [C, Np], `ref_y0` [C, Q, N]: only the real classes and
  nodes, the projection zeroes the rest), the relaxed repack's d and scores
  after 1, 5 and `LP_ITERS` steps, the rounded rows `ref_X` with their
  scores and feasibility flags, the proposals, and for the global proposer
  its `info`;
* for the anneal proposer (`kind` "anneal"): the streams `ref_x0`,
  `ref_flips`, `ref_u` and the chains' `ref_best_x` / `ref_best_s`, and the
  proposals.

The fleets: `bench._build_consolidation_fleet(5000)` (the LP proposer at
the 5000-node target), the same with `hetero_prices=True` (the global
proposer) without and with 200 pending pods, the 256-node fleet of
`bench_consolidation` (the anneal arm), and the small fleets of
`tests/test_consolidation_tpu.build_fleet` (4, 6 and 7 nodes, each through
all three proposers, and 6 nodes with 3 pending pods). The small fixtures
are rebuilt and compared on every run; the 5000-node fleets take about 93 s
each to build on the CPU, so their rebuild is the `slow` test. Regenerate
with

    JAX_PLATFORMS=cpu python tests/test_torch_consolidation_fixtures.py --write [name ...]
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from karpenter_tpu_torch.solver.consolidation import ConsolidationProblem, load_npz, save_npz  # noqa: E402

CONS_DIR = Path(__file__).resolve().parents[1] / "karpenter_tpu_torch" / "fixtures" / "consolidation"
T_FIELDS = ("node_price", "node_cost", "node_slack", "node_used", "node_npods", "pod_compat", "row_alloc", "row_price")
AUX_FIELDS = ("onehot", "compat_nq", "pend_mass", "pend_weight", "pend_active", "pend_req", "pend_npods")
SEED = 0
# a proposer seed other than SEED: `lp_300_near_tie` is the first of seeds
# 0-29 on the 300-node hetero fleet whose JAX d has two real nodes within
# 1e-6 of each other at a rounding cut or prefix boundary (init 6: nodes 39
# and 239, 3.6e-7 apart, at the top-2 prefix)
SEEDS = {"lp_300_near_tie": 4}
# The reference's other XLA:CPU setting: single-threaded Eigen contractions.
# Its float32 sums then run in another order; a fixture's `alt/<name>.npz`
# holds the d (after 1 and 5 steps and the last) and the proposals of the
# same JAX run under it, to show where the reference defines d to within
# float32 noise and where it does not.
ALT_FLAG = "--xla_cpu_multi_thread_eigen=false"
ALT_DIR = CONS_DIR / "alt"
ALT_KEYS = {"ref_alt_d_it1": "ref_d_it1", "ref_alt_d_it5": "ref_d_it5", "ref_alt_d": "ref_d",
            "ref_alt_proposals": "ref_proposals", "ref_alt_proposal_lens": "ref_proposal_lens"}


# -- fleets --------------------------------------------------------------------

def _round_of(env):
    """(candidates, instance types, pending pods) of one consolidation round,
    the way `MultiNodeConsolidation` gathers them."""
    from karpenter_tpu.controllers.disruption.methods import MultiNodeConsolidation

    ctx = env.disruption.ctx
    cands = env.disruption.get_candidates()
    ctx.round_candidates = cands
    ctx.node_pool_totals = None
    m = MultiNodeConsolidation(ctx)
    pending = env.provisioner.get_pending_pods()
    return cands, m._candidate_instance_types(cands), pending


def _small_fleet(n: int, n_pending: int = 0):
    from helpers import make_pod
    from test_consolidation_lp import flip_consolidatable
    from test_consolidation_tpu import build_fleet

    env = build_fleet(n, solver_backend="tpu")
    flip_consolidatable(env)
    for i in range(n_pending):
        env.store.create(make_pod(cpu="300m", name=f"gp-pend-{i}"))
    return _round_of(env)


def _bench_fleet(n: int, hetero: bool = False, with_pending: bool = False):
    import bench
    from helpers import make_pod

    cands, its, pending = _round_of(bench._build_consolidation_fleet(n, hetero_prices=hetero))
    if with_pending:
        pending = ([make_pod(cpu="300m", name=f"pend-a{i}") for i in range(100)]
                   + [make_pod(cpu="1", name=f"pend-b{i}") for i in range(60)]
                   + [make_pod(memory="2Gi", name=f"pend-c{i}") for i in range(40)])
    return cands, its, pending


def _anneal_fleet(n: int):
    """The fleet of `bench.bench_consolidation`: one 500m pod per node via
    hostname anti-affinity, then swapped for unconstrained pods; its
    instance types are the provider's whole catalog, as the bench passes."""
    from helpers import hostname_anti_affinity, make_nodepool, make_pod
    from karpenter_tpu.apis import labels as wk
    from karpenter_tpu.apis.nodepool import Budget
    from karpenter_tpu.operator import Environment

    env = Environment()
    np_ = make_nodepool(requirements=[
        {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
        {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
        {"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [wk.CAPACITY_TYPE_ON_DEMAND]},
    ])
    np_.spec.disruption.consolidate_after = "30s"
    np_.spec.disruption.budgets = [Budget(nodes="100%")]
    env.store.create(np_)
    sel = {"matchLabels": {"app": "x"}}
    pods = [make_pod(cpu="500m", name=f"s{i}", labels={"app": "x"}, anti_affinity=[hostname_anti_affinity(sel)])
            for i in range(n)]
    for p in pods:
        env.store.create(p)
    env.settle()
    for p in pods:
        env.store.delete("Pod", p.metadata.name)
    for i in range(n):
        env.store.create(make_pod(cpu="500m", name=f"f{i}"))
    env.settle(rounds=4)
    env.clock.step(40)
    env.nodeclaim_disruption.reconcile()
    return env.disruption.get_candidates(), env.cloud_provider.get_instance_types(), []


# name -> (fleet builder, proposer kind); builders are called with no arguments
FLEETS = {
    "small_4": lambda: _small_fleet(4),
    "small_6": lambda: _small_fleet(6),
    "small_7": lambda: _small_fleet(7),
    "small_6_pending": lambda: _small_fleet(6, n_pending=3),
    "bench_5000": lambda: _bench_fleet(5000),
    "bench_5000_hetero": lambda: _bench_fleet(5000, hetero=True),
    "bench_5000_hetero_pending": lambda: _bench_fleet(5000, hetero=True, with_pending=True),
    "bench_256": lambda: _anneal_fleet(256),
    "bench_300_hetero": lambda: _bench_fleet(300, hetero=True),
}
CORPUS = {
    "small_lp_4": ("small_4", "lp"),
    "small_global_4": ("small_4", "global"),
    "small_anneal_4": ("small_4", "anneal"),
    "small_lp_6": ("small_6", "lp"),
    "small_global_6": ("small_6", "global"),
    "small_anneal_6": ("small_6", "anneal"),
    "small_lp_7": ("small_7", "lp"),
    "small_global_7": ("small_7", "global"),
    "small_anneal_7": ("small_7", "anneal"),
    "small_global_6_pending": ("small_6_pending", "global"),
    "lp_5000": ("bench_5000", "lp"),
    "global_5000_hetero": ("bench_5000_hetero", "global"),
    "global_5000_hetero_pending": ("bench_5000_hetero_pending", "global"),
    "anneal_256": ("bench_256", "anneal"),
    "lp_300_near_tie": ("bench_300_hetero", "lp"),
}
SMALL = sorted(n for n in CORPUS if n.startswith("small_"))
LARGE = sorted(n for n in CORPUS if not n.startswith("small_"))


# -- the reference's random draws, replayed -------------------------------------

def gp_inits(key, n_inits: int, N: int, Q: int):
    """(d0 [C, N], y0 [C, Q, N]) exactly as `_globalpack_impl.one_init` draws them."""
    import jax
    import jax.random as jr

    def one(k):
        k_d, k_y = jr.split(k)
        return jr.uniform(k_d, (N,), minval=0.05, maxval=0.95), jr.uniform(k_y, (Q, N), minval=0.1, maxval=1.0)

    d0, y0 = jax.vmap(one)(jr.split(key, n_inits))
    return np.asarray(d0), np.asarray(y0)


def anneal_streams(key, n_chains: int, n_steps: int, N: int):
    """(x0 [C, N] bool, flips [C, S] int32, u [C, S] f32) exactly as
    `anneal_chains.chain` draws them."""
    import jax
    import jax.random as jr

    def chain(k):
        k_init, k_loop = jr.split(k)
        x0 = jr.bernoulli(k_init, 0.3, (N,))

        def step(key, _):
            key, k1, k2 = jr.split(key, 3)
            return key, (jr.randint(k1, (), 0, N), jr.uniform(k2))

        _, (flips, u) = jax.lax.scan(step, k_loop, None, length=n_steps)
        return x0, flips, u

    x0, flips, u = jax.jit(jax.vmap(chain))(jr.split(key, n_chains))
    return np.asarray(x0), np.asarray(flips).astype(np.int32), np.asarray(u)


# -- one fixture ------------------------------------------------------------------

def _proposal_arrays(out) -> dict:
    return dict(ref_proposals=np.asarray([i for s in out for i in s], dtype=np.int64),
                ref_proposal_lens=np.asarray([len(s) for s in out], dtype=np.int64))


def reference_run(kind: str, cands, its, pending, seed: int = SEED) -> tuple[ConsolidationProblem, dict]:
    """Run the JAX proposer of `kind` on one round, recording its encoder
    output, its padded tensors, its draws and every intermediate output."""
    import jax

    import karpenter_tpu.models.consolidation_model as jcm
    import karpenter_tpu.models.globalpack as jgp
    import karpenter_tpu.solver.consolidation as jcons

    seen: dict = {}
    real_vectors, real_encode = jcons._candidate_vectors, jcons.encode_candidates_lp
    real_repack, real_score, real_anneal = jgp.global_repack, jgp.score_subsets_global, jcm.anneal

    def vectors(*a, **k):
        seen["v"] = real_vectors(*a, **k)
        return seen["v"]

    def encode(*a, **k):
        seen["enc"] = real_encode(*a, **k)
        return seen["enc"]

    def repack(t, onehot, compat_qn, pend_mass, pend_weight, key, n_inits=8, n_iters=300):
        out = real_repack(t, onehot, compat_qn, pend_mass, pend_weight, key, n_inits=n_inits, n_iters=n_iters)
        seen["repack"] = (t, onehot, compat_qn, pend_mass, pend_weight, key, n_inits, n_iters, out)
        return out

    def score(t, onehot, compat_nq, pend_req, pend_npods, pend_active, X):
        out = real_score(t, onehot, compat_nq, pend_req, pend_npods, pend_active, X)
        seen["score"] = (np.asarray(X), *out)
        return out

    def anneal(t, key, n_chains=64, n_steps=512):
        out = real_anneal(t, key, n_chains=n_chains, n_steps=n_steps)
        seen["anneal"] = (key, n_chains, n_steps, out)
        return out

    with mock.patch.object(jcons, "_candidate_vectors", vectors), mock.patch.object(jcons, "encode_candidates_lp", encode), \
            mock.patch.object(jgp, "global_repack", repack), mock.patch.object(jgp, "score_subsets_global", score), \
            mock.patch.object(jcm, "anneal", anneal):
        if kind == "lp":
            out = jcons.propose_subsets_lp(cands, its, seed=seed)
        elif kind == "global":
            out, info = jcons.propose_subsets_global(cands, its, pending_pods=pending, seed=seed)
        else:
            out = jcons.propose_subsets(cands, its, seed=seed)
    problem = ConsolidationProblem.from_reference(seen["v"])
    t, aux = seen["enc"]
    ref = {"kind": np.str_(kind), "seed": np.int64(seed)}
    for f in T_FIELDS:
        if f != "pod_compat" or kind == "anneal":
            ref[f"ref_t_{f}"] = np.asarray(getattr(t, f))
    for f in AUX_FIELDS:
        ref[f"ref_aux_{f}"] = np.asarray(aux[f])
    ref.update(_proposal_arrays(out))
    N, Q = problem.n, problem.n_classes
    if kind == "anneal":
        key, n_chains, n_steps, (best_x, best_s) = seen["anneal"]
        x0, flips, u = anneal_streams(key, n_chains, n_steps, t.node_price.shape[0])
        ref.update(ref_x0=x0, ref_flips=flips, ref_u=u, ref_best_x=np.asarray(best_x), ref_best_s=np.asarray(best_s))
        return problem, ref
    t, onehot, compat_qn, pend_mass, pend_weight, key, n_inits, n_iters, (d, lp_score) = seen["repack"]
    d0, y0 = gp_inits(key, n_inits, t.node_price.shape[0], onehot.shape[1])
    keys = jax.random.split(key, n_inits)
    for it in (1, 5):
        d_it, s_it = jgp._globalpack_impl(t, onehot, compat_qn, pend_mass, pend_weight, keys, it)
        ref[f"ref_d_it{it}"], ref[f"ref_score_it{it}"] = np.asarray(d_it), np.asarray(s_it)
    d_0, _ = jgp._globalpack_impl(t, onehot, compat_qn, pend_mass, pend_weight, keys, 0)
    assert np.array_equal(np.asarray(d_0), d0), "the replayed d0 is not the reference's"
    X, scores, feas = seen["score"]
    ref.update(ref_d0=d0, ref_y0=y0[:, :Q, :N], ref_d=np.asarray(d), ref_lp_score=np.asarray(lp_score),
               ref_n_iters=np.int64(n_iters), ref_X=X, ref_scores=np.asarray(scores), ref_feas=np.asarray(feas))
    if kind == "global":
        ref.update(ref_info_objective_improvement=np.float64(info["objective_improvement"]),
                   ref_info_rounded=np.int64(info["rounded"]))
    return problem, ref


def alt_env() -> dict:
    """The environment of a reference run under the other setting: the
    XLA_FLAGS that tests/conftest.py sets, with ALT_FLAG appended."""
    import conftest  # noqa: F401  (sets XLA_FLAGS and the solver switches, once)

    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + ALT_FLAG).strip()
    env["JAX_PLATFORMS"] = "cpu"
    return env


def alt_run(src, out) -> None:
    """Re-run the JAX proposer of a stored lp or global fixture (`src`) on its
    own encoder output and seed, in this process, and write the ALT_KEYS
    arrays to `out`. XLA reads its flags when the backend starts, so the
    caller runs this in a process started with `alt_env()`."""
    import jax

    import karpenter_tpu.solver.consolidation as jcons

    jax.config.update("jax_platforms", "cpu")
    problem, ref = load_npz(src)
    v = {k: a for k, a in problem.arrays().items()}
    v["n_classes"], v["pend_npods"] = problem.n_classes, problem.pend_npods
    with mock.patch.object(jcons, "_candidate_vectors", lambda *a, **k: v):
        _p, run = reference_run(str(ref["kind"]), list(range(problem.n)), [], [], int(ref["seed"]))
    np.savez_compressed(out, **{k: run[key] for k, key in ALT_KEYS.items()})


def run_alt(src, out) -> None:
    """`alt_run(src, out)` in a process of its own under the other setting."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--alt-run", str(src), str(out)], env=alt_env(),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"alternate reference run of {src} failed:\n{res.stderr[-4000:]}")


def alt_names() -> list[str]:
    """The corpus fixtures with a d (the LP and global proposers')."""
    return sorted(n for n, (_fleet, kind) in CORPUS.items() if kind != "anneal")


def write_alt(names=None) -> None:
    """Write `alt/<name>.npz` for the stored lp and global fixtures (one
    process each, four at a time)."""
    from concurrent.futures import ThreadPoolExecutor

    ALT_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in alt_names() if not names or n in names]
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda n: run_alt(CONS_DIR / f"{n}.npz", ALT_DIR / f"{n}.npz"), todo))
    for n in todo:
        print(n, "alternate setting written", file=sys.stderr)


def build_fixtures(names) -> dict:
    """{name: (problem, ref)} built from scratch, one fleet build per fleet."""
    from karpenter_tpu.models.scheduler_model import reset_bucket_highwater

    out = {}
    by_fleet: dict = {}
    for name in names:
        by_fleet.setdefault(CORPUS[name][0], []).append(name)
    for fleet, members in by_fleet.items():
        reset_bucket_highwater()
        cands, its, pending = FLEETS[fleet]()
        for name in members:
            out[name] = reference_run(CORPUS[name][1], cands, its, pending, SEEDS.get(name, SEED))
    return out


def write_all(names=None) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    CONS_DIR.mkdir(parents=True, exist_ok=True)
    for name, (problem, ref) in build_fixtures([n for n in CORPUS if not names or n in names]).items():
        save_npz(CONS_DIR / f"{name}.npz", problem, **ref)
        print(name, problem.n, "nodes", problem.n_classes, "classes", len(ref["ref_proposal_lens"]), "proposals",
              file=sys.stderr)
    write_alt(names)


def _assert_same(name: str, problem, ref) -> None:
    stored, stored_ref = load_npz(CONS_DIR / f"{name}.npz")
    fresh, kept = problem.arrays(), stored.arrays()
    for key in fresh:
        assert np.asarray(fresh[key]).dtype == np.asarray(kept[key]).dtype, key
        np.testing.assert_array_equal(fresh[key], kept[key], err_msg=f"{name}: {key}")
    assert set(ref) == set(stored_ref), name
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key]), stored_ref[key], err_msg=f"{name}: {key}")


@pytest.mark.parametrize("fleet", sorted({CORPUS[n][0] for n in SMALL}))
def test_small_fixtures_match_reference(fleet):
    """Each committed small fixture equals a fresh JAX run on a fresh fleet,
    array by array."""
    names = [n for n in SMALL if CORPUS[n][0] == fleet]
    for name, (problem, ref) in build_fixtures(names).items():
        _assert_same(name, problem, ref)


@pytest.mark.slow
def test_large_fixtures_match_reference():
    """The 5000-node and 256-node fixtures against fresh fleets and JAX runs
    (several minutes on the CPU: four fleet builds)."""
    for name, (problem, ref) in build_fixtures(LARGE).items():
        _assert_same(name, problem, ref)


def test_corpus_files_present():
    assert sorted(p.stem for p in CONS_DIR.glob("*.npz")) == sorted(CORPUS)
    assert sorted(p.stem for p in ALT_DIR.glob("*.npz")) == alt_names()


@pytest.mark.parametrize("name", alt_names())
def test_reference_settings_agree(name):
    """The reference's d after 1 and 5 steps and the last, and its proposals,
    are bit-equal under the default XLA:CPU setting and ALT_FLAG: on these
    rounds the reference defines d, and the D_TOL tests hold the port to it
    (the one round where the settings differ is `caps_lp`,
    tests/test_torch_axis_caps.py)."""
    _problem, ref = load_npz(CONS_DIR / f"{name}.npz")
    with np.load(ALT_DIR / f"{name}.npz", allow_pickle=False) as z:
        alt = {k: z[k] for k in z.files}
    assert set(alt) == set(ALT_KEYS)
    for k, key in ALT_KEYS.items():
        assert alt[k].dtype == ref[key].dtype, k
        np.testing.assert_array_equal(alt[k], ref[key], err_msg=f"{name}: {k}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_all([a for a in sys.argv[1:] if a != "--write"])
    elif "--write-alt" in sys.argv:
        write_alt([a for a in sys.argv[1:] if a != "--write-alt"])
    elif sys.argv[1:2] == ["--alt-run"]:
        alt_run(*sys.argv[2:4])
    else:
        print(__doc__)
