"""solverlint: repo-specific static analysis, aimed at the PyTorch port.

The tensor path's speed rests on invariants no general-purpose linter knows
about: `mask_encode`/`_try_delta_encode` share encode arrays BY REFERENCE
(one in-place write corrupts the cached delta base), the pack must never
host-sync mid-kernel (`.item()`, `.cpu()`, `.numpy()`, `.tolist()` or a
coercion of a kernel wrapper's output) or loop Python-side over the pod
axis, every fallback reason family must carry a hybrid tier (GLOBAL ones
justified), and solver metric labels must stay enum-bounded. The serving
stack's CORRECTNESS rests on lock conventions the same way: guarded fields,
a sanctioned lock order, reviewed thread seams, instrumentable primitives
(racecheck); its degradation on absorbed failures (faultline) and the
bit-identical placement on replayable inputs (detlint) too. This package
machine-checks all of it as 15 AST rules over the port's modules
(`config.Config`; a `[tool.solverlint-torch]` table in pyproject.toml
overrides them key by key — `[tool.solverlint]` is the JAX package's):

    python -m karpenter_tpu_torch.analysis              # nonzero exit on findings
    python -m karpenter_tpu_torch.analysis --self-test  # rule-discovery sanity gate

A finding is suppressed only by a justified pragma on (or directly above)
the offending line:

    # solverlint: ok(<rule-name>): <why this is sound>

Runtime counterparts: `karpenter_tpu_torch/solver/contracts.py` enforces the
encode-space shape/dtype contracts under KARPENTER_SOLVER_TYPECHECK=1 (the
tier-1 test run enables it), and `mask_encode` freezes reference-shared
arrays so mutations the linter misses raise instead of corrupting caches;
`karpenter_tpu_torch/obs/racecheck.py` enforces the concurrency contracts
under KARPENTER_SOLVER_RACECHECK=1 (also tier-1-wide) — dynamic lock-order
graph with raise-on-inversion, guarded-field owner checks, lock-wait
histogram.

Everything here is stdlib-only (ast + tomllib/tomli): the gate runs in a
few seconds (the cardinality rule parses the whole package) and never
imports torch/numpy.
"""

from .core import Finding, run_analysis, run_self_test  # noqa: F401
from .rules import RULES  # noqa: F401

__all__ = ["Finding", "run_analysis", "run_self_test", "RULES"]
