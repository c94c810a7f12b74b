"""The solverlint rules — this repo's real hazard classes, as AST passes.

1. shared-array-mutation     in-place writes to encode fields the registry
                             (encode.SHARED_ENCODE_FIELDS) declares shared by
                             reference between a base encode and its derived
                             masked/delta encodes.
2. host-sync-in-hot-path     `.item()` / `.cpu()` / `.numpy()` /
                             `.tolist()` / `float()`/`int()`/`bool()` /
                             `np.asarray` on values produced by device
                             kernels inside the tensor-path modules.
3. python-loop-over-pod-axis `for` statements iterating pod-scaled
                             collections in tensor modules (per-signature
                             loops and comprehensions doing O(1) attribute
                             reads are the sanctioned cheap pass).
4. reason-family-tiers       every fallback family carries a tier, GLOBAL
                             families justify themselves, no stale entries
                             (absorbed from tests/test_solve_modes.py).
5. metric-label-cardinality  label values for bounded label keys at
                             counter/histogram call sites must be statically
                             enumerable, and the repo-wide literal set per
                             key stays under a cap.

racecheck's static arm — the concurrency rules, scanning the
threaded serving stack (`thread_modules`):

6. guarded-field-access      classes on the threaded path declare a
                             GUARDED_FIELDS registry (field -> guarding lock
                             attr, like encode.SHARED_ENCODE_FIELDS); any
                             touch of a declared field outside a
                             `with self.<lock>` block is a finding. A
                             caller-holds helper carries the pragma on its
                             `def` line, which scopes the contract to the
                             whole method.
7. lock-order                the static lock-acquisition graph: nested
                             `with self.<lock>` blocks plus one level of
                             name-resolved method calls made while a lock is
                             held; any cycle is a potential deadlock, and any
                             blocking call (a solve, a device sync, the
                             store's watch-delivery `_drain`) under a held
                             lock is a finding.
8. thread-escape             `threading.Thread(target=...)`/`spawn_thread`
                             entry points and store-watch callbacks must be
                             in the declared thread-shared registry
                             (`[tool.solverlint-torch] thread-shared`) — every
                             object handed to another thread is a reviewed,
                             named seam; lambdas (invisible capture) are
                             flagged outright.
9. bare-thread-primitive     raw threading.Lock/RLock/Event/Thread/...
                             construction outside obs/racecheck.py — the
                             wrapper is what lets the runtime sanitizer
                             instrument every acquisition.

faultline's static arm:

10. swallowed-exception      broad `except Exception:` handlers that
                             neither re-raise nor record (an events publish
                             or metrics emission) — a serving stack only
                             degrades gracefully when every absorbed
                             failure leaves a signal; deliberate swallows
                             carry a justified pragma.

detlint's static arm — the determinism rules protecting the
bit-identical-placement contract (obs/detcheck.py is the runtime arm):

11. unordered-iteration-escape  iteration over a set/frozenset of
                             non-literal origin (or id()-keyed ordering)
                             landing in an ordered output — hash order
                             varies with PYTHONHASHSEED; sanctioned sites
                             use sorted(...) or a justified pragma.
12. wallclock-and-rng-in-solve-path  time.*/random/np.random/torch's
                             global RNG/uuid4/secrets
                             reachable from solve/encode/decode entry
                             points, outside the reviewed seeded-RNG
                             registry ([tool.solverlint-torch] seeded-rng).
13. float-reduction-order    host float accumulations over device-derived
                             or unordered operands not routed through a
                             canonical-order helper (fsum/stable_host_sum)
                             — protects mesh-N-vs-mesh-1 bit-parity.
14. env-dependent-branch     os.environ reads in solve-path modules
                             outside the registered KARPENTER_* knob table
                             ([tool.solverlint-torch] env-knobs).
15. stale-pragma             a suppression pragma that no longer
                             suppresses any finding (dead suppressions
                             rot; usage is tracked live during the scan).

Every rule ships SELF_TEST_BAD/SELF_TEST_OK snippets; `--self-test` proves
each rule still detects its seeded violation and that the pragma suppresses
it, so the gate fails loudly if rule discovery breaks.
"""

from __future__ import annotations

import ast

from .config import Config
from .core import Finding, ParsedModule, callee_matches, dotted_name

# lambdas are NOT a scope boundary here: they cannot contain assignments, so
# their bodies read the enclosing scope's names — scanning them in place is
# what lets the rules see a mutation/sync tucked into a sort key or callback
_SCOPE_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _walk_scope(node: ast.AST):
    """All nodes of one scope, not descending into nested functions."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _SCOPE_KINDS):
            stack.extend(ast.iter_child_nodes(n))


def _scopes(tree: ast.Module):
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _flat_targets(target: ast.AST):
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _flat_targets(elt)
    else:
        yield target


def _span(node: ast.AST) -> tuple[int, int]:
    return (node.lineno, getattr(node, "end_lineno", node.lineno) or node.lineno)


class Rule:
    name = ""
    description = ""
    SELF_TEST_BAD = ""
    SELF_TEST_OK = ""
    SELF_TEST_SHARED_FIELDS: frozenset | None = None
    # extra Config overrides applied while self-testing this rule (e.g. an
    # emptied thread-shared registry so the seeded escape is unsanctioned)
    SELF_TEST_CONFIG: dict = {}

    def globs(self, config: Config) -> tuple[str, ...]:
        return config.tensor_modules

    def check(self, mod: ParsedModule, config: Config, root) -> list[Finding]:  # pragma: no cover - interface
        raise NotImplementedError

    def finalize(self, config: Config) -> list[Finding]:
        return []

    def _finding(self, mod: ParsedModule, node: ast.AST, message: str) -> Finding:
        return Finding(self.name, mod.relpath, node.lineno, message, span=_span(node))


class SharedArrayMutationRule(Rule):
    name = "shared-array-mutation"
    description = "in-place write to an encode field shared by reference with derived encodes"
    # ndarray methods that mutate in place
    MUTATOR_METHODS = frozenset({"fill", "sort", "resize", "itemset", "partition", "byteswap"})
    # numpy free functions (last dotted segment) whose first argument is written
    MUTATOR_FUNCS = frozenset({"put", "copyto", "place", "putmask", "at"})

    SELF_TEST_SHARED_FIELDS = frozenset({"sig_req"})
    SELF_TEST_BAD = "def f(enc):\n    enc.sig_req[0] = 1.0\n"
    SELF_TEST_OK = (
        "def f(enc):\n"
        "    enc.sig_req[0] = 1.0  # solverlint: ok(shared-array-mutation): self-test snippet, never imported\n"
    )

    def check(self, mod, config, root):
        fields = config.resolve_shared_fields(root)
        findings: list[Finding] = []
        for scope in _scopes(mod.tree):
            # flow-insensitive alias pass: a bare name stands in for a shared
            # field only when EVERY simple assignment to it reads one
            kinds: dict[str, set[str]] = {}
            alias_field: dict[str, str] = {}
            for n in _walk_scope(scope):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                    if isinstance(n.value, ast.Attribute) and n.value.attr in fields:
                        kinds.setdefault(n.targets[0].id, set()).add("reg")
                        alias_field[n.targets[0].id] = n.value.attr
                    else:
                        kinds.setdefault(n.targets[0].id, set()).add("other")
                elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.For, ast.AugAssign)):
                    targets = n.targets if isinstance(n, ast.Assign) else [getattr(n, "target", None)]
                    for t in targets:
                        if t is not None:
                            for leaf in _flat_targets(t):
                                if isinstance(leaf, ast.Name):
                                    kinds.setdefault(leaf.id, set()).add("other")
            aliases = {name for name, ks in kinds.items() if ks == {"reg"}}

            def shared(node) -> str | None:
                if isinstance(node, ast.Attribute) and node.attr in fields:
                    return node.attr
                if isinstance(node, ast.Name) and node.id in aliases:
                    return alias_field[node.id]
                return None

            for n in _walk_scope(scope):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        for leaf in _flat_targets(t):
                            if isinstance(leaf, ast.Subscript) and (f := shared(leaf.value)):
                                findings.append(
                                    self._finding(mod, n, f"in-place write to shared encode array {f!r}")
                                )
                elif isinstance(n, ast.AugAssign):
                    target = n.target.value if isinstance(n.target, ast.Subscript) else n.target
                    if f := shared(target):
                        findings.append(
                            self._finding(mod, n, f"augmented in-place write to shared encode array {f!r}")
                        )
                elif isinstance(n, ast.Call):
                    func = n.func
                    if (
                        isinstance(func, ast.Attribute)
                        and func.attr in self.MUTATOR_METHODS
                        and (f := shared(func.value))
                    ):
                        findings.append(
                            self._finding(mod, n, f".{func.attr}() mutates shared encode array {f!r}")
                        )
                    elif (
                        dotted_name(func).rsplit(".", 1)[-1] in self.MUTATOR_FUNCS
                        and n.args
                        and (f := shared(n.args[0]))
                    ):
                        findings.append(
                            self._finding(mod, n, f"{dotted_name(func)}() writes into shared encode array {f!r}")
                        )
        return findings


class HostSyncRule(Rule):
    name = "host-sync-in-hot-path"
    description = "host coercion of a device-kernel result inside a tensor-path module"
    COERCERS = frozenset({"float", "int", "bool"})
    ARRAYERS = frozenset({"np.asarray", "np.array", "numpy.asarray", "numpy.array"})
    # torch's copies to the host: each waits for the device. The value each
    # returns is on the host, so a chain (`x.cpu().numpy()`) is one sync
    TO_HOST = frozenset({"cpu", "numpy", "tolist"})
    # shape/metadata reads are static, never a device sync
    EXEMPT_ATTRS = frozenset({"shape", "size", "ndim", "dtype"})

    SELF_TEST_BAD = (
        "def f(t, items):\n"
        "    takes = greedy_pack_grouped_sharded(t, items)\n"
        "    return float(takes)\n"
    )
    SELF_TEST_OK = (
        "def f(t, items):\n"
        "    takes = greedy_pack_grouped_sharded(t, items)\n"
        "    return float(takes)  # solverlint: ok(host-sync-in-hot-path): self-test snippet, never imported\n"
    )

    def check(self, mod, config, root):
        findings: list[Finding] = []
        for scope in _scopes(mod.tree):
            tainted: set[str] = set()
            # any-assignment taint + one fixed-point pass for name-to-name copies
            copies: list[tuple[str, str]] = []
            for n in _walk_scope(scope):
                if not isinstance(n, ast.Assign):
                    continue
                if isinstance(n.value, ast.Call) and callee_matches(n.value.func, config.device_producers):
                    for t in n.targets:
                        for leaf in _flat_targets(t):
                            if isinstance(leaf, ast.Name):
                                tainted.add(leaf.id)
                elif isinstance(n.value, ast.Name) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                    copies.append((n.targets[0].id, n.value.id))
            changed = True
            while changed:
                changed = False
                for dst, src in copies:
                    if src in tainted and dst not in tainted:
                        tainted.add(dst)
                        changed = True

            def device_expr(node) -> bool:
                # path-sensitive: a `.shape`/`.size`/... access prunes ONLY
                # its own subtree (a static metadata read), never the rest of
                # the expression — `float(takes.sum() / takes.shape[0])` is
                # still a sync on `takes.sum()`
                if isinstance(node, ast.Attribute) and node.attr in self.EXEMPT_ATTRS:
                    return False
                if isinstance(node, ast.Name):
                    return node.id in tainted
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr in self.TO_HOST:
                    return False  # already on the host: the copy is its own finding
                if isinstance(node, ast.Call) and callee_matches(node.func, config.device_producers):
                    return True
                return any(device_expr(child) for child in ast.iter_child_nodes(node))

            for n in _walk_scope(scope):
                if not isinstance(n, ast.Call):
                    continue
                func = n.func
                if isinstance(func, ast.Attribute) and func.attr == "item" and not n.args and device_expr(func.value):
                    findings.append(self._finding(mod, n, ".item() host-syncs a device value"))
                elif isinstance(func, ast.Attribute) and func.attr in self.TO_HOST and not n.args and device_expr(func.value):
                    findings.append(self._finding(mod, n, f".{func.attr}() copies a device value to host (blocking sync)"))
                elif (
                    isinstance(func, ast.Name)
                    and func.id in self.COERCERS
                    and len(n.args) == 1
                    and device_expr(n.args[0])
                ):
                    findings.append(
                        self._finding(mod, n, f"{func.id}() coerces a device value to host (blocking sync)")
                    )
                elif dotted_name(func) in self.ARRAYERS and n.args and device_expr(n.args[0]):
                    findings.append(
                        self._finding(mod, n, f"{dotted_name(func)}() lands a device array on host")
                    )
        return findings


class PodAxisLoopRule(Rule):
    name = "python-loop-over-pod-axis"
    description = "Python-level `for` statement iterating a pod-scaled collection in a tensor module"

    # seeded on the decode-materialization shape: grouping pods into slots by
    # walking the pod axis in Python is exactly the O(pods) host tail the
    # decode-delta memo + columnar gather removed (bad_decode_loop /
    # ok_decode_columnar in the fixture file carry the full pair)
    SELF_TEST_BAD = (
        "def decode(enc, assignment):\n"
        "    slots = {}\n"
        "    for i, p in enumerate(enc.pods):\n"
        "        slots.setdefault(assignment[i], []).append(p)\n"
        "    return slots\n"
    )
    SELF_TEST_OK = (
        "def decode(enc, assignment):\n"
        "    slots = {}\n"
        "    for i, p in enumerate(enc.pods):  # solverlint: ok(python-loop-over-pod-axis): self-test snippet, never imported\n"
        "        slots.setdefault(assignment[i], []).append(p)\n"
        "    return slots\n"
    )

    def check(self, mod, config, root):
        names = set(config.pod_axis_names)
        findings: list[Finding] = []
        for n in ast.walk(mod.tree):
            if not isinstance(n, (ast.For, ast.AsyncFor)):
                continue
            hit = None
            for sub in ast.walk(n.iter):
                if isinstance(sub, ast.Name) and sub.id in names:
                    hit = sub.id
                elif isinstance(sub, ast.Attribute) and sub.attr in names:
                    hit = dotted_name(sub) or sub.attr
                if hit:
                    break
            if hit:
                findings.append(
                    Finding(
                        self.name,
                        mod.relpath,
                        n.lineno,
                        f"Python loop over pod-scaled {hit!r} — vectorize, or justify with a pragma",
                        span=(n.lineno, n.iter.end_lineno or n.lineno),
                    )
                )
        return findings


class ReasonFamilyTiersRule(Rule):
    name = "reason-family-tiers"
    description = "fallback families must carry tiers; GLOBAL families must justify themselves"

    SELF_TEST_BAD = (
        'GLOBAL = "global"\n'
        'POD_LOCAL = "pod-local"\n'
        'REASON_FAMILIES = (("needle a", "fam-a"), ("needle b", "fam-b"))\n'
        "FAMILY_TIERS = {\n"
        '    "fam-a": GLOBAL,\n'
        '    "other": GLOBAL,\n'
        "}\n"
    )
    SELF_TEST_OK = (
        'GLOBAL = "global"\n'
        'POD_LOCAL = "pod-local"\n'
        'REASON_FAMILIES = (("needle a", "fam-a"), ("needle b", "fam-b"))\n'
        "FAMILY_TIERS = {\n"
        "    # the kernel cannot express this family's semantics\n"
        '    "fam-a": GLOBAL,\n'
        '    "fam-b": POD_LOCAL,\n'
        '    "other": GLOBAL,  # unattributable reasons take the conservative path\n'
        "}\n"
    )

    def globs(self, config):
        return (config.fallback_module,)

    def check(self, mod, config, root):
        findings: list[Finding] = []
        families: list[tuple[str, int]] | None = None
        tiers: ast.Dict | None = None
        for n in mod.tree.body:
            target = None
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                target = n.targets[0].id
            elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
                target = n.target.id
            if target == "REASON_FAMILIES" and isinstance(n.value, (ast.Tuple, ast.List)):
                families = []
                for elt in n.value.elts:
                    if (
                        isinstance(elt, (ast.Tuple, ast.List))
                        and len(elt.elts) == 2
                        and isinstance(elt.elts[1], ast.Constant)
                    ):
                        families.append((elt.elts[1].value, elt.lineno))
                    else:
                        findings.append(self._finding(mod, elt, "REASON_FAMILIES entry is not a (needle, family) pair"))
            elif target == "FAMILY_TIERS" and isinstance(n.value, ast.Dict):
                tiers = n.value
        if families is None or tiers is None:
            findings.append(
                Finding(self.name, mod.relpath, 1, "REASON_FAMILIES / FAMILY_TIERS registry not found in module")
            )
            return findings

        entries: list[tuple[str, int, ast.AST]] = []
        for key, value in zip(tiers.keys, tiers.values):
            if not isinstance(key, ast.Constant) or not isinstance(key.value, str):
                findings.append(self._finding(mod, key or tiers, "FAMILY_TIERS key is not a string literal"))
                continue
            entries.append((key.value, key.lineno, value))
            if not (isinstance(value, ast.Name) and value.id in ("GLOBAL", "POD_LOCAL")):
                findings.append(
                    self._finding(mod, value, f"tier for {key.value!r} must be the GLOBAL or POD_LOCAL constant")
                )
        keys = {k for k, _l, _v in entries}
        enum = {fam for fam, _l in families}
        for fam, line in families:
            if fam not in keys:
                findings.append(Finding(self.name, mod.relpath, line, f"family {fam!r} has no tier in FAMILY_TIERS"))
        if "other" not in keys:
            findings.append(
                Finding(self.name, mod.relpath, tiers.lineno, 'FAMILY_TIERS lacks the "other" conservative entry')
            )
        for key, line, _v in entries:
            if key not in enum and key != "other":
                findings.append(
                    Finding(self.name, mod.relpath, line, f"stale tier entry {key!r}: no such family in REASON_FAMILIES")
                )

        # every GLOBAL entry justifies itself: a trailing comment on the
        # entry, or a comment block heading its contiguous GLOBAL run
        global_lines = {
            line for _k, line, v in entries if isinstance(v, ast.Name) and v.id == "GLOBAL"
        }
        for key, line, value in entries:
            if not (isinstance(value, ast.Name) and value.id == "GLOBAL"):
                continue
            text = mod.lines[line - 1] if line - 1 < len(mod.lines) else ""
            tail = text[value.end_col_offset:] if value.end_lineno == line else ""
            if "#" in tail:
                continue
            j = line - 2  # 0-based index of the line above
            while j >= 0 and (j + 1) in global_lines:
                j -= 1
            if j >= 0 and mod.lines[j].lstrip().startswith("#"):
                continue
            findings.append(
                Finding(
                    self.name,
                    mod.relpath,
                    line,
                    f"GLOBAL family {key!r} lacks a one-line justification comment",
                )
            )
        return findings


class MetricLabelCardinalityRule(Rule):
    name = "metric-label-cardinality"
    description = "bounded metric labels must carry statically enumerable values"
    _ITER_WRAPPERS = frozenset({"sorted", "set", "list", "tuple"})

    # the seeded violation is a decode-delta one: the decode counter's `mode`
    # label fed a runtime trace-attribution value instead of the two-literal
    # {full | delta-reuse} enum the decode itself branches on — exactly the
    # cardinality leak a future decode mode added without a literal at the
    # call site would regress into
    SELF_TEST_BAD = (
        "def publish(registry, trace):\n"
        '    registry.counter("karpenter_solver_decode_total").inc(mode=trace.attribution["decode_mode"])\n'
    )
    SELF_TEST_OK = (
        "def publish(registry, reused_slots):\n"
        '    registry.counter("karpenter_solver_decode_total").inc(mode="delta-reuse" if reused_slots else "full")\n'
    )

    def __init__(self):
        # label -> value -> first (path, line) seen, for the repo-wide cap
        self._literals: dict[str, dict[str, tuple[str, int]]] = {}

    def globs(self, config):
        return config.metrics_modules

    def check(self, mod, config, root):
        findings: list[Finding] = []
        bounded_labels = set(config.bounded_labels)
        wrappers = set(config.metric_wrappers)

        # (call, enclosing scope, enclosing function name)
        stack: list[tuple[ast.AST, ast.AST, str]] = [(mod.tree, mod.tree, "")]
        calls: list[tuple[ast.Call, ast.AST, str]] = []
        while stack:
            node, scope, fname = stack.pop()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    stack.append((child, child, child.name))
                else:
                    if isinstance(child, ast.Call):
                        calls.append((child, scope, fname))
                    stack.append((child, scope, fname))

        bindings_cache: dict[int, dict[str, list]] = {}

        def bindings(scope) -> dict[str, list]:
            cached = bindings_cache.get(id(scope))
            if cached is not None:
                return cached
            b: dict[str, list] = {}
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = scope.args
                for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs, a.vararg, a.kwarg]:
                    if arg is not None:
                        b.setdefault(arg.arg, []).append(("opaque", None))
            for n in _walk_scope(scope):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                    b.setdefault(n.targets[0].id, []).append(("expr", n.value))
                elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name) and n.value is not None:
                    b.setdefault(n.target.id, []).append(("expr", n.value))
                elif isinstance(n, (ast.For, ast.AsyncFor)):
                    for leaf in _flat_targets(n.target):
                        if isinstance(leaf, ast.Name):
                            b.setdefault(leaf.id, []).append(("for", n.iter))
                elif isinstance(n, (ast.Assign, ast.AugAssign)):
                    targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                    for t in targets:
                        for leaf in _flat_targets(t):
                            if isinstance(leaf, ast.Name):
                                b.setdefault(leaf.id, []).append(("opaque", None))
            bindings_cache[id(scope)] = b
            return b

        def bounded(expr, scope, depth=0) -> tuple[bool, list[str]]:
            if depth > 6:
                return False, []
            if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
                return True, [expr.value]
            if isinstance(expr, ast.IfExp):
                ok1, l1 = bounded(expr.body, scope, depth + 1)
                ok2, l2 = bounded(expr.orelse, scope, depth + 1)
                return ok1 and ok2, l1 + l2
            if isinstance(expr, ast.BoolOp):
                lits: list[str] = []
                for v in expr.values:
                    ok, ls = bounded(v, scope, depth + 1)
                    if not ok:
                        return False, []
                    lits += ls
                return True, lits
            if isinstance(expr, ast.Call) and callee_matches(expr.func, config.bounded_label_producers):
                return True, []
            if isinstance(expr, ast.Name):
                entries = bindings(scope).get(expr.id)
                if not entries:
                    return False, []
                lits = []
                for kind, val in entries:
                    if kind == "expr":
                        ok, ls = bounded(val, scope, depth + 1)
                    elif kind == "for":
                        ok, ls = bounded_iter(val, scope, depth + 1)
                    else:
                        ok, ls = False, []
                    if not ok:
                        return False, []
                    lits += ls
                return True, lits
            return False, []

        def bounded_iter(expr, scope, depth=0) -> tuple[bool, list[str]]:
            if depth > 6:
                return False, []
            if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) and expr.func.id in self._ITER_WRAPPERS:
                return bounded_iter(expr.args[0], scope, depth + 1) if expr.args else (False, [])
            if isinstance(expr, (ast.SetComp, ast.ListComp, ast.GeneratorExp)):
                return bounded(expr.elt, scope, depth + 1)
            if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
                lits = []
                for elt in expr.elts:
                    ok, ls = bounded(elt, scope, depth + 1)
                    if not ok:
                        return False, []
                    lits += ls
                return True, lits
            return False, []

        def record(label: str, literals: list[str], node):
            for v in literals:
                self._literals.setdefault(label, {}).setdefault(v, (mod.relpath, node.lineno))

        def check_kw(label: str, value, scope, node):
            ok, literals = bounded(value, scope)
            if ok:
                record(label, literals, node)
            else:
                findings.append(
                    self._finding(
                        mod,
                        node,
                        f"label {label!r} value is not statically enumerable — pass a literal, an enum-bounded producer result, or justify with a pragma",
                    )
                )

        def dict_labels(expr) -> list[tuple[str, ast.AST]] | None:
            if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) and expr.func.id == "dict" and not expr.args:
                return [(kw.arg, kw.value) for kw in expr.keywords if kw.arg is not None]
            if isinstance(expr, ast.Dict) and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str) for k in expr.keys
            ):
                return [(k.value, v) for k, v in zip(expr.keys, expr.values)]
            return None

        for call, scope, fname in calls:
            func = call.func
            if not isinstance(func, ast.Attribute):
                continue
            # gauge .set carries labels exactly like counter .inc / histogram
            # .observe — an unbounded gauge label leaks series just the same
            if func.attr not in ("inc", "observe", "set") and func.attr not in wrappers:
                continue
            if fname in wrappers:
                continue  # the wrapper's own **labels forwarding
            for kw in call.keywords:
                if kw.arg is not None:
                    if kw.arg in bounded_labels:
                        check_kw(kw.arg, kw.value, scope, call)
                    continue
                # **splat: resolve a locally-built dict literal
                resolved = None
                if isinstance(kw.value, ast.Name):
                    entries = bindings(scope).get(kw.value.id, [])
                    if len(entries) == 1 and entries[0][0] == "expr":
                        resolved = dict_labels(entries[0][1])
                else:
                    resolved = dict_labels(kw.value)
                if resolved is None:
                    findings.append(
                        self._finding(mod, call, "cannot statically bound **labels splat at metric call site")
                    )
                    continue
                for label, value in resolved:
                    if label in bounded_labels:
                        check_kw(label, value, scope, call)
        return findings

    def finalize(self, config):
        findings = []
        for label, values in self._literals.items():
            if len(values) > config.max_label_values:
                path, line = next(iter(values.values()))
                sample = ", ".join(sorted(values)[:6])
                findings.append(
                    Finding(
                        self.name,
                        path,
                        line,
                        f"label {label!r} carries {len(values)} distinct literal values repo-wide "
                        f"(cap {config.max_label_values}): {sample}, ... — an aggregate finding no "
                        f"line pragma can suppress; shrink the value set or raise max-label-values "
                        f"in [tool.solverlint-torch]",
                    )
                )
        return findings


# -- racecheck: the concurrency rules ------------------------------


def _self_lock_attr(node: ast.AST) -> str | None:
    """`self.<attr>` -> attr, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _class_lock_attrs(cls: ast.ClassDef, config: Config, imports=None) -> set[str]:
    """Attrs assigned `self.<attr> = <lock factory>(...)` anywhere in the
    class (normally __init__). `imports` is the module's threading import
    table so `from threading import Lock as L; self._x = L()` is still
    recognized as a lock."""
    mods, names = imports or (set(), {})
    attrs: set[str] = set()
    for n in ast.walk(cls):
        if not (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)):
            continue
        if callee_matches(n.value.func, config.lock_factories) or _threading_construct(n.value, mods, names) in ("Lock", "RLock"):
            for t in n.targets:
                a = _self_lock_attr(t)
                if a is not None:
                    attrs.add(a)
    return attrs


def _module_lock_attrs(tree: ast.Module, config: Config) -> dict[str, tuple[set[str], bool]]:
    """Per class: (effective lock attrs incl. same-module bases, has an
    out-of-module base). `Counter._lock` lives on `_Metric.__init__` — the
    single-inheritance resolution here is what lets subclasses inherit the
    guard declaration."""
    imports = _threading_imports(tree)
    classes = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}
    own = {name: _class_lock_attrs(cls, config, imports) for name, cls in classes.items()}
    out: dict[str, tuple[set[str], bool]] = {}

    def resolve(name: str, seen: frozenset) -> tuple[set[str], bool]:
        if name in out:
            return out[name]
        attrs = set(own.get(name, ()))
        unknown = False
        for base in classes[name].bases:
            bname = dotted_name(base).rsplit(".", 1)[-1]
            if bname in classes and bname not in seen:
                battrs, bunknown = resolve(bname, seen | {name})
                attrs |= battrs
                unknown |= bunknown
            elif bname not in ("object",):
                unknown = True
        out[name] = (attrs, unknown)
        return out[name]

    for name in classes:
        resolve(name, frozenset())
    return out


def _import_table(tree: ast.Module, module: str) -> tuple[set[str], dict[str, str]]:
    """(aliases `module` is bound to, {local name: module attr} for
    from-imports) — so `import random as rnd; rnd.shuffle()` and
    `from random import shuffle as sh; sh()` resolve instead of evading a
    rule via a rename. The same table serves threading (racecheck's rules)
    and time/random/os/uuid (detlint's)."""
    mods: set[str] = set()
    names: dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name == module:
                    mods.add(a.asname or module)
        elif isinstance(n, ast.ImportFrom) and n.module == module:
            for a in n.names:
                names[a.asname or a.name] = a.name
    return mods, names


def _threading_imports(tree: ast.Module) -> tuple[set[str], dict[str, str]]:
    return _import_table(tree, "threading")


def _module_construct(call: ast.Call, mods: set[str], names: dict[str, str]) -> str | None:
    """The module attribute this call invokes ("Lock", "shuffle", ...),
    resolved through module aliases and from-imports; None otherwise."""
    name = dotted_name(call.func)
    if not name:
        return None
    base, _, tail = name.rpartition(".")
    if base in mods:
        return tail
    if not base:
        return names.get(tail)
    return None


# racecheck's rules predate the generic table; keep their vocabulary
_threading_construct = _module_construct


def _has_pragma(mod: ParsedModule, rule: str, line: int) -> bool:
    """A justified pragma for `rule` on `line` or the line directly above.
    Consultation counts as usage: a caller-holds / ordering-contract pragma
    never flows through mod.suppressed(), so it is marked live here lest
    stale-pragma report every contract marker as dead."""
    for i in (line, line - 1):
        for r, _why in mod.pragmas.get(i, ()):
            if r == rule:
                mod.used.add((i, rule))
                return True
    return False


class GuardedFieldAccessRule(Rule):
    name = "guarded-field-access"
    description = "a GUARDED_FIELDS-declared field touched outside a `with self.<lock>` block"

    SELF_TEST_BAD = (
        "class Stats:\n"
        '    GUARDED_FIELDS = {"hits": "_lock"}\n'
        "    def __init__(self):\n"
        '        self._lock = make_lock("stats")\n'
        "        self.hits = 0\n"
        "    def bump(self):\n"
        "        self.hits += 1\n"
    )
    SELF_TEST_OK = (
        "class Stats:\n"
        '    GUARDED_FIELDS = {"hits": "_lock"}\n'
        "    def __init__(self):\n"
        '        self._lock = make_lock("stats")\n'
        "        self.hits = 0\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self.hits += 1\n"
        "    def bump_unlocked(self):  # solverlint: ok(guarded-field-access): self-test snippet — caller-holds contract demo\n"
        "        self.hits += 1\n"
    )

    def globs(self, config):
        return config.thread_modules

    @staticmethod
    def _registry(cls: ast.ClassDef, config: Config):
        """The class's GUARDED_FIELDS literal as {field: lock attr}, plus the
        registry node (for malformed-registry findings)."""
        for n in cls.body:
            target = None
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                target = n.targets[0].id
            elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
                target = n.target.id
            if target != config.guarded_registry_attr:
                continue
            value = n.value
            if not isinstance(value, ast.Dict):
                return None, n
            reg: dict[str, str] = {}
            for k, v in zip(value.keys, value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str) and isinstance(v, ast.Constant) and isinstance(v.value, str)):
                    return None, n
                reg[k.value] = v.value
            return reg, n
        return {}, None

    def check(self, mod, config, root):
        findings: list[Finding] = []
        lock_map = _module_lock_attrs(mod.tree, config)
        for cls in [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]:
            registry, reg_node = self._registry(cls, config)
            if registry is None:
                findings.append(
                    self._finding(mod, reg_node, f"{config.guarded_registry_attr} must be a literal {{'field': 'lock attr'}} dict — the runtime sanitizer reads it too")
                )
                continue
            if not registry:
                continue
            lock_attrs, unknown_base = lock_map.get(cls.name, (set(), True))
            for field, lockattr in registry.items():
                if lockattr not in lock_attrs and not unknown_base:
                    findings.append(
                        self._finding(mod, reg_node, f"guard {lockattr!r} for field {field!r} is never assigned from a lock factory in {cls.name}")
                    )
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if meth.name == "__init__":
                    continue  # construction happens-before thread publication
                if _has_pragma(mod, self.name, meth.lineno):
                    # method-level caller-holds contract: the pragma on the
                    # `def` line declares every call site holds the lock
                    continue
                for child in ast.iter_child_nodes(meth):
                    self._scan(child, registry, frozenset(), findings, mod, cls.name)
        return findings

    def _scan(self, child, registry, held, findings, mod, clsname):
        """One node, with the set of lock attrs lexically held around it."""
        if isinstance(child, _SCOPE_KINDS):
            # a nested def may run on any thread later: scan it with no
            # locks assumed held
            for sub in ast.iter_child_nodes(child):
                self._scan(sub, registry, frozenset(), findings, mod, clsname)
            return
        if isinstance(child, ast.With):
            newly = set()
            for item in child.items:
                # the acquire expression itself is evaluated unlocked
                self._scan(item.context_expr, registry, held, findings, mod, clsname)
                a = _self_lock_attr(item.context_expr)
                if a is not None:
                    newly.add(a)
            for stmt in child.body:
                self._scan(stmt, registry, held | newly, findings, mod, clsname)
            return
        a = _self_lock_attr(child) if isinstance(child, ast.Attribute) else None
        if a is not None and a in registry and registry[a] not in held:
            findings.append(
                self._finding(
                    mod,
                    child,
                    f"field {clsname}.{a!r} is declared guarded by {registry[a]!r} but touched outside `with self.{registry[a]}`",
                )
            )
            return  # the chain below is just `self`
        for sub in ast.iter_child_nodes(child):
            self._scan(sub, registry, held, findings, mod, clsname)


class LockOrderRule(Rule):
    name = "lock-order"
    description = "cycle in the static lock-acquisition graph, or a blocking call under a held lock"

    SELF_TEST_BAD = (
        "import threading\n"
        "class AB:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def one(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def two(self):\n"
        "        with self._b:\n"
        "            with self._a:\n"
        "                pass\n"
    )
    SELF_TEST_OK = (
        "import threading\n"
        "class AB:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def one(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def two(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
    )

    def __init__(self):
        # node = "ClassName.lockattr"; edge (a, b): a held while acquiring b
        self._edges: dict[tuple[str, str], tuple[str, int]] = {}
        # method tail name -> set of lock nodes it acquires directly
        self._method_acquires: dict[str, set[str]] = {}
        # calls made while holding a lock, resolved against methods in finalize
        self._held_calls: list[tuple[str, str, str, int]] = []  # (held node, callee tail, path, line)

    def globs(self, config):
        return config.thread_modules

    def check(self, mod, config, root):
        findings: list[Finding] = []
        lock_map = _module_lock_attrs(mod.tree, config)
        for cls in [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]:
            lock_attrs, _unknown = lock_map.get(cls.name, (set(), False))
            if not lock_attrs:
                continue
            node_of = {a: f"{cls.name}.{a}" for a in lock_attrs}
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                acquires = self._method_acquires.setdefault(meth.name, set())
                for child in ast.iter_child_nodes(meth):
                    self._walk(child, node_of, [], acquires, findings, mod, config)
        return findings

    def _walk(self, child, node_of, held: list, acquires: set, findings, mod, config):
        """One node, with the stack of lock nodes lexically held around it."""
        if isinstance(child, _SCOPE_KINDS):
            return  # nested defs execute later, on their own stack
        if isinstance(child, ast.With):
            newly = []
            for item in child.items:
                a = _self_lock_attr(item.context_expr)
                if a in node_of:
                    n = node_of[a]
                    acquires.add(n)
                    if not _has_pragma(mod, self.name, item.context_expr.lineno):
                        # held + newly-so-far: `with self._a, self._b:`
                        # acquires sequentially, so the combined form orders
                        # a before b exactly like nested withs
                        for h in held + newly:
                            if h != n:
                                self._edges.setdefault((h, n), (mod.relpath, child.lineno))
                    newly.append(n)
            for stmt in child.body:
                self._walk(stmt, node_of, held + newly, acquires, findings, mod, config)
            return
        if isinstance(child, ast.Call) and held:
            if callee_matches(child.func, config.lock_blocking_calls):
                findings.append(
                    self._finding(
                        mod,
                        child,
                        f"blocking call {dotted_name(child.func) or '<call>'}() while holding {held[-1]} — "
                        f"a solve/device-sync/watch-delivery under a lock stalls every contender "
                        f"(see {config.thread_inventory_doc})",
                    )
                )
            tail = dotted_name(child.func).rsplit(".", 1)[-1]
            if tail and tail not in config.lock_call_blacklist and not _has_pragma(mod, self.name, child.lineno):
                self._held_calls.append((held[-1], tail, mod.relpath, child.lineno))
        for sub in ast.iter_child_nodes(child):
            self._walk(sub, node_of, held, acquires, findings, mod, config)

    def finalize(self, config):
        # resolve one level of held-call edges by method name (the dynamic
        # arm covers what name-based resolution cannot see: fn-pointer watch
        # callbacks, cross-object calls on ambiguous names)
        for held, tail, path, line in self._held_calls:
            for node in self._method_acquires.get(tail, ()):
                if node != held:
                    self._edges.setdefault((held, node), (path, line))
        adj: dict[str, set[str]] = {}
        for a, b in self._edges:
            adj.setdefault(a, set()).add(b)
        findings: list[Finding] = []
        seen_cycles: set[frozenset] = set()
        for a, b in sorted(self._edges):
            path = self._path(adj, b, a)
            if path is None:
                continue
            cycle = [a, *path]  # path runs b..a, so the chain ends where it starts
            key = frozenset(cycle)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            src, line = self._edges[(a, b)]
            findings.append(
                Finding(
                    self.name,
                    src,
                    line,
                    "lock-order cycle (potential deadlock): "
                    + " -> ".join(cycle)
                    + f" — pick one order and record it in {config.thread_inventory_doc}",
                )
            )
        return findings

    @staticmethod
    def _path(adj, src, dst):
        """A path src..dst in the edge graph, or None."""
        stack, prev = [src], {src: None}
        while stack:
            n = stack.pop()
            if n == dst:
                out = []
                while n is not None:
                    out.append(n)
                    n = prev[n]
                return list(reversed(out))
            for nxt in adj.get(n, ()):
                if nxt not in prev:
                    prev[nxt] = n
                    stack.append(nxt)
        return None


class ThreadEscapeRule(Rule):
    name = "thread-escape"
    description = "a thread entry point or watch callback outside the declared thread-shared registry"

    SELF_TEST_CONFIG = {"thread_shared": ()}
    SELF_TEST_BAD = (
        "import threading\n"
        "class Escapee:\n"
        "    def start(self):\n"
        "        t = threading.Thread(target=self._run, daemon=True)\n"
        "        t.start()\n"
    )
    SELF_TEST_OK = (
        "import threading\n"
        "class Escapee:\n"
        "    def start(self):\n"
        "        t = threading.Thread(target=self._run, daemon=True)  # solverlint: ok(thread-escape): self-test snippet, never imported\n"
        "        t.start()\n"
    )

    def globs(self, config):
        return config.thread_modules

    def check(self, mod, config, root):
        if mod.relpath == config.racecheck_module:
            return []  # the wrapper's own Thread(...) takes its caller's target
        findings: list[Finding] = []
        # enclosing class per call site, for "ClassName.method" candidates
        enclosing: dict[int, str] = {}

        def mark(node, clsname):
            for child in ast.iter_child_nodes(node):
                name = child.name if isinstance(child, ast.ClassDef) else clsname
                if isinstance(child, ast.Call):
                    enclosing[id(child)] = name
                mark(child, name)

        mark(mod.tree, "")

        def sanctioned(expr, call) -> bool:
            name = dotted_name(expr)
            if not name:
                return False
            tail = name.rsplit(".", 1)[-1]
            # bare names also match path-qualified entries
            # ("karpenter_tpu_torch/state/informer.py:on_*"), so a generic callback
            # name is sanctioned only in the module that was actually
            # reviewed, not anywhere a same-named function appears later
            candidates = {name, tail, f"{mod.relpath}:{name}", f"{mod.relpath}:{tail}"}
            if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) and expr.value.id == "self":
                cls = enclosing.get(id(call), "")
                if cls:
                    candidates.add(f"{cls}.{expr.attr}")
            from fnmatch import fnmatch

            return any(fnmatch(c, p) for c in candidates for p in config.thread_shared)

        def flag(expr, call, what):
            if isinstance(expr, ast.Lambda):
                findings.append(
                    self._finding(mod, call, f"lambda as {what}: captured state is invisible to review — register a named callback from the thread-shared registry or justify with a pragma")
                )
            elif not sanctioned(expr, call):
                findings.append(
                    self._finding(
                        mod,
                        call,
                        f"{what} {dotted_name(expr) or '<expression>'} is not in the thread-shared registry "
                        f"([tool.solverlint-torch] thread-shared) — objects handed to another thread must be reviewed, named seams",
                    )
                )

        mods, names = _threading_imports(mod.tree)
        for call in [n for n in ast.walk(mod.tree) if isinstance(n, ast.Call)]:
            func = call.func
            tail = dotted_name(func).rsplit(".", 1)[-1]
            if _threading_construct(call, mods, names) == "Thread":
                target = next((kw.value for kw in call.keywords if kw.arg == "target"), None)
                if target is not None:
                    flag(target, call, "thread target")
            elif tail == "spawn_thread":
                target = call.args[0] if call.args else next((kw.value for kw in call.keywords if kw.arg == "target"), None)
                if target is not None:
                    flag(target, call, "thread target")
            elif tail in config.watch_register_methods and isinstance(func, ast.Attribute):
                cb = call.args[1] if len(call.args) >= 2 else next((kw.value for kw in call.keywords if kw.arg == "fn"), None)
                if cb is not None:
                    flag(cb, call, "watch callback")
        return findings


class BareThreadPrimitiveRule(Rule):
    name = "bare-thread-primitive"
    description = "raw threading primitive constructed outside the sanctioned racecheck wrapper"
    PRIMITIVES = frozenset({"Lock", "RLock", "Event", "Thread", "Condition", "Semaphore", "BoundedSemaphore", "Barrier"})
    # threading.local is deliberately exempt: thread-local state is the
    # opposite of shared state, and instrumenting it buys nothing

    SELF_TEST_BAD = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
    )
    SELF_TEST_OK = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()  # solverlint: ok(bare-thread-primitive): self-test snippet, never imported\n"
    )

    def globs(self, config):
        return config.thread_modules

    def check(self, mod, config, root):
        if mod.relpath == config.racecheck_module:
            return []  # the wrapper itself necessarily constructs primitives
        findings: list[Finding] = []
        mods, names = _threading_imports(mod.tree)
        for call in [n for n in ast.walk(mod.tree) if isinstance(n, ast.Call)]:
            prim = _threading_construct(call, mods, names)
            if prim in self.PRIMITIVES:
                findings.append(
                    self._finding(
                        mod,
                        call,
                        f"bare {dotted_name(call.func)}() constructs threading.{prim} — go through obs.racecheck "
                        f"(make_lock/make_rlock/make_event/spawn_thread) so KARPENTER_SOLVER_RACECHECK=1 can instrument it",
                    )
                )
        return findings


class SwallowedExceptionRule(Rule):
    name = "swallowed-exception"
    description = "broad except handler that neither re-raises nor records the failure"

    # a serving stack only degrades gracefully when every absorbed failure
    # leaves a signal: a bare `except Exception: pass` is an invisible
    # failure domain. Handlers must re-raise, narrow the except to the
    # expected exception types, call a recorder (events publish / metrics
    # emission — config `exception_recorders`), or carry a justified pragma.
    SELF_TEST_BAD = (
        "def reconcile(store, nc):\n"
        "    try:\n"
        "        store.update(nc)\n"
        "    except Exception:\n"
        "        pass\n"
    )
    SELF_TEST_OK = (
        "def reconcile(store, nc, recorder, registry):\n"
        "    try:\n"
        "        store.update(nc)\n"
        "    except Exception as e:\n"
        '        recorder.publish(nc, "ReconcileError", str(e), type_="Warning")\n'
        "    try:\n"
        "        store.update(nc)\n"
        "    except Exception:\n"
        "        registry.inc()\n"
        "    try:\n"
        "        store.update(nc)\n"
        "    except Exception:\n"
        "        raise\n"
        "    try:\n"
        "        store.update(nc)\n"
        "    except ValueError:\n"
        "        pass\n"
        "    try:\n"
        "        store.update(nc)\n"
        "    except Exception:  # solverlint: ok(swallowed-exception): self-test snippet — proves the pragma form suppresses\n"
        "        pass\n"
    )

    _BROAD = frozenset({"Exception", "BaseException"})

    def globs(self, config):
        return config.exception_modules

    def check(self, mod, config, root):
        findings: list[Finding] = []
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.ExceptHandler):
                continue
            if n.type is not None:
                # `except (Exception, OSError):` is as broad as the unparenthesized
                # form — check every element of a tuple handler, not just the
                # single-name case (dotted_name returns "" for ast.Tuple)
                types = n.type.elts if isinstance(n.type, ast.Tuple) else (n.type,)
                if not any(dotted_name(t).rsplit(".", 1)[-1] in self._BROAD for t in types):
                    continue
            if any(isinstance(sub, ast.Raise) for stmt in n.body for sub in ast.walk(stmt)):
                continue
            def records(call: ast.Call) -> bool:
                # callee_matches resolves Name/Attribute chains; a CHAINED
                # call like registry.counter("m").inc(...) has a Call base,
                # so also match the bare method tail against the patterns
                if callee_matches(call.func, config.exception_recorders):
                    return True
                if isinstance(call.func, ast.Attribute):
                    from fnmatch import fnmatch

                    return any(fnmatch(f"x.{call.func.attr}", p) for p in config.exception_recorders)
                return False

            if any(
                isinstance(sub, ast.Call) and records(sub)
                for stmt in n.body
                for sub in ast.walk(stmt)
            ):
                continue
            caught = ", ".join(dotted_name(t) for t in types) if n.type is not None else "<bare except>"
            findings.append(
                Finding(
                    self.name,
                    mod.relpath,
                    n.lineno,
                    f"broad `except {caught}` handler neither re-raises nor records — narrow it, emit an "
                    f"event/metric, or justify with a pragma (silent failures defeat the degradation ladder)",
                )
            )
        return findings


# -- detlint: the determinism rules --------------------------------


_SET_ANN_NAMES = frozenset({"set", "frozenset", "Set", "FrozenSet", "AbstractSet", "MutableSet"})
# set methods whose result is itself a set (order re-randomized, still unordered)
_SET_RETURNING_METHODS = frozenset({"union", "intersection", "difference", "symmetric_difference", "copy"})


def _ann_is_set(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    return dotted_name(ann).rsplit(".", 1)[-1] in _SET_ANN_NAMES


def _set_expr(node: ast.AST, setnames, self_attrs=frozenset()) -> bool:
    """Statically set-typed expression of non-literal origin. Literal
    `{a, b}` displays are the author's explicit enumeration and stay exempt;
    everything reaching here iterates in hash order."""
    if isinstance(node, ast.Name):
        return node.id in setnames
    if isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Attribute):
        return isinstance(node.value, ast.Name) and node.value.id == "self" and node.attr in self_attrs
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        return (
            isinstance(f, ast.Attribute)
            and f.attr in _SET_RETURNING_METHODS
            and _set_expr(f.value, setnames, self_attrs)
        )
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _set_expr(node.left, setnames, self_attrs) or _set_expr(node.right, setnames, self_attrs)
    if isinstance(node, ast.IfExp):
        return _set_expr(node.body, setnames, self_attrs) or _set_expr(node.orelse, setnames, self_attrs)
    return False


def _set_names(scope: ast.AST) -> set[str]:
    """Names of one scope that are set-typed on EVERY binding (the same
    flow-insensitive discipline as SharedArrayMutationRule's alias pass),
    grown to a fixpoint so `a = set(x); b = a | other` resolves."""
    entries: dict[str, list] = {}

    def note(name: str, kind: str, value=None):
        entries.setdefault(name, []).append((kind, value))

    if isinstance(scope, _SCOPE_KINDS):
        a = scope.args
        for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs, a.vararg, a.kwarg]:
            if arg is not None:
                note(arg.arg, "set" if _ann_is_set(arg.annotation) else "other")
    for n in _walk_scope(scope):
        if isinstance(n, ast.Assign):
            if len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                note(n.targets[0].id, "expr", n.value)
            else:
                for t in n.targets:
                    for leaf in _flat_targets(t):
                        if isinstance(leaf, ast.Name):
                            note(leaf.id, "other")
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            if _ann_is_set(n.annotation):
                note(n.target.id, "set")
            elif n.value is not None:
                note(n.target.id, "expr", n.value)
            else:
                note(n.target.id, "other")
        elif isinstance(n, ast.AugAssign):
            # |=, &=, -=, ^= are kind-preserving on sets: no note, so
            # `s = set(); s |= more` keeps `s` set-typed
            if not isinstance(n.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
                for leaf in _flat_targets(n.target):
                    if isinstance(leaf, ast.Name):
                        note(leaf.id, "other")
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            for leaf in _flat_targets(n.target):
                if isinstance(leaf, ast.Name):
                    note(leaf.id, "other")
        elif isinstance(n, ast.comprehension):
            for leaf in _flat_targets(n.target):
                if isinstance(leaf, ast.Name):
                    note(leaf.id, "other")
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            for leaf in _flat_targets(n.optional_vars):
                if isinstance(leaf, ast.Name):
                    note(leaf.id, "other")

    setnames: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, ents in entries.items():
            if name in setnames:
                continue
            if ents and all(
                kind == "set" or (kind == "expr" and _set_expr(value, setnames)) for kind, value in ents
            ):
                setnames.add(name)
                changed = True
    return setnames


class UnorderedIterationEscapeRule(Rule):
    name = "unordered-iteration-escape"
    description = "set/frozenset iteration (or id()-keyed ordering) escaping into ordered solver outputs"

    # callees that materialize/expose their argument's iteration order
    _ORDER_SENSITIVE_FUNCS = frozenset({"list", "tuple", "enumerate", "iter", "reversed", "map", "zip", "filter"})
    _ORDER_SENSITIVE_TAILS = frozenset({"array", "asarray", "fromiter", "fromkeys", "join", "extend"})
    # order-insensitive consumers: a generator over a set feeding one of
    # these never lands hash order in an output
    _ORDER_OK_FUNCS = frozenset({"sorted", "set", "frozenset", "sum", "len", "any", "all", "min", "max", "bool", "fsum", "stable_host_sum"})

    SELF_TEST_BAD = (
        "def decode(enc):\n"
        "    pending = set(enc.pending)\n"
        "    order = []\n"
        "    for p in pending:\n"
        "        order.append(p)\n"
        "    return order\n"
    )
    SELF_TEST_OK = (
        "def decode(enc):\n"
        "    pending = set(enc.pending)\n"
        "    order = []\n"
        "    for p in sorted(pending):\n"
        "        order.append(p)\n"
        "    for p in pending:  # solverlint: ok(unordered-iteration-escape): self-test snippet, never imported\n"
        "        order.append(p)\n"
        "    return order\n"
    )

    def globs(self, config):
        return config.det_modules

    @staticmethod
    def _id_key(key: ast.AST) -> bool:
        if isinstance(key, ast.Name) and key.id == "id":
            return True
        return (
            isinstance(key, ast.Lambda)
            and isinstance(key.body, ast.Call)
            and isinstance(key.body.func, ast.Name)
            and key.body.func.id == "id"
        )

    def check(self, mod, config, root):
        findings: list[Finding] = []
        # per-class: self attrs set-typed on every assignment module-wide,
        # so `self._groups = set()` in __init__ covers method bodies
        class_attrs: dict[int, frozenset] = {}
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            per: dict[str, list] = {}
            for n in ast.walk(cls):
                if isinstance(n, ast.Assign) and len(n.targets) == 1:
                    a = _self_lock_attr(n.targets[0])
                    if a is not None:
                        per.setdefault(a, []).append(("expr", n.value))
                elif isinstance(n, ast.AnnAssign):
                    a = _self_lock_attr(n.target)
                    if a is not None:
                        per.setdefault(a, []).append(("set", None) if _ann_is_set(n.annotation) else ("expr", n.value))
            attrs = frozenset(
                a
                for a, ents in per.items()
                if all(k == "set" or (v is not None and _set_expr(v, frozenset())) for k, v in ents)
            )
            if attrs:
                for meth in cls.body:
                    if isinstance(meth, _SCOPE_KINDS):
                        class_attrs[id(meth)] = attrs

        suggest = "iterate sorted(...), or justify with a pragma"
        for scope in _scopes(mod.tree):
            setnames = _set_names(scope)
            self_attrs = class_attrs.get(id(scope), frozenset())

            def is_set(node) -> bool:
                return _set_expr(node, setnames, self_attrs)

            # generator expressions whose sole consumer is order-insensitive
            exempt: set[int] = set()
            for n in _walk_scope(scope):
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id in self._ORDER_OK_FUNCS:
                    for a in n.args:
                        if isinstance(a, ast.GeneratorExp):
                            exempt.add(id(a))

            for n in _walk_scope(scope):
                if isinstance(n, (ast.For, ast.AsyncFor)) and is_set(n.iter):
                    findings.append(
                        Finding(
                            self.name,
                            mod.relpath,
                            n.lineno,
                            f"for-loop iterates a set: hash order escapes into the loop body — {suggest}",
                            span=(n.lineno, n.iter.end_lineno or n.lineno),
                        )
                    )
                elif isinstance(n, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
                    # a SetComp over a set stays unordered; list/dict/generator
                    # comprehensions freeze the hash order into their output
                    if isinstance(n, ast.GeneratorExp) and id(n) in exempt:
                        continue
                    if any(is_set(gen.iter) for gen in n.generators):
                        findings.append(
                            self._finding(mod, n, f"comprehension over a set freezes hash order into an ordered result — {suggest}")
                        )
                elif isinstance(n, ast.Call):
                    f = n.func
                    if isinstance(f, ast.Name) and f.id in ("sorted", "min", "max"):
                        key = next((kw.value for kw in n.keywords if kw.arg == "key"), None)
                        if key is not None and self._id_key(key):
                            findings.append(
                                self._finding(mod, n, f"{f.id}(..., key=id) orders by memory address — address order varies run to run; key on content instead")
                            )
                    elif isinstance(f, ast.Name) and f.id in self._ORDER_SENSITIVE_FUNCS and any(is_set(a) for a in n.args):
                        findings.append(
                            self._finding(mod, n, f"{f.id}() materializes a set's hash order into an ordered value — {suggest}")
                        )
                    elif isinstance(f, ast.Attribute) and f.attr in self._ORDER_SENSITIVE_TAILS and any(is_set(a) for a in n.args):
                        findings.append(
                            self._finding(mod, n, f".{f.attr}() materializes a set's hash order into an ordered value — {suggest}")
                        )
                    elif isinstance(f, ast.Attribute) and f.attr == "pop" and not n.args and is_set(f.value):
                        findings.append(
                            self._finding(mod, n, "set.pop() takes a hash-order-arbitrary element — pick by sorted order or justify with a pragma")
                        )
                elif isinstance(n, ast.Starred) and is_set(n.value):
                    findings.append(
                        self._finding(mod, n, f"*-unpacking a set materializes hash order — {suggest}")
                    )
                elif isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], (ast.Tuple, ast.List)) and is_set(n.value):
                    findings.append(
                        self._finding(mod, n, "unpacking a set binds hash-order-arbitrary elements — sort first")
                    )
        return findings


class WallclockRngRule(Rule):
    name = "wallclock-and-rng-in-solve-path"
    description = "wallclock read or unseeded randomness reachable from the solve path"

    _TIME_FUNCS = frozenset({
        "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns",
        "process_time", "process_time_ns", "thread_time", "thread_time_ns",
        "clock_gettime", "localtime", "gmtime", "ctime",
    })
    _DATETIME_FUNCS = frozenset({"now", "utcnow", "today"})
    _UUID_FUNCS = frozenset({"uuid1", "uuid4"})
    # torch's draws from its global generator unless handed `generator=`
    _TORCH_RNG_FUNCS = frozenset({
        "rand", "randn", "randint", "randperm", "rand_like", "randn_like", "randint_like",
        "normal", "bernoulli", "multinomial", "poisson", "seed",
    })
    # constructors that are deterministic WHEN handed an explicit seed
    _SEEDED_WITH_ARG = frozenset({"Random", "default_rng", "RandomState", "seed", "SeedSequence", "Generator", "PRNGKey"})

    SELF_TEST_BAD = (
        "import random as rnd\n"
        "def tiebreak(order):\n"
        "    rnd.shuffle(order)\n"
        "    return order\n"
    )
    SELF_TEST_OK = (
        "import random as rnd\n"
        "def tiebreak(order, seed):\n"
        "    rng = rnd.Random(seed)\n"
        "    rng.shuffle(order)\n"
        "    rnd.shuffle(order)  # solverlint: ok(wallclock-and-rng-in-solve-path): self-test snippet, never imported\n"
        "    return order\n"
    )

    def globs(self, config):
        return config.solve_path_modules

    def check(self, mod, config, root):
        findings: list[Finding] = []
        tree = mod.tree
        tm = _import_table(tree, "time")
        rd = _import_table(tree, "random")
        uu = _import_table(tree, "uuid")
        sec = _import_table(tree, "secrets")
        dt = _import_table(tree, "datetime")
        np_mods, np_names = _import_table(tree, "numpy")
        npr_mods, npr_names = _import_table(tree, "numpy.random")
        # names the numpy.random MODULE itself is bound to (import numpy.random
        # as npr / from numpy import random as nr)
        npr_aliases = set(npr_mods) | {local for local, attr in np_names.items() if attr == "random"}
        th = _import_table(tree, "torch")

        def flag(call, what):
            findings.append(self._finding(mod, call, what))

        for call in [n for n in ast.walk(tree) if isinstance(n, ast.Call)]:
            name = dotted_name(call.func)
            if not name:
                continue
            if callee_matches(call.func, config.seeded_rng):
                continue  # the reviewed seeded-RNG registry
            parts = name.split(".")
            tail = parts[-1]
            seeded = tail in self._SEEDED_WITH_ARG and bool(call.args or call.keywords)

            if _module_construct(call, *tm) in self._TIME_FUNCS:
                flag(call, f"{name}() reads the wallclock on the solve path — solve inputs must be replay-stable; take time from the injected clock seam or justify with a pragma")
            elif (len(parts) == 2 and parts[0] in rd[0]) or (len(parts) == 1 and parts[0] in rd[1]):
                resolved = rd[1].get(parts[0], tail) if len(parts) == 1 else tail
                if not (resolved in self._SEEDED_WITH_ARG and bool(call.args or call.keywords)) or resolved == "SystemRandom":
                    flag(call, f"{name}() draws unseeded randomness on the solve path — seed it explicitly or register the producer in [tool.solverlint-torch] seeded-rng")
            elif (len(parts) >= 3 and parts[0] in np_mods and parts[1] == "random") or (len(parts) >= 2 and parts[0] in npr_aliases):
                if not seeded:
                    flag(call, f"{name}() draws from numpy's global/unseeded RNG on the solve path — use a seeded default_rng(seed) or register in seeded-rng")
            elif len(parts) == 1 and parts[0] in npr_names:
                if not (npr_names[parts[0]] in self._SEEDED_WITH_ARG and bool(call.args or call.keywords)):
                    flag(call, f"{name}() (from numpy.random) draws unseeded randomness on the solve path")
            elif _module_construct(call, *th) in self._TORCH_RNG_FUNCS and not any(
                k.arg == "generator" for k in call.keywords
            ):
                flag(call, f"{name}() draws from torch's global RNG on the solve path — pass a seeded torch.Generator (generator=...) or register the producer in [tool.solverlint-torch] seeded-rng")
            elif _module_construct(call, *uu) in self._UUID_FUNCS:
                flag(call, f"{name}() mints a nondeterministic id on the solve path — derive ids from solve inputs (uuid5 over content, or a counter) or justify with a pragma")
            elif _module_construct(call, *sec) is not None:
                flag(call, f"{name}() reads OS entropy on the solve path — never replay-stable")
            elif tail in self._DATETIME_FUNCS and (
                (len(parts) >= 3 and parts[0] in dt[0]) or (len(parts) == 2 and dt[1].get(parts[0]) in ("datetime", "date"))
            ):
                flag(call, f"{name}() reads the wallclock on the solve path — take time from the injected clock seam")
        return findings


class FloatReductionOrderRule(Rule):
    name = "float-reduction-order"
    description = "order-sensitive float accumulation not routed through a canonical-order helper"

    SELF_TEST_BAD = (
        "def total(ts, items):\n"
        "    takes = greedy_pack_grouped_sharded(ts, items)\n"
        "    return sum(takes)\n"
    )
    SELF_TEST_OK = (
        "import math\n"
        "def total(ts, items):\n"
        "    takes = greedy_pack_grouped_sharded(ts, items)\n"
        "    a = math.fsum(takes)\n"
        "    b = sum(sorted(takes))\n"
        "    c = sum(takes)  # solverlint: ok(float-reduction-order): self-test snippet, never imported\n"
        "    return a + b + c\n"
    )

    def globs(self, config):
        return config.float_order_modules

    def check(self, mod, config, root):
        findings: list[Finding] = []
        helpers = ", ".join(config.canonical_reduce_helpers)
        for scope in _scopes(mod.tree):
            setnames = _set_names(scope)
            # the HostSyncRule taint discipline: names assigned from device
            # producers, plus one fixpoint pass for name-to-name copies
            tainted: set[str] = set()
            copies: list[tuple[str, str]] = []
            for n in _walk_scope(scope):
                if not isinstance(n, ast.Assign):
                    continue
                if isinstance(n.value, ast.Call) and callee_matches(n.value.func, config.device_producers):
                    for t in n.targets:
                        for leaf in _flat_targets(t):
                            if isinstance(leaf, ast.Name):
                                tainted.add(leaf.id)
                elif isinstance(n.value, ast.Name) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                    copies.append((n.targets[0].id, n.value.id))
            changed = True
            while changed:
                changed = False
                for dst, src in copies:
                    if src in tainted and dst not in tainted:
                        tainted.add(dst)
                        changed = True

            def device_expr(node) -> bool:
                if isinstance(node, ast.Name):
                    return node.id in tainted
                if isinstance(node, ast.Call) and callee_matches(node.func, config.device_producers):
                    return True
                return any(device_expr(child) for child in ast.iter_child_nodes(node))

            for n in _walk_scope(scope):
                if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "sum" and n.args):
                    continue
                arg = n.args[0]
                if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name) and arg.func.id == "sorted":
                    continue  # canonical order imposed in place
                unordered = _set_expr(arg, setnames) or (
                    isinstance(arg, (ast.GeneratorExp, ast.ListComp))
                    and any(_set_expr(gen.iter, setnames) for gen in arg.generators)
                )
                if device_expr(arg):
                    findings.append(
                        self._finding(mod, n, f"builtin sum() folds device-derived floats in argument order — float addition does not commute bitwise; route through a canonical-order helper ({helpers}) or sum(sorted(...))")
                    )
                elif unordered:
                    findings.append(
                        self._finding(mod, n, f"builtin sum() folds floats in set hash order — route through a canonical-order helper ({helpers}) or sum(sorted(...))")
                    )
        return findings


class EnvDependentBranchRule(Rule):
    name = "env-dependent-branch"
    description = "os.environ read outside the registered KARPENTER_* knob table"

    SELF_TEST_BAD = (
        "import os as o\n"
        "def pick_mode():\n"
        '    return o.environ.get("KARPENTER_SOLVER_SECRET", "")\n'
    )
    SELF_TEST_OK = (
        "import os\n"
        "def pick_mode():\n"
        '    a = os.environ.get("KARPENTER_SOLVER_MULTIGROUP", "")\n'
        '    b = os.getenv("KARPENTER_SOLVER_BUCKET")\n'
        '    c = os.environ.get("KARPENTER_SOLVER_SECRET", "")  # solverlint: ok(env-dependent-branch): self-test snippet, never imported\n'
        "    return a + (b or \"\") + c\n"
    )

    def globs(self, config):
        return config.solve_path_modules

    def check(self, mod, config, root):
        findings: list[Finding] = []
        mods, names = _import_table(mod.tree, "os")
        knobs = set(config.env_knobs)

        def environ_expr(node) -> bool:
            if isinstance(node, ast.Attribute) and node.attr == "environ":
                return isinstance(node.value, ast.Name) and node.value.id in mods
            return isinstance(node, ast.Name) and names.get(node.id) == "environ"

        def check_key(node, key):
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                if key.value not in knobs:
                    findings.append(
                        self._finding(mod, node, f"env knob {key.value!r} is not in the registered knob table ([tool.solverlint-torch] env-knobs) — an unregistered env probe can fork behavior between shard workers; register it or justify with a pragma")
                    )
            else:
                findings.append(
                    self._finding(mod, node, "os.environ read with a non-literal key — the knob table cannot review dynamic env probes; use a literal registered knob or justify with a pragma")
                )

        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Call):
                f = n.func
                if _module_construct(n, mods, names) == "getenv":
                    check_key(n, n.args[0] if n.args else None)
                elif isinstance(f, ast.Attribute) and f.attr in ("get", "pop", "setdefault") and environ_expr(f.value):
                    check_key(n, n.args[0] if n.args else None)
                elif isinstance(f, ast.Attribute) and f.attr in ("items", "keys", "values", "copy") and environ_expr(f.value):
                    findings.append(
                        self._finding(mod, n, "bulk os.environ read on the solve path — enumerate registered knobs explicitly instead")
                    )
            elif isinstance(n, ast.Subscript) and environ_expr(n.value):
                check_key(n, n.slice)
            elif isinstance(n, ast.Compare) and any(isinstance(op, (ast.In, ast.NotIn)) for op in n.ops):
                if any(environ_expr(c) for c in n.comparators):
                    check_key(n, n.left)
        return findings


class StalePragmaRule(Rule):
    name = "stale-pragma"
    description = "a suppression pragma that no longer suppresses any finding"

    SELF_TEST_SHARED_FIELDS = frozenset({"sig_req"})
    SELF_TEST_BAD = (
        "def f(enc):\n"
        "    x = 1  # solverlint: ok(shared-array-mutation): suppresses nothing here — a dead pragma\n"
        "    return x\n"
    )
    SELF_TEST_OK = (
        "def f(enc):\n"
        "    enc.sig_req[0] = 1.0  # solverlint: ok(shared-array-mutation): live suppression — the pragma is load-bearing\n"
        "    return enc\n"
    )

    def globs(self, config):
        # standalone mode (--rule stale-pragma / fixture runs) re-derives
        # pragma usage by running every other rule on the module; the full
        # scan instead uses run_analysis's cheap post-pass over already-marked
        # modules (see core.run_analysis)
        return ("karpenter_tpu_torch/**/*.py",)

    def check(self, mod, config, root):
        from .core import stale_pragma_findings

        for name, cls in RULES.items():
            if name == self.name:
                continue
            rule = cls()
            for f in rule.check(mod, config, root):
                mod.suppressed(f)  # marks pragma usage; the findings belong to the other rules
        return stale_pragma_findings(mod, set(RULES))


RULES: dict[str, type[Rule]] = {
    cls.name: cls
    for cls in (
        SharedArrayMutationRule,
        HostSyncRule,
        PodAxisLoopRule,
        ReasonFamilyTiersRule,
        MetricLabelCardinalityRule,
        GuardedFieldAccessRule,
        LockOrderRule,
        ThreadEscapeRule,
        BareThreadPrimitiveRule,
        SwallowedExceptionRule,
        UnorderedIterationEscapeRule,
        WallclockRngRule,
        FloatReductionOrderRule,
        EnvDependentBranchRule,
        StalePragmaRule,
    )
}
