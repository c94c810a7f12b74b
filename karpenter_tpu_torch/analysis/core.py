"""solverlint core: module parsing, pragma suppression, rule running.

Rules (see rules.py) are pure AST passes producing `Finding`s. Suppression
is line-anchored: a finding survives unless a justified pragma

    # solverlint: ok(<rule>): <why>

sits on one of the finding's own source lines or the line directly above it.
A pragma with no `<why>` text is itself a finding (unsuppressible) — every
suppression must carry its justification.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from fnmatch import fnmatch
from pathlib import Path

from .config import Config, ConfigError, load_config

PRAGMA_RE = re.compile(r"#\s*solverlint:\s*ok\(([A-Za-z0-9_-]+)\)(?::\s*(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative
    line: int
    message: str
    # source lines a pragma may sit on to suppress this finding (the line
    # above is added by `ParsedModule.suppressed`)
    span: tuple[int, int] = (0, 0)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class ParsedModule:
    """One source file: text, AST, and its solverlint pragmas by line."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        # line (1-based) -> [(rule, why)] — pragmas live in real COMMENT
        # tokens only (docstrings describing the syntax never count)
        self.pragmas: dict[int, list[tuple[str, str]]] = {}
        self.malformed: list[Finding] = []
        # (line, rule) pairs whose pragma did real work this scan — either
        # suppressed a finding or was consulted as a contract marker
        # (lock-order / guarded-field caller-holds). stale-pragma reads this.
        self.used: set[tuple[int, str]] = set()
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
        except tokenize.TokenError:
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT or "solverlint:" not in tok.string:
                continue
            i = tok.start[0]
            m = PRAGMA_RE.search(tok.string)
            if m is None:
                self.malformed.append(Finding("solverlint-pragma", relpath, i, "unparseable solverlint pragma"))
                continue
            rule, why = m.group(1), (m.group(2) or "").strip()
            if not why:
                self.malformed.append(
                    Finding(
                        "solverlint-pragma",
                        relpath,
                        i,
                        f"pragma for {rule!r} carries no justification — write the ok(...) form with a <why>",
                    )
                )
                continue
            self.pragmas.setdefault(i, []).append((rule, why))

    def suppressed(self, finding: Finding) -> bool:
        lo, hi = finding.span if finding.span != (0, 0) else (finding.line, finding.line)
        # own-span lines BEFORE the line above: when adjacent lines each
        # carry their own pragma for the same rule, each finding must mark
        # its own pragma as used, not shadow its neighbor's (stale-pragma
        # would otherwise report the second of two back-to-back pragmas)
        for line in (*range(lo, hi + 1), lo - 1):
            for rule, _why in self.pragmas.get(line, ()):
                if rule == finding.rule:
                    self.used.add((line, rule))
                    return True
        return False


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def _match_globs(root: Path, globs) -> list[Path]:
    out: list[Path] = []
    seen = set()
    for pattern in globs:
        for p in sorted(root.glob(pattern)):
            if p.suffix == ".py" and p.is_file() and p not in seen:
                seen.add(p)
                out.append(p)
    return out


def run_analysis(
    root: Path | None = None,
    config: Config | None = None,
    rules: list[str] | None = None,
    paths: list[Path] | None = None,
    jobs: int = 1,
) -> list[Finding]:
    """Run the selected rules (default: all) and return surviving findings.

    Three modes: no `paths` — each rule scans the module set its config
    globs name; `paths` + explicit `rules` — run exactly those rules over
    exactly those files (fixture mode, globs bypassed); `paths` alone — the
    normal scan restricted to those files, so each rule still sees only
    files its globs cover (a non-tensor module passed on the CLI is not
    suddenly held to tensor-module rules).

    `jobs > 1` runs rules concurrently on a thread pool. Parsed modules are
    cached ONCE across all rules either way (the cross-module concurrency
    rules re-scan the same files the cardinality rule parses); findings come
    back in deterministic rule order regardless of scheduling.
    """
    import threading

    from .rules import RULES

    root = root or repo_root()
    config = config or load_config(root)
    selected = list(RULES) if rules is None else list(rules)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ConfigError(f"unknown rules requested: {unknown} (have {sorted(RULES)})")
    # default scans handle stale-pragma via the cheap post-pass below (usage
    # was already marked while the other rules ran); only an EXPLICIT --rule
    # selection runs the rule's standalone re-derivation
    stale_post = rules is None and "stale-pragma" in selected
    if stale_post:
        selected = [r for r in selected if r != "stale-pragma"]

    # path -> module, or None once it failed to parse (the parse finding is
    # emitted exactly once, not once per rule that scans the file); shared
    # across rules and worker threads
    cache: dict[Path, ParsedModule | None] = {}
    cache_lock = threading.Lock()
    parse_findings: list[Finding] = []
    scanned: dict[Path, set[str]] = {}

    def parsed(path: Path) -> ParsedModule | None:
        # parse INSIDE the lock: concurrent rules glob overlapping module
        # sets, and the GIL means parallel ast.parse buys nothing — holding
        # the lock is what makes "cached once across all rules" true
        with cache_lock:
            if path in cache:
                return cache[path]
            try:
                mod = ParsedModule(str(path.relative_to(root)) if path.is_relative_to(root) else str(path), path.read_text())
            except SyntaxError as e:
                parse_findings.append(Finding("solverlint-parse", str(path), e.lineno or 0, f"syntax error: {e.msg}"))
                mod = None
            except OSError as e:
                raise ConfigError(f"cannot read {path}: {e}") from e
            cache[path] = mod
            return mod

    def run_rule(name: str) -> list[Finding]:
        rule = RULES[name]()  # fresh instance: rules may aggregate across files
        out: list[Finding] = []
        if paths is not None and rules is not None:
            files = paths
        elif paths is not None:
            globbed = {g.resolve() for g in _match_globs(root, rule.globs(config))}
            files = [p for p in paths if Path(p).resolve() in globbed]
        else:
            files = _match_globs(root, rule.globs(config))
            if not files:
                return [Finding(name, str(root), 0, f"rule {name!r} matched no files — check [tool.solverlint-torch] globs")]
        for path in files:
            mod = parsed(Path(path))
            if mod is None:
                continue
            with cache_lock:
                scanned.setdefault(Path(path), set()).add(name)
            for f in rule.check(mod, config, root):
                if not mod.suppressed(f):
                    out.append(f)
        out.extend(rule.finalize(config))
        return out

    if jobs > 1 and len(selected) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(jobs, len(selected))) as ex:
            per_rule = list(ex.map(run_rule, selected))
    else:
        per_rule = [run_rule(name) for name in selected]

    findings: list[Finding] = [f for fs in per_rule for f in fs]
    findings.extend(parse_findings)
    for path, rulenames in scanned.items():
        mod = cache.get(path)
        if mod is None:
            continue
        findings.extend(mod.malformed)
        if stale_post:
            # the stale post-pass: every rule that scans this file has run
            # and marked the pragmas it used; whatever is left did no work
            findings.extend(f for f in stale_pragma_findings(mod, rulenames) if not mod.suppressed(f))
    return findings


def stale_pragma_findings(mod: ParsedModule, checked: set[str]) -> list[Finding]:
    """Pragmas of `mod` that did no work during a scan where the rules in
    `checked` ran over it — dead suppressions rot into false confidence, so
    each one is a finding of its own."""
    from .rules import RULES

    out: list[Finding] = []
    for line in sorted(mod.pragmas):
        for rule, _why in mod.pragmas[line]:
            if rule == "stale-pragma" or (line, rule) in mod.used:
                continue
            if rule not in RULES:
                msg = f"pragma names unknown rule {rule!r} — it can never suppress anything; delete it"
            elif rule not in checked:
                msg = f"pragma for {rule!r} sits in a file that rule never scans — a dead suppression; delete it"
            else:
                msg = f"pragma for {rule!r} no longer suppresses any finding — dead suppressions rot; delete it"
            out.append(Finding("stale-pragma", mod.relpath, line, msg))
    return out


def run_self_test(config: Config | None = None) -> list[str]:
    """Prove every registered rule still detects its own seeded violation and
    that the pragma form suppresses it. Returns a list of failures (empty =
    healthy); the CLI gate turns any failure into exit 2 so a broken rule
    can never pass vacuously."""
    from .rules import RULES

    failures: list[str] = []
    if len(RULES) < 15:
        failures.append(f"rule registry shrank to {len(RULES)} rules (expected >= 15)")
    for name, cls in RULES.items():
        overrides = {"shared_fields": cls.SELF_TEST_SHARED_FIELDS, **cls.SELF_TEST_CONFIG}
        cfg = dataclasses.replace(config or Config(), **overrides)
        for label, src, expect_hit in (("bad", cls.SELF_TEST_BAD, True), ("ok", cls.SELF_TEST_OK, False)):
            rule = cls()
            mod = ParsedModule(f"<self-test:{name}:{label}>", src)
            hits = [f for f in rule.check(mod, cfg, repo_root()) if not mod.suppressed(f)]
            hits.extend(rule.finalize(cfg))
            if expect_hit and not hits:
                failures.append(f"rule {name!r} missed its seeded self-test violation")
            if not expect_hit and hits:
                failures.append(f"rule {name!r} flagged its suppressed/clean self-test snippet: {hits[0]}")
    return failures


def dotted_name(node: ast.AST) -> str:
    """`a.b.c` for Name/Attribute chains, "" for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def callee_matches(func: ast.AST, patterns) -> bool:
    name = dotted_name(func)
    if not name:
        return False
    tail = name.rsplit(".", 1)[-1]
    return any(fnmatch(name, p) or fnmatch(tail, p) for p in patterns)
