"""CEL device-selector subset evaluator.

The reference evaluates DRA device selectors as CEL expressions
(`resourcev1.CELDeviceSelector`, used throughout
pkg/scheduling/dynamicresources/allocator.go via the upstream
k8s.io/dynamic-resource-allocation cel package; the allocator_test.go corpus
exercises expressions like `device.driver == "gpu.example.com"` and
`device.attributes["gpu.example.com"].model == "H100"`). This repo's
structured selector dicts remain the primary TPU-native surface, but CEL
strings are accepted too so reference ResourceClaims port over unchanged:
a selector `{"cel": "<expr>"}` is parsed once (cached) and evaluated
host-side per device.

Supported subset — the full device-selector CEL environment the reference's
corpus and the k8s conformance examples draw on:

- `device.driver` (string)
- `device.attributes["<domain>"].<name>` → attribute value; the flat
  attribute key is "<domain>/<name>" (kube/objects.py Device.attributes)
- `device.capacity["<domain>"].<name>` → Quantity
- literals: strings ('…' or "…"), ints, floats, booleans, lists
- operators: == != < <= > >= && || ! in, parentheses
- macros/functions: has(…), quantity("1Gi"), s.matches(re), s.startsWith,
  s.endsWith, s.contains, e.lowerAscii(), e.upperAscii(), size(…)

CEL error semantics: accessing a missing attribute/capacity is an evaluation
error, and the reference treats a selector that errors as not matching
(upstream cel.Device.Matches returns (false, err)). `has(…)` probes without
erroring. Parse errors make the selector permanently non-matching (upstream:
a compile error fails the request)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from ...utils.quantity import Quantity

__all__ = ["CelError", "evaluate", "matches_device"]


class CelError(Exception):
    """Parse or evaluation error; evaluation errors mean 'no match'."""


class _Missing(CelError):
    """Missing attribute/capacity lookup (probe-able via has())."""


# -- tokenizer ---------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>\d+\.\d+|\d+)
      | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
      | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op>&&|\|\||==|!=|<=|>=|[-!<>\[\]().,])
    )""",
    re.VERBOSE,
)


def _tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            rest = src[pos:].strip()
            if not rest:
                break
            raise CelError(f"unexpected character at {pos}: {rest[:10]!r}")
        pos = m.end()
        for kind in ("num", "str", "ident", "op"):
            tok = m.group(kind)
            if tok is not None:
                out.append((kind, tok))
                break
    out.append(("eof", ""))
    return out


# -- AST ---------------------------------------------------------------------


@dataclass
class _Lit:
    value: Any


@dataclass
class _List:
    items: list


@dataclass
class _Driver:
    pass


@dataclass
class _Lookup:  # device.attributes["domain"].name  /  device.capacity[...].name
    table: str  # "attributes" | "capacity"
    domain: str
    name: str | None  # None: whole-map access not supported → error at eval


@dataclass
class _Unary:
    op: str
    operand: Any


@dataclass
class _Binary:
    op: str
    left: Any
    right: Any


@dataclass
class _Has:
    target: Any


@dataclass
class _Call:  # method call: recv.method(args) or bare fn(args)
    recv: Any  # None for bare functions (quantity, size)
    name: str
    args: list


class _Parser:
    """Recursive descent over CEL's precedence ladder || → && → cmp/in →
    unary(!,-) → postfix (method call) → primary; unary binds TIGHTER than
    comparison, so `!x == 5` is `(!x) == 5` as upstream parses it."""

    def __init__(self, toks: list[tuple[str, str]]):
        self.toks = toks
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val: str) -> None:
        kind, tok = self.next()
        if tok != val:
            raise CelError(f"expected {val!r}, got {tok!r}")

    def parse(self):
        node = self.parse_or()
        if self.peek()[0] != "eof":
            raise CelError(f"trailing input at token {self.peek()[1]!r}")
        return node

    def parse_or(self):
        node = self.parse_and()
        while self.peek()[1] == "||":
            self.next()
            node = _Binary("||", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_cmp()
        while self.peek()[1] == "&&":
            self.next()
            node = _Binary("&&", node, self.parse_cmp())
        return node

    def parse_cmp(self):
        node = self.parse_unary()
        kind, tok = self.peek()
        if tok in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            return _Binary(tok, node, self.parse_unary())
        if kind == "ident" and tok == "in":
            self.next()
            return _Binary("in", node, self.parse_unary())
        return node

    def parse_unary(self):
        tok = self.peek()[1]
        if tok in ("!", "-"):
            self.next()
            operand = self.parse_unary()
            if tok == "-" and isinstance(operand, _Lit) and isinstance(operand.value, (int, float)) and not isinstance(operand.value, bool):
                return _Lit(-operand.value)
            return _Unary(tok, operand)
        return self.parse_postfix()

    def parse_postfix(self):
        node = self.parse_primary()
        while self.peek()[1] == ".":
            self.next()
            kind, name = self.next()
            if kind != "ident":
                raise CelError(f"expected method name, got {name!r}")
            self.expect("(")
            args = []
            if self.peek()[1] != ")":
                args.append(self.parse_or())
                while self.peek()[1] == ",":
                    self.next()
                    args.append(self.parse_or())
            self.expect(")")
            node = _Call(node, name, args)
        return node

    def parse_primary(self):
        kind, tok = self.next()
        if tok == "(":
            node = self.parse_or()
            self.expect(")")
            return node
        if tok == "[":
            items = []
            if self.peek()[1] != "]":
                items.append(self.parse_or())
                while self.peek()[1] == ",":
                    self.next()
                    items.append(self.parse_or())
            self.expect("]")
            return _List(items)
        if kind == "num":
            return _Lit(float(tok) if "." in tok else int(tok))
        if kind == "str":
            return _Lit(_unquote(tok))
        if kind == "ident":
            if tok in ("true", "false"):
                return _Lit(tok == "true")
            if tok == "has":
                self.expect("(")
                inner = self.parse_or()
                self.expect(")")
                return _Has(inner)
            if tok in ("quantity", "size"):
                self.expect("(")
                arg = self.parse_or()
                self.expect(")")
                return _Call(None, tok, [arg])
            if tok == "device":
                return self.parse_device()
        raise CelError(f"unexpected token {tok!r}")

    def parse_device(self):
        self.expect(".")
        kind, field = self.next()
        if field == "driver":
            return _Driver()
        if field in ("attributes", "capacity"):
            self.expect("[")
            k, dom = self.next()
            if k != "str":
                raise CelError("attribute domain must be a string literal")
            self.expect("]")
            name = None
            # the common corpus form is a trailing .name field select; a
            # method call after the map access (rare) leaves name None and
            # errors at eval, matching "whole-map access unsupported"
            if self.peek()[1] == "." and self.toks[self.i + 1][0] == "ident":
                nxt_after = self.toks[self.i + 2][1] if self.i + 2 < len(self.toks) else ""
                if nxt_after != "(":  # it's a field select, not a method
                    self.next()
                    name = self.next()[1]
            return _Lookup(field, _unquote(dom), name)
        raise CelError(f"unknown device field {field!r}")


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'", "0": "\0"}


def _unquote(tok: str) -> str:
    if tok and tok[0] in "\"'":
        body = tok[1:-1]
        return re.sub(r"\\(.)", lambda m: _ESCAPES.get(m.group(1), m.group(1)), body)
    return tok


# -- evaluation --------------------------------------------------------------


def _coerce_pair(a, b):
    """CEL is strongly typed; we soften numerics (int vs float vs numeric
    string from flat attribute storage) but never cross-compare types."""
    if isinstance(a, Quantity) or isinstance(b, Quantity):
        try:
            qa = a if isinstance(a, Quantity) else Quantity.parse(str(a))
            qb = b if isinstance(b, Quantity) else Quantity.parse(str(b))
        except (ValueError, TypeError) as e:
            raise CelError(f"cannot compare with quantity: {e}")
        return qa.milli, qb.milli
    if isinstance(a, bool) or isinstance(b, bool):
        return a, b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a, b
    if isinstance(a, (int, float)) and isinstance(b, str):
        try:
            return a, float(b)
        except ValueError:
            return a, b
    if isinstance(b, (int, float)) and isinstance(a, str):
        try:
            return float(a), b
        except ValueError:
            return a, b
    return a, b


def _eval(node, device):
    if isinstance(node, _Lit):
        return node.value
    if isinstance(node, _List):
        return [_eval(x, device) for x in node.items]
    if isinstance(node, _Driver):
        return device.driver
    if isinstance(node, _Lookup):
        if node.name is None:
            raise CelError("whole-map attribute access is not supported")
        key = f"{node.domain}/{node.name}"
        if node.table == "attributes":
            attrs = device.attributes or {}
            if key in attrs:
                return attrs[key]
            # unqualified driver-domain attributes: stored bare when the
            # domain is the device's own driver
            if node.domain == device.driver and node.name in attrs:
                return attrs[node.name]
            raise _Missing(key)
        caps = device.capacity or {}
        if key in caps:
            return caps[key]
        # bare capacity names resolve only under the device's own driver
        # domain, mirroring the attributes branch above
        if node.domain == device.driver and node.name in caps:
            return caps[node.name]
        raise _Missing(key)
    if isinstance(node, _Has):
        try:
            _eval(node.target, device)
            return True
        except _Missing:
            return False
    if isinstance(node, _Unary):
        v = _eval(node.operand, device)
        if node.op == "-":
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise CelError("unary - requires a number")
            return -v
        if not isinstance(v, bool):
            raise CelError("! requires a boolean")
        return not v
    if isinstance(node, _Call):
        return _eval_call(node, device)
    if isinstance(node, _Binary):
        if node.op == "&&":
            # CEL's commutative &&: false short-circuits ANY error (missing
            # attribute, type confusion) on the other side
            try:
                lv = _eval(node.left, device)
            except CelError:
                rv = _eval(node.right, device)
                if rv is False:
                    return False
                raise
            if lv is False:
                return False
            if not isinstance(lv, bool):
                raise CelError("&& requires booleans")
            rv = _eval(node.right, device)
            if not isinstance(rv, bool):
                raise CelError("&& requires booleans")
            return lv and rv
        if node.op == "||":
            try:
                lv = _eval(node.left, device)
            except CelError:
                rv = _eval(node.right, device)
                if rv is True:
                    return True
                raise
            if lv is True:
                return True
            if not isinstance(lv, bool):
                raise CelError("|| requires booleans")
            rv = _eval(node.right, device)
            if not isinstance(rv, bool):
                raise CelError("|| requires booleans")
            return lv or rv
        lv = _eval(node.left, device)
        rv = _eval(node.right, device)
        if node.op == "in":
            if not isinstance(rv, list):
                raise CelError("'in' requires a list on the right")
            return any(_cel_eq(lv, x) for x in rv)
        if node.op == "==":
            return _cel_eq(lv, rv)
        if node.op == "!=":
            return not _cel_eq(lv, rv)
        a, b = _coerce_pair(lv, rv)
        if isinstance(a, bool) or isinstance(b, bool):
            # upstream CEL has no ordering overload for booleans
            raise CelError("cannot order booleans")
        try:
            if node.op == "<":
                return a < b
            if node.op == "<=":
                return a <= b
            if node.op == ">":
                return a > b
            if node.op == ">=":
                return a >= b
        except TypeError:
            raise CelError(f"cannot order {type(lv).__name__} vs {type(rv).__name__}")
    raise CelError(f"unhandled node {node!r}")


def _cel_eq(a, b) -> bool:
    a, b = _coerce_pair(a, b)
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


def _eval_call(node: _Call, device):
    args = [_eval(a, device) for a in node.args]
    if node.recv is None:
        if node.name == "quantity":
            if len(args) != 1 or not isinstance(args[0], str):
                raise CelError("quantity() takes one string")
            try:
                return Quantity.parse(args[0])
            except Exception as e:  # noqa: BLE001 - surface as CEL error
                raise CelError(f"bad quantity: {e}")
        if node.name == "size":
            if len(args) != 1 or not isinstance(args[0], (str, list)):
                raise CelError("size() takes a string or list")
            return len(args[0])
        raise CelError(f"unknown function {node.name}")
    recv = _eval(node.recv, device)
    if not isinstance(recv, str):
        raise CelError(f".{node.name}() requires a string receiver")
    if node.name == "matches":
        if len(args) != 1 or not isinstance(args[0], str):
            raise CelError("matches() takes one string")
        try:
            return re.search(args[0], recv) is not None
        except re.error as e:
            raise CelError(f"bad regex: {e}")
    if node.name in ("startsWith", "endsWith", "contains"):
        if len(args) != 1 or not isinstance(args[0], str):
            raise CelError(f"{node.name}() takes one string")
        if node.name == "startsWith":
            return recv.startswith(args[0])
        if node.name == "endsWith":
            return recv.endswith(args[0])
        return args[0] in recv
    if node.name == "lowerAscii":
        if args:
            raise CelError("lowerAscii() takes no arguments")
        return recv.lower()
    if node.name == "upperAscii":
        if args:
            raise CelError("upperAscii() takes no arguments")
        return recv.upper()
    raise CelError(f"unknown method {node.name}")


# -- public API --------------------------------------------------------------


class _CelDevice:
    """Evaluation view: the bare Device plus its slice's driver (the
    reference binds driver/attributes/capacity into the CEL activation —
    upstream cel.Device)."""

    __slots__ = ("attributes", "capacity", "driver")

    def __init__(self, device, driver: str):
        self.attributes = device.attributes
        self.capacity = device.capacity
        self.driver = driver


_cache: dict[str, Any] = {}
_CACHE_MAX = 4096


def _compile(expression: str):
    node = _cache.get(expression)
    if node is None:
        if len(_cache) >= _CACHE_MAX:
            _cache.clear()
        try:
            node = _Parser(_tokenize(expression)).parse()
        except CelError as e:  # compile errors are sticky (upstream: a
            node = e  # compile failure permanently fails the selector)
        _cache[expression] = node
    if isinstance(node, CelError):
        raise node
    return node


def evaluate(expression: str, device, driver: str = "") -> bool:
    """Parse (cached) and evaluate; raises CelError on parse/eval failure."""
    result = _eval(_compile(expression), _CelDevice(device, driver))
    if not isinstance(result, bool):
        raise CelError("selector expression must evaluate to a boolean")
    return result


def matches_device(expression: str, device, driver: str = "") -> bool:
    """The selector contract: errors (parse, type, missing attribute) mean
    the device does not match — upstream cel.Device.Matches error handling."""
    try:
        return evaluate(expression, device, driver)
    except CelError:
        return False
