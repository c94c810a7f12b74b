"""The C++ requirement table (`reqkernel.cpp`): a host kernel.

The host control plane's hottest pure-Python loop is the per-(pod x
instance-type) `Requirements.intersects` check inside
`filter_instance_types`. `ReqTable` interns a NodeClaim template's
instance-type requirements once and answers "which rows intersect this
query" in one C call. It stays on the host: each query is one pod's
requirements against a few hundred rows, issued from inside the FFD loop.

The shared library is compiled with `g++` at first use into
`<cache>/<hash>/`, named by a hash of the source and flags. The cache is
the directory `KARPENTER_NATIVE_CACHE` names, else `<build dir>/native` (the
build dir is `kernels.build.BUILD_DIR`: `build/kernels/` at the repository
root, or the shared directory `kernels.build.set_build_dir` names for a
fleet's processes). Processes that start together build once: each
holds an exclusive lock on the hash directory's `.build.lock` from its check
for the library to the library's rename into place. A failed build or load
raises `NativeBuildError`, a `kernels.build.KernelError`, so the solver's
recovery ladder lets it through and the Python algebra never answers in its
place; `UnsupportedRequirements` (a value or bound beyond int64) keeps a
template or a query on the Python algebra, which is the semantics, not a
failure. `KARPENTER_DISABLE_NATIVE` (any non-empty value, read at each
call) is the explicit opt-out: no template builds a table, the FFD answers
with the Python algebra, and `load_error()` says so. Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..kernels.build import KernelError

SRC = Path(__file__).resolve().parent / "reqkernel.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libreqkernel.so"

# tables built and filter calls answered by the C++ table in this process:
# what tests and chip_smoke.py read to show the residual FFD used the table
COUNTS = {"tables": 0, "filters": 0}

NO_BOUND = -(2**63)

DISABLED = "disabled via KARPENTER_DISABLE_NATIVE"

_lock = threading.Lock()
_lib = None
_load_error: str | None = None


class NativeBuildError(KernelError):
    """The C++ requirement table failed to build or load: a template that
    needs the table raises it rather than falling back to the Python
    algebra."""


def disabled() -> bool:
    """Whether KARPENTER_DISABLE_NATIVE turns the table off (any non-empty
    value, as the reference reads it)."""
    return bool(os.environ.get("KARPENTER_DISABLE_NATIVE"))  # solverlint: ok(env-dependent-branch): the reference's opt-out of a host table whose answers equal the Python algebra's — placements do not fork


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()[:16]


def lib_dir() -> Path:
    """Where the library of the current source is built and loaded from:
    under `KARPENTER_NATIVE_CACHE` when it is set, else under the kernels'
    build directory."""
    from ..kernels import build as kbuild

    cache = os.environ.get("KARPENTER_NATIVE_CACHE")  # solverlint: ok(env-dependent-branch): where the library is built, never a solve input
    return (Path(cache) if cache else kbuild.BUILD_DIR / "native") / _digest()


def build() -> Path:
    """Compile `reqkernel.cpp` (once per source hash and build dir) and
    return the library's path. Raises `NativeBuildError` with the
    compiler's output when it fails."""
    out_dir = lib_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise NativeBuildError(f"{CXX} not found: the requirement table is built from source on first use")
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():  # built by the process that held the lock
                return lib_path
            t0 = time.perf_counter()  # solverlint: ok(wallclock-and-rng-in-solve-path): the build's duration, logged to builds.log — never a solve input
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(f"{CXX} failed (rc {proc.returncode}) for {SRC.name}:\n{proc.stdout}")
            os.replace(tmp, lib_path)
            seconds = time.perf_counter() - t0  # solverlint: ok(wallclock-and-rng-in-solve-path): the build's duration, logged to builds.log — never a solve input
            with open(out_dir / "builds.log", "a") as f:
                f.write(f"pid={os.getpid()} seconds={seconds:.3f}\n")
            return lib_path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load():
    """The loaded library (built on first call); a failure is kept and
    raised again on every later call. Under `KARPENTER_DISABLE_NATIVE` it
    raises `NativeBuildError(DISABLED)` and keeps nothing."""
    global _lib, _load_error
    with _lock:
        if disabled():
            raise NativeBuildError(DISABLED)
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise NativeBuildError(_load_error)
        try:
            path = build()
            lib = ctypes.CDLL(str(path))
        except (NativeBuildError, OSError) as e:
            _load_error = f"{type(e).__name__}: {e}"
            raise NativeBuildError(_load_error) from e
        lib.rk_new.restype = ctypes.c_void_p
        lib.rk_free.argtypes = [ctypes.c_void_p]
        lib.rk_add_row.argtypes = [ctypes.c_void_p]
        lib.rk_add_row.restype = ctypes.c_int32
        lib.rk_row_add_req.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint8, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
        ]
        lib.rk_filter.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except NativeBuildError:
        return False
    return True


def load_error() -> str | None:
    """Why the library did not build or load, None when it did; `DISABLED`
    under `KARPENTER_DISABLE_NATIVE`."""
    if disabled():
        return DISABLED
    available()
    return _load_error


I64_MIN, I64_MAX = -(2**63) + 1, 2**63 - 1  # NO_BOUND reserves -(2**63)


class UnsupportedRequirements(Exception):
    """A value or bound exceeds int64 — the kernel would silently wrap, so
    the caller must stay on the arbitrary-precision Python algebra."""


def _num(value: str):
    try:
        n = int(value)
    except (TypeError, ValueError):
        return 0, 0
    if not (I64_MIN <= n <= I64_MAX):
        raise UnsupportedRequirements(f"integer value {value} exceeds int64")
    return n, 1


def _bound(b):
    if b is None:
        return NO_BOUND
    if not (I64_MIN <= b <= I64_MAX):
        raise UnsupportedRequirements(f"bound {b} exceeds int64")
    return b


class ReqTable:
    """An interned table of Requirements rows + one-call intersect filter."""

    def __init__(self, rows):
        lib = _load()
        self._lib = lib
        self._keys: dict[str, int] = {}
        self._vals: dict[tuple[str, str], int] = {}
        self._handle = ctypes.c_void_p(lib.rk_new())
        self.n_rows = len(rows)
        for reqs in rows:
            row = lib.rk_add_row(self._handle)
            for key, r in sorted(reqs.items(), key=lambda kv: self._key_id(kv[0])):
                ids, nums, has = self._lower_values(key, r.values)
                lib.rk_row_add_req(
                    self._handle, row, self._key_id(key), 1 if r.complement else 0,
                    _bound(r.gte), _bound(r.lte),
                    ids, nums, has, len(r.values),
                )
        COUNTS["tables"] += 1

    def _key_id(self, key: str) -> int:
        kid = self._keys.get(key)
        if kid is None:
            kid = len(self._keys)
            self._keys[key] = kid
        return kid

    def _lower_values(self, key: str, values):
        entries = []
        for v in values:
            vid = self._vals.get((key, v))
            if vid is None:
                vid = len(self._vals)
                self._vals[(key, v)] = vid
            n, h = _num(v)
            entries.append((vid, n, h))
        entries.sort()
        ids = (ctypes.c_int32 * len(entries))(*[e[0] for e in entries])
        nums = (ctypes.c_int64 * len(entries))(*[e[1] for e in entries])
        has = (ctypes.c_uint8 * len(entries))(*[e[2] for e in entries])
        return ids, nums, has

    def filter(self, query) -> bytes:
        """out[row] == 1 iff rows[row].intersects(query) is None."""
        items = sorted(query.items(), key=lambda kv: self._key_id(kv[0]))
        nq = len(items)
        keys = (ctypes.c_int32 * nq)()
        comp = (ctypes.c_uint8 * nq)()
        gte = (ctypes.c_int64 * nq)()
        lte = (ctypes.c_int64 * nq)()
        off = (ctypes.c_int32 * nq)()
        vlen = (ctypes.c_int32 * nq)()
        pool: list[tuple[int, int, int]] = []
        for i, (key, r) in enumerate(items):
            keys[i] = self._key_id(key)
            comp[i] = 1 if r.complement else 0
            gte[i] = _bound(r.gte)
            lte[i] = _bound(r.lte)
            off[i] = len(pool)
            entries = []
            for v in r.values:
                vid = self._vals.get((key, v))
                if vid is None:
                    vid = len(self._vals)
                    self._vals[(key, v)] = vid
                n, h = _num(v)
                entries.append((vid, n, h))
            entries.sort()
            pool.extend(entries)
            vlen[i] = len(entries)
        np_ = len(pool)
        pool_ids = (ctypes.c_int32 * max(np_, 1))(*[e[0] for e in pool])
        pool_nums = (ctypes.c_int64 * max(np_, 1))(*[e[1] for e in pool])
        pool_has = (ctypes.c_uint8 * max(np_, 1))(*[e[2] for e in pool])
        out = (ctypes.c_uint8 * max(self.n_rows, 1))()
        self._lib.rk_filter(self._handle, keys, comp, gte, lte, off, vlen, nq, pool_ids, pool_nums, pool_has, out)
        COUNTS["filters"] += 1
        return bytes(out[: self.n_rows])

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.rk_free(self._handle)
        except Exception:  # solverlint: ok(swallowed-exception): interpreter-teardown __del__ — the ctypes lib may already be unloaded and raising would print to stderr mid-shutdown
            pass
