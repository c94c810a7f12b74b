"""Build and load the CUDA kernels (`csrc/*.cu`) at first use.

Each source is compiled by its own nvcc process (all started together) into
an object file, then the objects are linked into one shared library with a
plain C interface, loaded with ctypes. The build goes into `build/kernels/`
at the repository root (or the directory `set_build_dir` names: the shared
`KARPENTER_SOLVER_COMPILE_CACHE` of a fleet's processes), named by a hash of
the sources and flags, so a changed source never loads a stale library.
Processes that start together build once: each holds an exclusive lock on
the hash directory's `.build.lock` from its check for the library to the
library's rename into place, and appends one line to `builds.log` there for
every build it runs. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("feasibility.cu", "pack_scan.cu", "pack_scan_sharded.cu", "sparsify.cu", "recredit.cu", "globalpack.cu", "score_subsets.cu",
           "anneal.cu", "perpod_pack.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# no --use_fast_math: the pack floors f32 quotients and needs IEEE division;
# -fmad=false keeps a*b-c from contracting into an FMA (bit-parity)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per wrapper, counted where each wrapper launches its kernel
LAUNCHES = {"feasibility": 0, "pack_scan": 0, "pack_scan_sharded": 0, "sparsify": 0, "recredit": 0, "globalpack": 0, "score_subsets": 0,
            "anneal_pack": 0, "anneal": 0, "perpod_pack": 0}

# builds and loads of the kernel library in this process (nvcc run or the
# cached library loaded from disk), each counted once under the label of the
# kernel entry point whose call made it (`obs/trace.JIT_WATCHLIST`; "" when
# none was on the stack): what the solve trace's recompile sentinel diffs
# around each solve (`obs/trace.RecompileSentinel`)
LOADS: dict[str, int] = {}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch. `unrecoverable`: the
    solver's recovery ladder lets it propagate, so the host FFD never
    answers for a broken kernel."""

    unrecoverable = True


class KernelArgError(KernelError, ValueError):
    """A kernel wrapper refused its arguments (device, layout, axes) before
    the launch: a `KernelError` that is also the `ValueError` it replaces."""


class KernelTypeError(KernelError, TypeError):
    """A kernel wrapper refused an argument's type or dtype before the
    launch: a `KernelError` that is also the `TypeError` it replaces."""


def device_fault(err: BaseException, device) -> bool:
    """Is `err` a failure of the kernels or of the device, which no host
    answer may hide? Every `KernelError` (a build, load, launch or argument
    refusal), and on a CUDA device torch's own CUDA errors: out of memory,
    `AcceleratorError`, and a RuntimeError that names CUDA or a CUDA device
    (torch before 2.8 raises "CUDA error: ..." so; a device mismatch names
    "cuda:0")."""
    if getattr(err, "unrecoverable", False):
        return True
    kind = device.type if hasattr(device, "type") else str(device).split(":")[0]
    if kind != "cuda":
        return False
    import torch

    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(err, torch.cuda.OutOfMemoryError) or (accel is not None and isinstance(err, accel)):
        return True
    return isinstance(err, RuntimeError) and "cuda" in str(err).lower()


def _entry_label() -> str:
    """The `JIT_WATCHLIST` label of the innermost watched kernel entry point
    on the calling stack, "" when there is none (a direct wrapper call)."""
    from ..obs.trace import JIT_WATCHLIST

    watched = {(mod, attr): label for label, mod, attr in JIT_WATCHLIST}
    frame = sys._getframe(1)
    while frame is not None:
        label = watched.get((frame.f_globals.get("__name__"), frame.f_code.co_name))
        if label is not None:
            return label
        frame = frame.f_back
    return ""


def count_load() -> None:
    """Count one build or load of the library against the entry point that
    made it."""
    label = _entry_label()
    LOADS[label] = LOADS.get(label, 0) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"  # solverlint: ok(env-dependent-branch): where the CUDA toolkit lives for the build — the kernels built are the same sources and flags either way
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels are built from source on first use")


def _digest() -> str:
    """Hash of the flags and of every source and header in `csrc/`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def set_build_dir(path) -> None:
    """Build into (and load from) `path`/<hash> from now on."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library; returns
    its path. Raises with nvcc's output when a step fails. Another process
    building the same hash meanwhile is waited for, and its library used."""
    nvcc = _nvcc()
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / "libkarpenter_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():  # built by the process that held the lock
                return lib_path
            return _build_locked(nvcc, out_dir, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_locked(nvcc: str, out_dir: Path, lib_path: Path) -> Path:
    t0 = time.perf_counter()  # solverlint: ok(wallclock-and-rng-in-solve-path): the build's duration, logged to builds.log — never a solve input
    procs = []
    for name in SOURCES:
        obj = out_dir / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for name, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    (out_dir / "build.log").write_text(log)
    if failed:
        raise KernelError(f"nvcc failed for {failed}:\n{log}")
    tmp = out_dir / f"libkarpenter_kernels.{os.getpid()}.so"
    link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                           *[str(o) for _n, o, _p in procs], "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    seconds = time.perf_counter() - t0  # solverlint: ok(wallclock-and-rng-in-solve-path): the build's duration, logged to builds.log — never a solve input
    with open(out_dir / "builds.log", "a") as f:
        f.write(f"pid={os.getpid()} seconds={seconds:.3f}\n")
    BUILD_INFO.update(seconds=seconds, log=log, path=str(lib_path))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                handle = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"loading {path} failed: {e}") from e
            count_load()
            vp, ci = ctypes.c_void_p, ctypes.c_int
            handle.kt_feasibility.argtypes = [vp] * 8 + [ci] * 6 + [vp] * 4
            handle.kt_feasibility.restype = ci
            handle.kt_feasibility_scratch.argtypes = [ci] * 6
            handle.kt_feasibility_scratch.restype = ctypes.c_longlong
            handle.kt_empty.argtypes = [vp]
            handle.kt_empty.restype = ci
            handle.kt_pack_scan.argtypes = [vp, vp, vp]
            handle.kt_pack_scan.restype = ci
            handle.kt_pack_scan_scratch.argtypes = [vp]
            handle.kt_pack_scan_scratch.restype = ctypes.c_longlong
            handle.kt_pack_scan_sharded.argtypes = [vp, vp, vp]
            handle.kt_pack_scan_sharded.restype = ci
            handle.kt_pack_scan_sharded_scratch.argtypes = [vp]
            handle.kt_pack_scan_sharded_scratch.restype = ctypes.c_longlong
            handle.kt_sparsify.argtypes = [vp] * 5 + [ci] * 4 + [vp] * 3
            handle.kt_sparsify.restype = ci
            handle.kt_recredit.argtypes = [vp] * 10 + [ci] * 5 + [vp] * 4
            handle.kt_recredit.restype = ci
            cf = ctypes.c_float
            handle.kt_globalpack.argtypes = [vp] * 13 + [ci] * 6 + [cf] * 7 + [vp] * 4
            handle.kt_globalpack.restype = ci
            handle.kt_globalpack_scratch.argtypes = [ci] * 5
            handle.kt_globalpack_scratch.restype = ctypes.c_longlong
            handle.kt_score_subsets.argtypes = [vp] * 12 + [ci] * 5 + [cf] * 2 + [vp] * 4
            handle.kt_score_subsets.restype = ci
            handle.kt_score_subsets_scratch.argtypes = [ci] * 4
            handle.kt_score_subsets_scratch.restype = ctypes.c_longlong
            handle.kt_anneal_pack.argtypes = [vp, ci, vp, vp, ci, ci, vp, ctypes.c_longlong] + [vp] * 5
            handle.kt_anneal_pack.restype = ci
            handle.kt_anneal.argtypes = [vp] * 14 + [ci] * 5 + [cf] + [vp] * 4
            handle.kt_anneal.restype = ci
            handle.kt_anneal_scratch.argtypes = [ci] * 5
            handle.kt_anneal_scratch.restype = ctypes.c_longlong
            handle.kt_perpod_pack.argtypes = [vp, vp, vp]
            handle.kt_perpod_pack.restype = ci
            handle.kt_perpod_pack_scratch.argtypes = [vp]
            handle.kt_perpod_pack_scratch.restype = ctypes.c_longlong
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, device, dtype, name: str):
    """Check a tensor handed to a kernel: device, dtype, contiguity. A
    refusal is a `KernelError`, so it propagates out of a solve."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise KernelTypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise KernelArgError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelTypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise KernelArgError(f"{name}: not contiguous")
    return t


def empty_launch(device) -> None:
    """Launch an empty kernel (`kt_empty` in `csrc/feasibility.cu`): the
    floor of any launch, timed beside the kernels. Counted nowhere."""
    check(lib().kt_empty(stream_ptr(device)), "empty")
