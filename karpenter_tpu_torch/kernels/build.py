"""Build and load the CUDA kernels (`csrc/*.cu`) at first use.

Each source is compiled by its own nvcc process (all started together) into
an object file, then the objects are linked into one shared library with a
plain C interface, loaded with ctypes. The build goes into `build/kernels/`
at the repository root, named by a hash of the sources and flags, so a
changed source never loads a stale library. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("feasibility.cu", "pack_scan.cu", "sparsify.cu", "recredit.cu", "globalpack.cu", "score_subsets.cu",
           "anneal.cu", "perpod_pack.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# no --use_fast_math: the pack floors f32 quotients and needs IEEE division;
# -fmad=false keeps a*b-c from contracting into an FMA (bit-parity)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per wrapper, counted where each wrapper launches its kernel
LAUNCHES = {"feasibility": 0, "pack_scan": 0, "sparsify": 0, "recredit": 0, "globalpack": 0, "score_subsets": 0,
            "anneal": 0, "perpod_pack": 0}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source on first use")


def _digest() -> str:
    """Hash of the flags and of every source and header in `csrc/`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library; returns
    its path. Raises with nvcc's output when a step fails."""
    nvcc = _nvcc()
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / "libkarpenter_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
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
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = out_dir / f"libkarpenter_kernels.{os.getpid()}.so"
    link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                           *[str(o) for _n, o, _p in procs], "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log, path=str(lib_path))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            handle.kt_feasibility.argtypes = [vp] * 8 + [ci] * 6 + [vp] * 3
            handle.kt_feasibility.restype = ci
            handle.kt_pack_scan.argtypes = [vp, vp, vp]
            handle.kt_pack_scan.restype = ci
            handle.kt_pack_scan_limits.argtypes = [vp]
            handle.kt_pack_scan_limits.restype = ci
            handle.kt_sparsify.argtypes = [vp] * 5 + [ci] * 4 + [vp] * 3
            handle.kt_sparsify.restype = ci
            handle.kt_recredit.argtypes = [vp] * 10 + [ci] * 5 + [vp] * 4
            handle.kt_recredit.restype = ci
            cf = ctypes.c_float
            handle.kt_globalpack.argtypes = [vp] * 13 + [ci] * 6 + [cf] * 7 + [vp] * 13
            handle.kt_globalpack.restype = ci
            handle.kt_score_subsets.argtypes = [vp] * 12 + [ci] * 5 + [cf] * 2 + [vp] * 3
            handle.kt_score_subsets.restype = ci
            handle.kt_anneal.argtypes = [vp] * 11 + [ci] * 5 + [cf] + [vp] * 3
            handle.kt_anneal.restype = ci
            handle.kt_perpod_pack.argtypes = [vp, vp, vp]
            handle.kt_perpod_pack.restype = ci
            handle.kt_perpod_pack_limits.argtypes = [vp]
            handle.kt_perpod_pack_limits.restype = ci
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, device, dtype, name: str):
    """Check a tensor handed to a kernel: device, dtype, contiguity."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t
