#!/usr/bin/env python3
"""Where the time of the one-block pack scan (K2) goes, by clock64 stamps.

Run on a machine with a CUDA card, from the repository root:

    python3 tools/k2_stamps.py karpenter_tpu_torch/kernels/csrc/pack_scan.cu

It builds the given source as it is, and a copy with `clock64()` stamps in
thread 0 (the source with the header it includes, `pack_scan_common.cuh`
from its own directory, put in its place), each with nvcc into its own library under `build/stamps/`, and
runs both through the `pack_scan` wrapper on the two headline fixtures and
the two existing fleets (K1's outputs from its plain version; both checked
against the plain pack). Each stamp adds the cycles since the previous
stamp to the region it closes, so thread 0's wall time splits into regions.
It prints one JSON line per fixture: cycles per region, their share, and
the stamped and the unstamped kernel's times (CUDA events). The stamps add a
few cycles each: compare shares, not absolute times, with the unstamped
kernel. The unstamped times of two sources run in one call compare them.

The stamps go at unique text anchors of the current source (active slot
range in shared memory, item data built by helper blocks and prefetched,
every table sized from the problem); a source without them is refused.
Regions: block 0's set-up, its wait for the item blocks, inside each
`place()` phase A (the slot capacities with their warp scans, the row
argmin loop, the warp reductions), its exchange barrier, phase B (prefixes,
takes, the decision) and phase C (the update), and per item the wait for
the prefetch and the closing barrier; the rest is `branch`.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PREAMBLE = """
#define KT_NREG 24
__shared__ long long kt_acc[KT_NREG + 2];
__shared__ long long kt_last;
__device__ long long kt_out[KT_NREG + 2];
#define KT_ST(k) do { if (threadIdx.x == 0) { long long _n = clock64(); kt_acc[k] += _n - kt_last; kt_last = _n; } } while (0)
#define KT_COUNT(k) do { if (threadIdx.x == 0) kt_acc[KT_NREG + (k)] += 1; } while (0)
#define KT_START() do { if (threadIdx.x == 0) { for (int _k = 0; _k < KT_NREG + 2; ++_k) kt_acc[_k] = 0; kt_last = clock64(); } } while (0)
#define KT_OUT() do { if (threadIdx.x == 0) for (int _k = 0; _k < KT_NREG + 2; ++_k) kt_out[_k] = kt_acc[_k]; } while (0)
extern "C" int kt_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, kt_out, sizeof(long long) * (KT_NREG + 2));
}
"""
NREG = 24  # KT_NREG: region slots, then the counts of place() calls and items

REGIONS = ("setup", "wait_items", "first_prefetch", "branch", "place_a_slots", "place_a_rows", "place_a_reduce",
           "place_barrier", "place_b", "place_c", "item_end_wait", "final")
# (unique text, stamp before or after it, region it closes; None starts)
STAMPS = (
    ("  k.g_hbw = scratch + S.hbw;\n", "after", None),
    ("  // wait for the item blocks", "before", "setup"),
    ("  if (W > 0 && FITS) prefetch_item(k, a, 0, 0);", "before", "wait_items"),
    ("  int xc = 0, pc = 0;", "before", "first_prefetch"),
    ("  const int nch = C::kSharded ? (max(ahi - k.base(), 0) + NT - 1) / NT : (oc0 + NT - 1) / NT;\n", "after",
     "branch"),
    ("  float bv = __int_as_float(0x7f800000);\n", "before", "place_a_slots"),
    ("  for (int off = 16; off > 0; off >>= 1) {\n", "before", "place_a_rows"),
    ("    s.xmax[b1][w] = mx;\n  }\n", "after", "place_a_reduce"),
    ("  // -- gprefix, second half", "before", "place_barrier"),
    ("  // -- update: the takes of the open slots", "before", "place_b"),
    ("  oc = wadd(oc0, m);", "before", "place_c"),
    ("    cp_async_wait_all();  // item i+1's data\n", "before", "branch"),
    ("    cp_async_wait_all();  // item i+1's data\n    __syncthreads();\n", "after", "item_end_wait"),
    ("  if (tid == 0) a.open_count[X::kSharded ? k.shard : 0] = oc;", "before", "final"),
)


HEADER = "pack_scan_common.cuh"


def whole_source(path: Path) -> str:
    """The source at `path` with the shared header it includes (from the
    same directory) put in place of its #include: one text to stamp and
    to build."""
    src = path.read_text()
    inc = f'#include "{HEADER}"'
    if inc in src:
        src = src.replace(inc, (path.parent / HEADER).read_text().replace("#pragma once\n", ""))
    return src


def stamped_source(src: str) -> str:
    """The stamped copy of `src`."""
    R = {name: k for k, name in enumerate(REGIONS)}
    # room for the stamps' static shared memory beside a tile sized to the limit
    src = src.replace("#define SMEM_LIMIT 232448", "#define SMEM_LIMIT (232448 - 256)")
    for text, where, region in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"anchor {text!r} not found once: not a source these stamps are for")
        if region is None:
            stamp = "KT_START();\n"
        else:
            stamp = f"KT_ST({R[region]});"
            stamp += {"place_c": " KT_COUNT(0);", "item_end_wait": " KT_COUNT(1);", "final": " KT_OUT();"}.get(region, "")
            stamp += "\n"
        src = src.replace(text, stamp + text if where == "before" else text + stamp)
    head = src.index("#include <stdint.h>") + len("#include <stdint.h>")
    return src[:head] + "\n" + PREAMBLE + src[head:]


def build_one(text: str, stem: str):
    """The loaded library of one pack_scan source text."""
    from karpenter_tpu_torch.kernels import build

    out_dir = ROOT / "build" / "stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{stem}.cu"
    cu.write_text(text)
    lib_path = out_dir / f"lib{stem}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib_path)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    print(res.stdout, file=sys.stderr)
    if res.returncode != 0:
        raise SystemExit("nvcc failed")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kt_pack_scan.argtypes = [vp, vp, vp]
    lib.kt_pack_scan.restype = ci
    if "kt_stamps" in text:
        lib.kt_stamps.argtypes = [vp]
        lib.kt_stamps.restype = ci
    lib.kt_pack_scan_scratch.argtypes = [vp]
    lib.kt_pack_scan_scratch.restype = ctypes.c_longlong
    return lib


def event_ms(fn, reps: int = 3, rounds: int = 5) -> float:
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def main() -> int:
    import os

    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    import chip_smoke
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import feasibility_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain

    dev = torch.device("cuda")
    src = whole_source(Path(sys.argv[1]))
    text = stamped_source(src)
    with ThreadPoolExecutor(2) as ex:
        stamped, unstamped = ex.map(lambda ts: build_one(*ts), ((text, "pack_scan_stamped"),
                                                                (src, "pack_scan_unstamped")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    for name in (chip_smoke.HEADLINE, chip_smoke.HEADLINE_AFF, chip_smoke.FLEET, chip_smoke.FLEET_BIG):
        _problem, _ref, t, items, _nnz = chip_smoke.prepare(name, dev)
        compat, key = feasibility_plain(t, items)
        t0 = time.perf_counter()
        takes_p, left_p, _ = pack_scan_plain(t, items, n_slots=t.n_slots, precomputed=(compat, key))
        ok = True
        try:
            build._lib = stamped
            takes, left, state = pack_scan(t, items, compat, key, n_slots=t.n_slots)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (NREG + 2))()
            build.check(stamped.kt_stamps(ctypes.addressof(buf)), "kt_stamps")
            ok &= torch.equal(takes, takes_p) and torch.equal(left, left_p)
            stamped_ms = event_ms(lambda: pack_scan(t, items, compat, key, n_slots=t.n_slots))
            build._lib = unstamped
            takes, left, state = pack_scan(t, items, compat, key, n_slots=t.n_slots)
            ok &= torch.equal(takes, takes_p) and torch.equal(left, left_p)
            unstamped_ms = event_ms(lambda: pack_scan(t, items, compat, key, n_slots=t.n_slots))
        finally:
            build._lib = None  # the port's own library, built on its next use
        cycles = list(buf)[: len(REGIONS)]
        total = sum(cycles)
        line = dict(fixture=name, equal_plain=ok, places=int(buf[NREG]), items=int(buf[NREG + 1]),
                    total_cycles=total, stamped_ms=stamped_ms, unstamped_ms=unstamped_ms,
                    cycles={k: v for k, v in zip(REGIONS, cycles)},
                    share={k: v / total for k, v in zip(REGIONS, cycles)},
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
