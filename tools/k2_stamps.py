#!/usr/bin/env python3
"""Where the time of the one-block pack scan (K2) goes, by clock64 stamps.

Run on a machine with a CUDA card, from the repository root:

    python3 tools/k2_stamps.py karpenter_tpu_torch/kernels/csrc/pack_scan.cu
    git show 2264bf5:karpenter_tpu_torch/kernels/csrc/pack_scan.cu > build/pack_scan_2264bf5.cu
    python3 tools/k2_stamps.py build/pack_scan_2264bf5.cu

It builds the given source as it is, and a copy with `clock64()` stamps in
thread 0, each with nvcc into its own library under `build/stamps/`, and
runs both through the `pack_scan` wrapper on the two headline fixtures and
the two existing fleets (K1's outputs from its plain version; both checked
against the plain pack). Each stamp adds the cycles since the previous
stamp to the region it closes, so thread 0's wall time splits into regions.
It prints one JSON line per fixture: cycles per region, their share, and
the stamped and the unstamped kernel's times (CUDA events). The stamps add a
few cycles each: compare shares, not absolute times, with the unstamped
kernel. The unstamped times of two sources run in one call compare them.

Two sources are known, and any other is refused:
- commit 2264bf5's kernel (one 1024-thread block over all N slots): the
  per-item thread-0 prologue and its barrier, the rows pass and its
  reduction, and inside each `place()` the capacity of thread 0's own slots
  (global loads), the block scan with its barrier, the take write-back, the
  take sum, the row argmin loop and its reduction, the thread-0 decision
  and its barrier, the update loop and the closing sum/or reductions; the
  rest of an item (branch bookkeeping, water-fills, barriers between
  per-domain calls) is `branch`. Stamps go after fixed lines of that source.
- the current kernel (active slot range in shared memory, item data built
  by helper blocks and prefetched): block 0's set-up, its wait for the
  item blocks, inside each `place()` phase A (the slot capacities with
  their warp scans, the row argmin loop, the warp reductions), its exchange
  barrier, phase B (prefixes, takes, the decision) and phase C (the
  update), and per item the wait for the prefetch and the closing barrier;
  the rest is `branch`. Stamps go at unique text anchors.
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

OLD_REGIONS = ("init", "prologue_t0", "prologue_barrier", "rows", "rows_reduce", "branch", "scan_cap",
               "scan_barrier", "scan_take", "take_sum", "argmin_loop", "argmin_reduce", "decision_t0",
               "decision_barrier", "update", "tail_reduce", "final")
# (line of the source, text it must contain, region the stamp after it closes)
OLD_STAMPS = (
    (296, "const int cnt = s.p_cnt;", "branch"),
    (300, "slot_cap(a, s, sc, i, j)", "scan_cap"),
    (303, "__syncthreads();", "scan_barrier"),
    (310, "run += agg;", "scan_take"),
    (312, "block_sum(s, local)", "take_sum"),
    (325, "}", "argmin_loop"),
    (326, "block_argmin(s, best)", "argmin_reduce"),
    (350, "s.p_left = left;", "decision_t0"),
    (352, "__syncthreads();", "decision_barrier"),
    (390, "}", "update"),
    (398, "__syncthreads();", "tail_reduce"),
    (653, "__syncthreads();", "init"),
    (713, "s.branch = hostaff", "prologue_t0"),
    (715, "__syncthreads();", "prologue_barrier"),
    (728, "}", "rows"),
    (731, "__syncthreads();", "rows_reduce"),
    (944, "__syncthreads();", "branch"),
    (956, "}", "final"),
)

NEW_REGIONS = ("setup", "wait_items", "first_prefetch", "branch", "place_a_slots", "place_a_rows", "place_a_reduce",
               "place_barrier", "place_b", "place_c", "item_end_wait", "final")
# (unique text, stamp before or after it, region it closes; None starts)
NEW_STAMPS = (
    ("  k.g_hbw = scratch + S.hbw;\n", "after", None),
    ("  // wait for the item blocks", "before", "setup"),
    ("  if (W > 0) prefetch_item(k, a, s, 0, 0);", "before", "wait_items"),
    ("  int xc = 0, pc = 0;", "before", "first_prefetch"),
    ("  const int oc0 = oc, nch = (oc0 + NT - 1) / NT;\n", "after", "branch"),
    ("  float bv = __int_as_float(0x7f800000);\n", "before", "place_a_slots"),
    ("  for (int off = 16; off > 0; off >>= 1) {\n", "before", "place_a_rows"),
    ("    s.xmax[b1][w] = mx;\n  }\n", "after", "place_a_reduce"),
    ("  // -- gprefix, second half", "before", "place_barrier"),
    ("  // -- update: the takes of the open slots", "before", "place_b"),
    ("  oc = wadd(oc0, m);", "before", "place_c"),
    ("    cp_async_wait_all();  // item i+1's data\n", "before", "branch"),
    ("    cp_async_wait_all();  // item i+1's data\n    __syncthreads();\n", "after", "item_end_wait"),
    ("  if (tid == 0) a.open_count[0] = oc;", "before", "final"),
)

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


def _old_source(src: str) -> str:
    lines = src.split("\n")
    R = {name: k for k, name in enumerate(OLD_REGIONS)}
    inserts: dict = {}
    for line_no, text, region in OLD_STAMPS:
        got = lines[line_no - 1]
        if text not in got:
            raise SystemExit(f"line {line_no} is {got!r}, expected {text!r}: not a source these stamps are for")
        stamp = f"KT_ST({R[region]});"
        if region == "tail_reduce":
            stamp += " KT_COUNT(0);"
        if region == "branch" and line_no == 944:
            stamp += " KT_COUNT(1);"
        if region == "final":
            stamp += " KT_OUT();"
        inserts[line_no] = stamp
    start = next(k for k, s in enumerate(lines) if "Scratch sc = carve(a);" in s and k > 600)
    inserts[start + 1] = "KT_START();"
    out = []
    for k, s in enumerate(lines, start=1):
        out.append(s)
        if k in inserts:
            out.append(inserts[k])
    return "\n".join(out)


def _new_source(src: str) -> str:
    R = {name: k for k, name in enumerate(NEW_REGIONS)}
    # room for the stamps' static shared memory beside a tile sized to the limit
    src = src.replace("#define SMEM_LIMIT 232448", "#define SMEM_LIMIT (232448 - 256)")
    for text, where, region in NEW_STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"anchor {text!r} found {src.count(text)} times: not a source these stamps are for")
        if region is None:
            stamp = "KT_START();\n"
        else:
            stamp = f"KT_ST({R[region]});"
            stamp += {"place_c": " KT_COUNT(0);", "item_end_wait": " KT_COUNT(1);", "final": " KT_OUT();"}.get(region, "")
            stamp += "\n"
        src = src.replace(text, stamp + text if where == "before" else text + stamp)
    return src


def stamped_source(src: str) -> tuple:
    """The stamped copy of `src` and the names of its regions."""
    old = "Scratch sc = carve(a);" in src
    out, regions = (_old_source(src), OLD_REGIONS) if old else (_new_source(src), NEW_REGIONS)
    head = out.index("#include <stdint.h>") + len("#include <stdint.h>")
    return out[:head] + "\n" + PREAMBLE + out[head:], regions


class _OldScratch:
    """A library of the 2264bf5 source, with the scratch size the wrapper
    asks for (that kernel took 5 N + 5 Nrows words)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def kt_pack_scan_scratch(dims_addr):
        dims = (ctypes.c_int * 13).from_address(dims_addr)
        return 5 * dims[1] + 5 * dims[2]


def build_one(text: str, stem: str, old: bool):
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
    lib.kt_pack_scan_limits.argtypes = [vp]
    lib.kt_pack_scan_limits.restype = ci
    if "kt_stamps" in text:
        lib.kt_stamps.argtypes = [vp]
        lib.kt_stamps.restype = ci
    if old:
        return _OldScratch(lib)
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
    src = Path(sys.argv[1]).read_text()
    old = "Scratch sc = carve(a);" in src
    text, regions = stamped_source(src)
    with ThreadPoolExecutor(2) as ex:
        stamped, unstamped = ex.map(lambda ts: build_one(*ts, old), ((text, "pack_scan_stamped"),
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
        cycles = list(buf)[: len(regions)]
        total = sum(cycles)
        line = dict(fixture=name, equal_plain=ok, places=int(buf[NREG]), items=int(buf[NREG + 1]),
                    total_cycles=total, stamped_ms=stamped_ms, unstamped_ms=unstamped_ms,
                    cycles={k: v for k, v in zip(regions, cycles)},
                    share={k: v / total for k, v in zip(regions, cycles)},
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
