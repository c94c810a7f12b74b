#!/usr/bin/env python3
"""Where warp 0 of the per-pod pack (K8) spends each pod, by clock64 stamps.

Run on a machine with a CUDA card, from the repository root:

    python3 tools/k8_stamps.py karpenter_tpu_torch/kernels/csrc/perpod_pack.cu

It builds the given source as it is, and a copy with `clock64()` stamps in
thread 0 (lane 0 of warp 0, which decides every pod), each with nvcc into
its own library under `build/stamps/`, and runs both through the
`perpod_pack` wrapper (K1's outputs from the port's own library) at the
headline (5000 pods, at most 45 open slots: warp 0 alone), at
`existing_fleet_3800` (3801 open slots: every warp searches) and on the
synthetic problem that crosses the warp's reach (`chip_smoke`'s "cross"),
each against `perpod_pack_plain`. Each stamp adds the cycles since the
previous stamp to the region it closes; thread 0's time splits into
`begin` (up to the reach, the wait for the loader warp's copy of pod i;
past it, pod i + 2's copies issued and pod i's awaited), `dom_feasible`
(spread_ok_of over the pod's keyed groups), `search` (the first-fit search
over the open slots), `new_slot_row` (rank_ok and the row argmin, only for
a pod that no open slot fits), `decide_update` (z_star, the slot, counts)
and `barriers` (the two block barriers of a pod past the reach). It prints
one JSON line per problem: cycles per pod per region, their share, and the
stamped and unstamped times (CUDA events).

The stamps go at unique text anchors of the current source; a source
without them is refused (re-anchor with any change to K8).
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

REGIONS = ("begin", "dom_feasible", "search", "new_slot_row", "decide_update", "barriers")
NREG = len(REGIONS)
PODS = NREG  # counter: pods placed
PREAMBLE = r"""
#define KT_NREG %d
__shared__ long long kt_acc[KT_NREG + 1];
__shared__ long long kt_last;
__device__ long long kt_out[KT_NREG + 1];
#define KT_ON (threadIdx.x == 0)
#define KT_ST(k) do { if (KT_ON) { long long _n = clock64(); kt_acc[k] += _n - kt_last; kt_last = _n; } } while (0)
#define KT_ADD(k, v) do { if (KT_ON) kt_acc[k] += (v); } while (0)
#define KT_START() do { if (KT_ON) { for (int _k = 0; _k < KT_NREG + 1; ++_k) kt_acc[_k] = 0; kt_last = clock64(); } } while (0)
#define KT_OUT() do { if (KT_ON) for (int _k = 0; _k < KT_NREG + 1; ++_k) kt_out[_k] = kt_acc[_k]; } while (0)
extern "C" int kt_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, kt_out, sizeof(long long) * (KT_NREG + 1));
}
""" % NREG
P1_DFEAS = "      const Pod p = pod_of<SMEM>(c, a, i, nw);\n      const uint32_t dfe0 = dom_feasible<NW>(c, p, false);\n"
P2_DFEAS = "      dfe0 = dom_feasible<NW>(c, pod_of<SMEM>(c, a, i, nw), true);\n"
NEW_ROW = "  if (!use_slot && open < c.N) o_new = new_slot_row<NW>(c, a, p, dfe0, i);\n"
B0 = "    __syncthreads();  // pod i's record and dom_feasible, the state, s_open\n"
B1 = "    __syncthreads();  // every warp's fit is in s_fm\n"
# (unique text, stamp before or after it, stamp code)
STAMPS = (
    ("  // -- phase 1: warp 0 alone", "before", "KT_START();\n"),
    (P1_DFEAS, "before", "KT_ST(0);\n"), (P1_DFEAS, "after", "KT_ST(1);\n"),
    ("      const int found = search_warp<NW, SH1>(c, p, dfe0, open);\n", "after", "KT_ST(2);\n"),
    (NEW_ROW, "before", "KT_ST(4);\n"), (NEW_ROW, "after", "KT_ST(3);\n"),
    ("      *h = wrap_add(*h, 1);\n    }\n  }\n", "after", "KT_ST(4);\nKT_ADD(%d, 1);\n" % PODS),
    (P2_DFEAS, "before", "KT_ST(0);\n"), (P2_DFEAS, "after", "KT_ST(1);\n"),
    (B0, "before", "KT_ST(5);\n"), (B0, "after", "KT_ST(5);\n"),
    ("    search<NW, false>(c, p, warp == 0 ? dfe0 : c.dfeas[0], s_open, warp, NWARP, &s_fm);\n", "after",
     "KT_ST(2);\n"),
    (B1, "after", "KT_ST(5);\n"),
    ("  // -- write the carry back", "before", "KT_OUT();\n"),
)


def stamped_source(src: str) -> str:
    """The stamped copy of `src`."""
    for text, where, code in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"anchor {text!r} found {src.count(text)} times: not a source these stamps are for")
        src = src.replace(text, code + text if where == "before" else text + code)
    inc = "#include <stdint.h>\n"
    return src.replace(inc, inc + PREAMBLE, 1)


def build_one(text: str, stem: str):
    """The loaded library of one perpod_pack source text."""
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
    lib.kt_perpod_pack.argtypes = [vp, vp, vp]
    lib.kt_perpod_pack.restype = ci
    lib.kt_perpod_pack_scratch.argtypes = [vp]
    lib.kt_perpod_pack_scratch.restype = ctypes.c_longlong
    if "kt_stamps" in text:
        lib.kt_stamps.argtypes = [vp]
        lib.kt_stamps.restype = ci
    return lib


def main() -> int:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack, perpod_pack_plain

    dev = torch.device("cuda")
    path = Path(sys.argv[1])
    src = path.read_text()
    text = stamped_source(src)
    with ThreadPoolExecutor(3) as ex:
        own = ex.submit(build.lib)  # the port's library, for K1
        stamped, unstamped = ex.map(lambda ts: build_one(*ts), ((text, "perpod_stamped"), (src, "perpod_unstamped")))
        own.result()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    problems = []
    for name in (chip_smoke.HEADLINE, chip_smoke.FLEET_BIG):
        _problem, _ref, t, pods = chip_smoke.perpod_load(name, dev)
        problems.append((name, t, pods))
    s = chip_smoke.perpod_regime_arrays(*chip_smoke.PERPOD_REGIME_CASES["cross"])
    problems.append(("synthetic cross", *chip_smoke.perpod_tensors(s, dev)))
    own_lib = build.lib()
    try:
        for name, t, pods in problems:
            t0 = time.perf_counter()
            build._lib = own_lib
            compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
            want = perpod_pack_plain(t, pods, compat, key)
            line = dict(source=str(path), problem=name, P=int(pods.pod_req.shape[0]), N=int(t.n_slots),
                        n_existing=int(t.n_existing), open=int(want[4]))
            for label, lib in (("stamped", stamped), ("unstamped", unstamped)):
                build._lib = lib
                got = perpod_pack(t, pods, compat, key)
                torch.cuda.synchronize()
                line[f"{label}_equals_plain"] = all(torch.equal(a, b) for a, b in zip(got, want))
                if label == "stamped":
                    buf = (ctypes.c_longlong * (NREG + 1))()
                    build.check(lib.kt_stamps(ctypes.addressof(buf)), "kt_stamps")
                line[f"{label}_ms"] = chip_smoke.cuda_ms(lambda: perpod_pack(t, pods, compat, key), 3, rounds=3)
            cycles = list(buf)[:NREG]
            pods_n = max(line["P"], 1)
            total = sum(cycles)
            line.update(pods_placed=int(buf[PODS]), total_cycles=total,
                        cycles_per_pod={k: v / pods_n for k, v in zip(REGIONS, cycles)},
                        share={k: v / max(total, 1) for k, v in zip(REGIONS, cycles)},
                        seconds=time.perf_counter() - t0)
            print(json.dumps(line))
    finally:
        build._lib = None  # the port's own library, loaded again on its next use
    return 0


if __name__ == "__main__":
    sys.exit(main())
