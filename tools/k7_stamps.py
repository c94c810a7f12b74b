#!/usr/bin/env python3
"""Where the time of one K7 anneal step goes, by clock64 stamps.

Run on a machine with a CUDA card, from the repository root:

    python3 tools/k7_stamps.py karpenter_tpu_torch/kernels/csrc/anneal.cu

It builds the given source as it is, and a copy with `clock64()` stamps in
thread 0 of block 0 (warp 0 runs the tot1 path, the levels above the tot2
windows and the accept test; every warp its own windows), each with nvcc
into its own library under `build/stamps/`, and runs both through the
`anneal` wrapper: on the `anneal_256` consolidation fixture with the
reference's streams (Np = 256) and on the 5000-node fleet of `lp_5000` with
the dense compatibility matrix and streams from `torch.Generator` seed 0
(Np = 8192), each against `anneal_plain`. Each stamp adds the cycles since
the previous stamp to the region it closes; thread 0's wall time splits
into: `setup` (x0's bits, the rows, the counts and x0's sums), `tot1`
(phase A: the flipped window's tot1 path and avg_pod), the two barriers
`b1`, `b2`, `masks` (phase B: the last step's commit, the warp's usable
masks and the changed windows' sums), `tot2_levels` (the levels above the
tot2 windows and the shortfall), `rows_accept` (the cheapest kept row, the
score, the accept test and warp 0's commit), `wait` (for the next step's
prefetch), and `replay` (best_x). Step -1 (x0's score) counts as a step. It also counts
warp 0's windows whose fits mask was re-evaluated (avg_pod left their
interval) and whose usable mask changed. It prints one JSON line
per shape: cycles per step per region, their share, and the stamped and
unstamped times (CUDA events), and the time of the same source with the
common shape (R = 4) sent to the build that reads R at run time
(`generic_r_ms`), which is what the fixed-R build buys.

The stamps go at unique text anchors of the current source; a source
without them is refused (re-anchor with any change to K7).
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

REGIONS = ("setup", "tot1", "b1", "masks", "b2", "rows_accept", "wait", "replay", "tot2_levels")
NREG = len(REGIONS)
CHANGED, STALE, STEPS = NREG, NREG + 1, NREG + 2  # counters: warp 0's changed and re-evaluated windows, steps
PREAMBLE = r"""
#define KT_NREG %d
__shared__ long long kt_acc[KT_NREG + 3];
__shared__ long long kt_last;
__device__ long long kt_out[KT_NREG + 3];
#define KT_ON (threadIdx.x == 0 && blockIdx.x == 0)
#define KT_ST(k) do { if (KT_ON) { long long _n = clock64(); kt_acc[k] += _n - kt_last; kt_last = _n; } } while (0)
#define KT_ADD(k, v) do { if (KT_ON) kt_acc[k] += (v); } while (0)
#define KT_START() do { if (KT_ON) { for (int _k = 0; _k < KT_NREG + 3; ++_k) kt_acc[_k] = 0; kt_last = clock64(); } } while (0)
#define KT_OUT() do { if (KT_ON) for (int _k = 0; _k < KT_NREG + 3; ++_k) kt_out[_k] = kt_acc[_k]; } while (0)
extern "C" int kt_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, kt_out, sizeof(long long) * (KT_NREG + 3));
}
""" % NREG
B1 = "      __syncthreads();  // B1: avg_pod, the last decision, the step's delbits row\n"
B2 = "      __syncthreads();  // B2: every window's proposal sums\n"
FIXED_R = "(R == 4 ? anneal_kernel<true, 4> : anneal_kernel<true, 0>)"
WAIT = "      if (!init && (warp == 0 || warp == nwarps - 1)) __pipeline_wait_prior(1);  // step i + 1's buffers\n"
# (unique text, stamp before or after it, stamp code)
STAMPS = (
    ("    if (*a.flag != 0) return;", "after", "KT_START();\n"),
    ("    for (int i = -1; i < S; ++i) {\n", "before", "KT_ST(0);\n"),
    (B1, "before", "KT_ST(1);\n"), (B1, "after", "KT_ST(2);\n"),
    (B2, "before", "KT_ST(3);\n"), (B2, "after", "KT_ST(4);\n"),
    ("    const bool needs = __any_sync(FULL, need);\n", "after", "KT_ST(8);\n"),
    (WAIT, "before", "KT_ST(5);\n"), (WAIT, "after", "KT_ST(6);\nKT_ADD(%d, 1);\n" % STEPS),
    ("    if (tid == 0) a.best_s[c] = bs;\n", "before", "KT_ST(7);\nKT_OUT();\n"),
    ("      uint32_t sm = __ballot_sync(FULL, vw && stale);\n", "after", "KT_ADD(%d, __popc(sm));\n" % STALE),
    ("      const uint32_t cm = __ballot_sync(FULL, changed);\n", "after", "KT_ADD(%d, __popc(cm));\n" % CHANGED),
)


def stamped_source(src: str) -> str:
    """The stamped copy of `src`."""
    for text, where, code in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"anchor {text!r} found {src.count(text)} times: not a source these stamps are for")
        src = src.replace(text, code + text if where == "before" else text + code)
    inc = '#include "xla_order.cuh"'
    return src.replace(inc, PREAMBLE + inc)


def build_one(text: str, stem: str, csrc: Path):
    """The loaded library of one anneal source text."""
    from karpenter_tpu_torch.kernels import build

    out_dir = ROOT / "build" / "stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{stem}.cu"
    cu.write_text(text)
    lib_path = out_dir / f"lib{stem}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-shared", str(cu), "-o", str(lib_path)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    print(res.stdout, file=sys.stderr)
    if res.returncode != 0:
        raise SystemExit("nvcc failed")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kt_anneal_pack.argtypes = [vp, ci, vp, vp, ci, ci, vp, ctypes.c_longlong] + [vp] * 5
    lib.kt_anneal_pack.restype = ci
    lib.kt_anneal.argtypes = [vp] * 14 + [ci] * 5 + [cf] + [vp] * 4
    lib.kt_anneal.restype = ci
    lib.kt_anneal_scratch.argtypes = [ci] * 5
    lib.kt_anneal_scratch.restype = ctypes.c_longlong
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
    from karpenter_tpu_torch.kernels.anneal import anneal, anneal_plain
    from karpenter_tpu_torch.models.consolidation_model import draw_anneal_streams
    from karpenter_tpu_torch.solver.consolidation import tensors_from_problem

    dev = torch.device("cuda")
    path = Path(sys.argv[1])
    src = path.read_text()
    text = stamped_source(src)
    if src.count(FIXED_R) != 1:
        raise SystemExit(f"{FIXED_R!r} not found: not a source these stamps are for")
    generic = src.replace(FIXED_R, "anneal_kernel<true, 0>")  # R = 4 through the build that reads R
    with ThreadPoolExecutor(3) as ex:
        stamped, unstamped, generic_r = ex.map(lambda ts: build_one(*ts, path.parent),
                                               ((text, "anneal_stamped"), (src, "anneal_unstamped"),
                                                (generic, "anneal_generic_r")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    a_problem, a_ref = chip_smoke.cons_load(chip_smoke.CONS_ANNEAL)
    ta, _ = tensors_from_problem(a_problem, dev, dense_compat=True)
    sa = [torch.as_tensor(a_ref[k], device=dev) for k in ("ref_x0", "ref_flips", "ref_u")]
    problem, _ref = chip_smoke.cons_load(chip_smoke.CONS_LP)
    t8, _ = tensors_from_problem(problem, dev, dense_compat=True)
    s8 = list(draw_anneal_streams(t8.node_price.shape[0], torch.Generator(device=dev).manual_seed(0)))
    try:
        for name, t, streams in ((chip_smoke.CONS_ANNEAL, ta, sa), (f"{chip_smoke.CONS_LP} fleet", t8, s8)):
            t0 = time.perf_counter()
            bx_p, bs_p = anneal_plain(t, *streams)
            line = dict(source=str(path), shape=name, Np=int(t.node_price.shape[0]), T=int(t.row_price.shape[0]),
                        R=int(t.node_used.shape[1]), C=int(streams[1].shape[0]), S=int(streams[1].shape[1]))
            for key, lib in (("stamped", stamped), ("unstamped", unstamped), ("generic_r", generic_r)):
                build._lib = lib
                bx, bs = anneal(t, *streams)
                torch.cuda.synchronize()
                line[f"{key}_equals_plain"] = bool(torch.equal(bx, bx_p) and torch.equal(bs, bs_p))
                if key == "stamped":
                    buf = (ctypes.c_longlong * (NREG + 3))()
                    build.check(lib.kt_stamps(ctypes.addressof(buf)), "kt_stamps")
                line[f"{key}_ms"] = chip_smoke.cuda_ms(lambda: anneal(t, *streams), 3, rounds=3)
            cycles = list(buf)[:NREG]
            steps = int(buf[STEPS])
            total = sum(cycles)
            line.update(steps_counted=steps, total_cycles=total,
                        cycles_per_step={k: v / max(steps, 1) for k, v in zip(REGIONS, cycles)},
                        share={k: v / total for k, v in zip(REGIONS, cycles)},
                        changed_windows_warp0_per_step=buf[CHANGED] / max(steps, 1),
                        reevaluated_windows_warp0_per_step=buf[STALE] / max(steps, 1),
                        seconds=time.perf_counter() - t0)
            print(json.dumps(line))
    finally:
        build._lib = None  # the port's own library, built on its next use
    return 0


if __name__ == "__main__":
    sys.exit(main())
