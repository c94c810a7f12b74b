#!/usr/bin/env python3
"""Where the time of one K5 globalpack Adam step goes, by clock64 stamps.

Run on a machine with a CUDA card, from the repository root:

    python3 tools/k5_stamps.py karpenter_tpu_torch/kernels/csrc/globalpack.cu

It builds the given source as it is, and a copy with `clock64()` stamps in
thread 0 of block 0 (the first block of the first init's cluster), each with
nvcc into its own library under `build/stamps/`, and runs both through the
`globalpack` wrapper on the `lp_5000` consolidation fixture with the
reference's inits (both checked against the plain ascent's d). Each stamp
adds the cycles since the previous stamp to the region it closes, so thread
0's wall time splits into regions. It prints one JSON line: cycles per
region, their share, the steps counted, and the stamped and unstamped
kernel's times (CUDA events).

The stamps go at unique text anchors of the current source; a source
without them is refused. Regions:
- per reduction (`tables`: the class tables; `gdisp`: dL/d disp; `proj`:
  the projection's row sums): the block's own term passes with their
  barriers (`*_pass`), the cluster barrier (`*_cluster`), and the sums of
  the block's own inbox, which the ranks wrote before the barrier, with the
  closing block barrier (`*_gather`);
- `tables_tail` disp and the class scalars, `g_a` dL/d routed over the
  block's nodes, `g_rep` dL/d rep over its rows (and the barrier),
  `gdisp_tail`; the updates with Adam (`node_update` for d and y together,
  `yr_update`), `proj_scale`, `proj_apply`;
- `setup` (norms, inits, first projection) and `final` (the objective).
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

REGIONS = ("setup", "tables_pass", "tables_cluster", "tables_gather", "tables_tail", "g_a", "g_rep",
           "gdisp_pass", "gdisp_cluster", "gdisp_gather", "gdisp_tail", "node_update", "yr_update",
           "proj_pass", "proj_cluster", "proj_gather", "proj_scale", "proj_apply", "final")
# (unique text, stamp before or after it or replacing it, stamp code)
STAMPS = (
    ("  // every rank's partials are in every inbox;", "before", "KT_ST(kt_site);"),
    ("  cl.sync();\n  double* tot = tot_of(p);\n", "replace", "  cl.sync();\n  KT_ST(kt_site + 1);\n  double* tot = tot_of(p);\n"),
    ("  p.buf ^= 1;\n  __syncthreads();\n", "after", "KT_ST(kt_site + 2);\n"),
    ("  cluster_sums<SMEM>(p, RD_TABLES,", "before", "KT_SITE(1);\n"),
    ("    cls_of(p, C_GROUTE)[q] = -((ghcm * cm) * bal(u));\n  }\n  __syncthreads();\n", "after", "KT_ST(4);\n"),
    ("  for (int i = threadIdx.x; i < nt; i += P::kThreads) {\n    float z = -INFINITY;", "before", "KT_ST(5);\n"),
    ("  // dL/d disp\n", "before", "KT_ST(6);\n"),
    ("  cluster_sums<SMEM>(p, RD_GDISP,", "before", "KT_SITE(7);\n"),
    ("  const float corr1 = p.corr[2 * it], corr2 = p.corr[2 * it + 1];\n", "before", "KT_ST(10);\n"),
    ("  // yr: gradient, Adam, first half of the projection; one (row, class) a\n", "before", "KT_ST(11);\n"),
    ("  __syncthreads();\n  project_finish<SMEM>(p);\n}\n", "replace",
     "  __syncthreads();\n  KT_ST(12);\n  project_finish<SMEM>(p);\n  KT_COUNT();\n}\n"),
    ("  cluster_sums<SMEM>(p, RD_PROJ,", "before", "KT_SITE(13);\n"),
    ("    scale[q] = 1.0f / fmaxf(sum, 1e-9f);\n  }\n  __syncthreads();\n", "after", "KT_ST(16);\n"),
    ("f_yr(p, q)[i] = f_yr(p, q)[i] * scale[q];\n  __syncthreads();\n", "after", "KT_ST(17);\n"),
    ("  p.buf = 0;\n", "after", "KT_START();\n"),
    ("  project_finish<SMEM>(p);\n  for (int it = 0; it < n_iters; ++it) step<SMEM>(p, it);\n", "replace",
     "  project_finish<SMEM>(p);\n  KT_ST(0);\n  for (int it = 0; it < n_iters; ++it) step<SMEM>(p, it);\n"),
    ("  if (rank == 0 && threadIdx.x == 0) score[c] = obj;\n", "after", "KT_ST(18);\n  KT_OUT();\n"),
)

PREAMBLE = """
#define KT_NREG 24
__shared__ long long kt_acc[KT_NREG + 1];
__shared__ long long kt_last;
__shared__ int kt_site;
__device__ long long kt_out[KT_NREG + 1];
#define KT_ON (threadIdx.x == 0 && blockIdx.x == 0)
#define KT_ST(k) do { if (KT_ON) { long long _n = clock64(); kt_acc[k] += _n - kt_last; kt_last = _n; } } while (0)
#define KT_SITE(k) do { if (KT_ON) kt_site = (k); } while (0)
#define KT_COUNT() do { if (KT_ON) kt_acc[KT_NREG] += 1; } while (0)
#define KT_START() do { if (KT_ON) { for (int _k = 0; _k < KT_NREG + 1; ++_k) kt_acc[_k] = 0; kt_last = clock64(); } } while (0)
#define KT_OUT() do { if (KT_ON) for (int _k = 0; _k < KT_NREG + 1; ++_k) kt_out[_k] = kt_acc[_k]; } while (0)
extern "C" int kt_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, kt_out, sizeof(long long) * (KT_NREG + 1));
}
"""
NREG = 24


def stamped_source(src: str) -> str:
    """The stamped copy of `src`."""
    for text, where, code in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"anchor {text!r} found {src.count(text)} times: not a source these stamps are for")
        if where == "replace":
            src = src.replace(text, code)
        else:
            src = src.replace(text, code + text if where == "before" else text + code)
    head = src.index("namespace cg = cooperative_groups;")
    return src[:head] + PREAMBLE + src[head:]


def build_one(text: str, stem: str):
    """The loaded library of one globalpack source text."""
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
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kt_globalpack.argtypes = [vp] * 13 + [ci] * 6 + [cf] * 7 + [vp] * 4
    lib.kt_globalpack_scratch.argtypes = [ci] * 5
    lib.kt_globalpack_scratch.restype = ctypes.c_longlong
    lib.kt_globalpack.restype = ci
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
    from karpenter_tpu_torch.kernels.globalpack import globalpack, globalpack_plain
    from karpenter_tpu_torch.solver.consolidation import reference_inits, tensors_from_problem

    dev = torch.device("cuda")
    src = Path(sys.argv[1]).read_text()
    text = stamped_source(src)
    with ThreadPoolExecutor(2) as ex:
        stamped, unstamped = ex.map(lambda ts: build_one(*ts), ((text, "globalpack_stamped"),
                                                                (src, "globalpack_unstamped")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    problem, ref = chip_smoke.cons_load(chip_smoke.CONS_LP)
    t, aux = tensors_from_problem(problem, dev)
    d0, y0 = (torch.as_tensor(a, device=dev) for a in reference_inits(problem, ref))
    n_iters = int(ref["ref_n_iters"])
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0, n_iters)
    t0 = time.perf_counter()
    d_p, _ = globalpack_plain(*args)
    try:
        build._lib = stamped
        d, _ = globalpack(*args)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (NREG + 1))()
        build.check(stamped.kt_stamps(ctypes.addressof(buf)), "kt_stamps")
        err_stamped = float((d - d_p).abs().max())
        stamped_ms = chip_smoke.cuda_ms(lambda: globalpack(*args), 3, rounds=3)
        build._lib = unstamped
        d, _ = globalpack(*args)
        err = float((d - d_p).abs().max())
        unstamped_ms = chip_smoke.cuda_ms(lambda: globalpack(*args), 3, rounds=3)
    finally:
        build._lib = None  # the port's own library, built on its next use
    cycles = list(buf)[: len(REGIONS)]
    total = sum(cycles)
    steps = int(buf[NREG])
    line = dict(source=sys.argv[1], fixture=chip_smoke.CONS_LP,
                C=int(d0.shape[0]), n_iters=n_iters, steps_counted=steps,
                max_abs_d_vs_plain=max(err, err_stamped), total_cycles=total, stamped_ms=stamped_ms,
                unstamped_ms=unstamped_ms, cycles_per_step=(total - cycles[0] - cycles[-1]) / max(steps, 1),
                cycles=dict(zip(REGIONS, cycles)), share={k: v / total for k, v in zip(REGIONS, cycles)},
                seconds=time.perf_counter() - t0)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
