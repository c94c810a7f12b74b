#!/usr/bin/env python3
"""Where thread 0 of the per-pod pack (K8) spends each pod, by clock64 stamps,
for one or more checkouts.

Run on a machine with a CUDA card, from the repository root, with each
checkout unpacked under `build/` (for example the parent commit):

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 tools/k8_stamps.py build/parent .

For each checkout it copies the port's package and `chip_smoke.py` to
`build/k8_stamps/<n>/`, puts `clock64()` stamps in thread 0 of the copy's
`perpod_pack.cu` (at text anchors both commit 788fb50's and the current source have),
builds the copy's kernels there and runs its `perpod_pack` wrapper at the
headline (5000 pods), in a process of its own. Each stamp adds the cycles
since the previous one to the region it closes: the wait at the step's first
barrier, the first-fit slot loop, the row argmin loop, the reductions and
the partials barrier, thread 0's decision and update, and its preparation
of the next pod. It prints one JSON line per checkout: cycles per pod per
region, and the stamped kernel's time (CUDA events).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

PREAMBLE = r'''
#define KT_NREG 8
__shared__ long long kt_acc[KT_NREG];
__shared__ long long kt_last;
__device__ long long kt_out[KT_NREG];
#define KT_ST(k) do { if (threadIdx.x == 0) { long long _n = clock64(); kt_acc[k] += _n - kt_last; kt_last = _n; } } while (0)
#define KT_START() do { if (threadIdx.x == 0) { for (int _k = 0; _k < KT_NREG; ++_k) kt_acc[_k] = 0; kt_last = clock64(); } } while (0)
#define KT_OUT() do { if (threadIdx.x == 0) for (int _k = 0; _k < KT_NREG; ++_k) kt_out[_k] = kt_acc[_k]; } while (0)
extern "C" int kt_stamps(long long* out) { return (int)cudaMemcpyFromSymbol(out, kt_out, sizeof(long long) * KT_NREG); }
'''
REGIONS = ("top_barrier", "slot_loop", "row_loop", "reduce_barrier", "decide_update", "prepare")
# (unique text, stamp before or after it, stamp code)
STAMPS = (
    ("    __syncthreads();  // the state and pod i's values are published\n", "after", "KT_ST(0);\n"),
    ("    // masked argmin of the row key over the rows", "before", "KT_ST(1);\n"),
    ("    best_j = (int)__reduce_min_sync", "before", "KT_ST(2);\n"),
    ("    __syncthreads();  // the partials are in; thread 0 decides and updates\n", "after", "KT_ST(3);\n"),
    ("      s.open = oc;\n      if (i + 1 < a.P)", "before", "KT_ST(4);\n"),
    ("  for (int i = 0; i < a.P; ++i) {\n    __syncthreads();  // the state", "before", "KT_START();\n"),
    ("  // -- write the carry back", "before", "KT_OUT();\n"),
)


def stamped_source(src: str) -> str:
    for text, where, code in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"anchor {text!r} found {src.count(text)} times: not a source these stamps are for")
        src = src.replace(text, code + text if where == "before" else text + code)
    for text in ("prepare_pod(a, s, i + 1);\n", "prepare_pod<NW>(a, c, s, i + 1);\n"):
        src = src.replace(text, text + "KT_ST(5);\n")
    head = src.index("#include <stdint.h>") + len("#include <stdint.h>")
    return src[:head] + "\n" + PREAMBLE + src[head:]


def one(copy: str) -> dict:
    sys.path.insert(0, copy)
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack

    dev = torch.device("cuda")
    lib = build.lib()
    lib.kt_stamps.argtypes = [ctypes.c_void_p]
    problem, _ref, t, pods = cs.perpod_load(cs.HEADLINE, dev)
    compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    perpod_pack(t, pods, compat, key)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 8)()
    build.check(lib.kt_stamps(ctypes.addressof(buf)), "kt_stamps")
    ms = cs.cuda_ms(lambda: perpod_pack(t, pods, compat, key), 3)
    return dict(stamped_ms=ms, pods=problem.n_pods, cycles=sum(buf[:len(REGIONS)]),
                cycles_per_pod={k: buf[i] / problem.n_pods for i, k in enumerate(REGIONS)})


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return 0
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for n, tree in enumerate(trees):
        copy = os.path.abspath(os.path.join("build", "k8_stamps", str(n)))
        shutil.rmtree(copy, ignore_errors=True)
        os.makedirs(copy)
        shutil.copytree(os.path.join(tree, "karpenter_tpu_torch"), os.path.join(copy, "karpenter_tpu_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        shutil.copy(os.path.join(tree, "chip_smoke.py"), copy)
        path = os.path.join(copy, "karpenter_tpu_torch", "kernels", "csrc", "perpod_pack.cu")
        with open(path) as f:
            text = stamped_source(f.read())
        with open(path, "w") as f:
            f.write(text)
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", copy], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(tree=tree, **line)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
