#!/usr/bin/env python3
"""Sources of the recredit kernel (K4) side by side, on a CUDA card.

Run from the repository root on a machine with a card, for example to hold
commit 2264bf5's kernel against the current one:

    git show 2264bf5:karpenter_tpu_torch/kernels/csrc/recredit.cu > build/recredit_2264bf5.cu
    python3 tools/k4_ab.py build/recredit_2264bf5.cu karpenter_tpu_torch/kernels/csrc/recredit.cu

Each source is built with nvcc (all at once) into its own library under
`build/k4_ab/`. The headline churn chain is driven once through
`GPUSolver.solve_encoded` (`chip_smoke.drive_chain`) to record the recredit
of its step 1. Each source's kernel is held bit for bit against
`recredit_plain` there and on `chip_smoke.recredit_cases` (a case a
source refuses or gets wrong is named in its line), then timed
through the `recredit` wrapper on the step-1 recredit: graph-replayed
(device time) and eagerly (CUDA events, the host's issue included), in four
rounds that alternate the order of the sources (A B, B A, ...), beside
`index_add_` on the same removals. Prints the card, then one JSON line per
source with the median and every round's time.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_lib(src: Path, stem: str):
    """The loaded library of one recredit source."""
    from karpenter_tpu_torch.kernels import build

    out_dir = ROOT / "build" / "k4_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{stem}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(src), "-o", str(lib_path)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    print(f"== {src}\n{res.stdout}", file=sys.stderr)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kt_recredit.argtypes = [vp] * 10 + [ci] * 5 + [vp] * 4
    lib.kt_recredit.restype = ci
    return lib


def main() -> int:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    import chip_smoke
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.recredit import recredit, recredit_plain

    dev = torch.device("cuda")
    srcs = [Path(a) for a in sys.argv[1:]]
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = list(ex.map(lambda ia: build_lib(ia[1], f"recredit_{ia[0]}"), enumerate(srcs)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")

    run = chip_smoke.drive_chain(chip_smoke.CHURN, dev)
    args = run["steps"][1]["seen"]["rc"]
    state, _t, slot_idx, req, _zmem, _hmem = args
    cases = [("churn step 1", *args)] + list(chip_smoke.recredit_cases(dev))
    plains = [recredit_plain(*c[1:]) for c in cases]
    j = torch.clamp(slot_idx, 0, state[1].shape[0] - 1).long()
    upd = torch.where((slot_idx >= 0).unsqueeze(1), req, 0.0)
    scratch = state[1].clone()

    out = [dict(source=str(s), equal_plain=True, graph_ms=[], eager_ms=[]) for s in srcs]
    for rnd in range(4):
        for i in (range(len(libs)) if rnd % 2 == 0 else reversed(range(len(libs)))):
            build._lib = libs[i]
            try:
                if rnd == 0:
                    for case, plain in zip(cases, plains):
                        try:
                            got = recredit(*case[1:])
                            torch.cuda.synchronize()
                            same = chip_smoke.same_carry(got, plain)
                        except RuntimeError as e:  # a launch the source refuses
                            same = False
                            print(f"{srcs[i]}: {e} on {case[0]}", file=sys.stderr)
                        if not same:
                            out[i]["equal_plain"] = False
                            out[i].setdefault("failed", []).append(case[0])
                out[i]["graph_ms"].append(chip_smoke.graph_ms(lambda: recredit(*args), 50))
                out[i]["eager_ms"].append(chip_smoke.cuda_ms(lambda: recredit(*args), 50))
            finally:
                build._lib = None  # the package's own library, loaded on its next use
    library = dict(graph_ms=chip_smoke.graph_ms(lambda: scratch.index_add_(0, j, upd), 50),
                   eager_ms=chip_smoke.cuda_ms(lambda: scratch.index_add_(0, j, upd), 50))
    K = int(slot_idx.shape[0])
    for o in out:
        o.update(K=K, median_graph_ms=statistics.median(o["graph_ms"]),
                 median_eager_ms=statistics.median(o["eager_ms"]), index_add=library)
        print(json.dumps(o))
    return 0 if all(o["equal_plain"] for o in out) else 1


if __name__ == "__main__":
    sys.exit(main())
