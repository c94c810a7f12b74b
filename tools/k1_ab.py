#!/usr/bin/env python3
"""Sources of the feasibility kernel (K1) side by side, on a CUDA card.

Run from the repository root on a machine with a card, for example to hold
the parent commit's kernel against the current one:

    git show HEAD~1:karpenter_tpu_torch/kernels/csrc/feasibility.cu > build/feasibility_parent.cu
    python3 tools/k1_ab.py build/feasibility_parent.cu karpenter_tpu_torch/kernels/csrc/feasibility.cu

A source may carry nvcc defines after a colon (`src.cu:-DNAME=1,-DOTHER=2`).
Each source is built with nvcc (all at once) into its own library under
`build/k1_ab/`, and called directly through its `kt_feasibility` (a source
with `kt_feasibility_scratch` takes the scratch argument, an older one
does not), with the forced-key mask, the outputs and any scratch made once,
at K1's call sites (`chip_smoke.k1_sites`: both headlines' items, the churn
chain's step 1, the headline's 5000 pods, `existing_fleet_3800`,
`caps_wide`). Each call is held bit for bit against `compat_and_key_plain`
(a source that differs is named in its line and still timed), then timed
graph-replayed (device time) in four rounds that alternate the order of the
sources. Prints the card, then one JSON line per source with the median
ms per site, each round's and each kernel's SASS instruction count
(`cuobjdump`).
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


def build_lib(spec: str, stem: str):
    """The loaded library of one feasibility source (`path[:defines]`)."""
    from karpenter_tpu_torch.kernels import build

    path, _, defines = spec.partition(":")
    out_dir = ROOT / "build" / "k1_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{stem}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *[d for d in defines.split(",") if d], "-shared", path,
           "-o", str(lib_path)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    print(f"== {spec}\n{res.stdout}", file=sys.stderr)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {spec}")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.scratch = hasattr(lib, "kt_feasibility_scratch")
    lib.kt_feasibility.argtypes = [vp] * 8 + [ci] * 6 + [vp] * (4 if lib.scratch else 3)
    lib.kt_feasibility.restype = ci
    if lib.scratch:
        lib.kt_feasibility_scratch.argtypes = [ci] * 6
        lib.kt_feasibility_scratch.restype = ctypes.c_longlong
    lib.sass = sass_size(lib_path, build)
    return lib


def sass_size(lib_path: Path, build) -> dict:
    """Instructions of each kernel in the library, from cuobjdump's SASS
    (empty where the toolkit has no cuobjdump)."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            sizes[name] = 0
        elif name and line.strip().startswith("/*") and "*/" in line and line.strip()[2:6] != "----":
            sizes[name] += 1
    return sizes


def direct(lib, t, masks, taints_ok, req, dev):
    """A call of `lib`'s kernel on these inputs, with everything it needs
    made here; returns (call, compat, key)."""
    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import forced_key_mask

    B, K, Words = masks.shape
    Nrows, R = t.row_alloc.shape
    C = taints_ok.shape[1]
    keep = [t.row_labels, t.row_taint_class, t.row_alloc, t.row_pool_rank, masks, taints_ok, req,
            forced_key_mask(t.dom_keys, K, dev)]
    compat = torch.empty((B, Nrows), dtype=torch.bool, device=dev)
    key = torch.empty((B, Nrows), dtype=torch.float32, device=dev)
    tail = []
    if lib.scratch:
        words = lib.kt_feasibility_scratch(B, Nrows, K, Words, C, R)
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        keep.append(scratch)
        tail = [scratch.data_ptr() if words else None]

    def call():
        rc = lib.kt_feasibility(*[x.data_ptr() for x in keep[:8]], B, Nrows, K, Words, C, R, compat.data_ptr(),
                                key.data_ptr(), *tail, build.stream_ptr(dev))
        build.check(rc, "feasibility")

    return call, compat, key


def main() -> int:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    import chip_smoke
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key_plain

    dev = torch.device("cuda")
    specs = sys.argv[1:]
    with ThreadPoolExecutor(len(specs) + 1) as ex:
        own = ex.submit(build.lib)  # the port's library, for the chain's solve
        libs = list(ex.map(lambda a: build_lib(*a), ((s, f"k1_{i}") for i, s in enumerate(specs))))
        own.result()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    sites = chip_smoke.k1_sites(dev, chip_smoke.drive_chain(chip_smoke.CHURN, dev))
    calls, wrong = {}, {s: [] for s in specs}
    for name, (t, *args) in sites.items():
        want = compat_and_key_plain(t, *args)
        for spec, lib in zip(specs, libs):
            call, compat, key = direct(lib, t, *args, dev)
            call()
            torch.cuda.synchronize()
            if not (torch.equal(compat, want[0]) and torch.equal(key.view(torch.int32), want[1].view(torch.int32))):
                wrong[spec].append(name)
            calls[spec, name] = call
    times = {(s, n): [] for s in specs for n in sites}
    for rnd in range(4):
        for spec in (specs if rnd % 2 == 0 else specs[::-1]):
            for name in sites:
                times[spec, name].append(chip_smoke.graph_ms(calls[spec, name], 20))
    for spec, lib in zip(specs, libs):
        print(json.dumps({"source": spec, "differs_from_plain_at": wrong[spec], "sass_instructions": lib.sass,
                          "graph_ms": {n: statistics.median(times[spec, n]) for n in sites},
                          "rounds": {n: times[spec, n] for n in sites}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
