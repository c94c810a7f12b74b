"""The kernel build is safe for processes that start together (shard
workers on one card): each holds an exclusive lock on the hash directory's
`.build.lock` from its check for the library to the library's rename, so of
two processes racing a fresh directory exactly one runs nvcc and the other
loads its library. nvcc is a stub here (a script that logs each call and
writes the output file), so the race runs on the CPU. And
`solver.gpu.configure_compile_cache` claims `KARPENTER_SOLVER_COMPILE_CACHE`
as the build directory."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

from karpenter_tpu_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]

STUB = textwrap.dedent("""\
    #!/bin/sh
    echo "$$ $*" >> "{log}"
    sleep 0.5
    out=""; prev=""
    for a in "$@"; do
      if [ "$prev" = "-o" ]; then out="$a"; fi
      prev="$a"
    done
    : > "$out"
    """)

CHILD = textwrap.dedent("""\
    import sys
    sys.path.insert(0, {root!r})
    from karpenter_tpu_torch.kernels import build
    build.set_build_dir(sys.argv[1])
    print("LIB", build.build())
    """)


def test_two_processes_build_once(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    stub = bindir / "nvcc"
    stub.write_text(STUB.format(log=log))
    stub.chmod(0o755)
    out = tmp_path / "kernels"
    env = {**os.environ, "PATH": f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}"}
    code = CHILD.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    results = [p.communicate(timeout=120) for p in procs]
    for p, (o, e) in zip(procs, results):
        assert p.returncode == 0, e
    libs = {o.split("LIB ", 1)[1].strip() for o, _ in results}
    assert len(libs) == 1 and Path(libs.pop()).exists()
    calls = log.read_text().splitlines()
    assert len(calls) == len(build.SOURCES) + 1  # one process compiled every source and linked
    assert len({c.split()[0] for c in calls[: len(build.SOURCES)]}) == len(build.SOURCES)
    (hash_dir,) = out.iterdir()
    assert len((hash_dir / "builds.log").read_text().splitlines()) == 1
    assert (hash_dir / ".build.lock").exists()


def test_configure_compile_cache_claims_the_build_dir(tmp_path, monkeypatch):
    from karpenter_tpu_torch.solver import gpu

    cache = tmp_path / "shared"
    monkeypatch.setenv("KARPENTER_SOLVER_COMPILE_CACHE", str(cache))
    monkeypatch.setattr(gpu, "_COMPILE_CACHE_DIR", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    assert gpu.configure_compile_cache() == str(cache)
    assert build.BUILD_DIR == cache and (cache / ".karpenter-cache-stamp").exists()
    assert gpu.configure_compile_cache() == str(cache)  # idempotent: the claim is kept
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    monkeypatch.setenv("KARPENTER_SOLVER_COMPILE_CACHE", str(blocker / "cache"))
    assert gpu.configure_compile_cache() is None and build.BUILD_DIR == cache
