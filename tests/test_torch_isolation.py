"""The port stands alone: it imports neither jax nor the JAX package, and its
default device is CUDA (no silent CPU fallback)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "karpenter_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "karpenter_tpu")

_CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["karpenter_tpu"] = None
    sys.path.insert(0, {root!r})
    import karpenter_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__, "karpenter_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from karpenter_tpu_torch.solver.encoded import load_npz
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    p, ref = load_npz({fixture!r})
    res = GPUSolver(device="cpu").solve_encoded(p)
    assert res.errors == [], res.errors
    assert (res.assignment == ref["ref_assignment"]).all()
    import torch
    torch.cuda.is_available = lambda: False
    try:
        GPUSolver()
    except RuntimeError:
        pass
    else:
        raise SystemExit("GPUSolver() ran without CUDA")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu") and sys.modules[m] is not None)
    assert not leaked, leaked
    print("ISOLATED", len(names))
    """
)


def test_port_runs_without_jax_or_reference():
    code = _CHILD.format(root=str(ROOT), fixture=str(PORT / "fixtures" / "small_existing_affinity.npz"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_no_port_file_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Without a CUDA device it exits non-zero and prints no result; alone in
    a directory it does the same."""
    no_cuda = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT), env=no_cuda)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                          env=no_cuda)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
