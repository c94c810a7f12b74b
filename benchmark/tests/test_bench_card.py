"""A cell run on the card, as the benchmark's check runs it (skips without
one)."""

import json
import subprocess
import sys

import pytest
from bench_support import ROOT


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    workload = "sched2k.burst"
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "17", "--seconds", "10",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
