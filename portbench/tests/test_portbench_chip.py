"""On the card: the command itself, one short run of each cell, prints a
result line of the contract's shape with ``correct`` true.  Skips without
a CUDA device (decided in the fixture)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import REPO

CELLS = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["device"]["platform"] == "gpu"
    assert res["correct"], res["checks"]
