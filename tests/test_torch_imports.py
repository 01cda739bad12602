"""The port stands alone: no JAX, no reference package, the card by default.

Each check runs in a fresh interpreter so that nothing this test process
already imported (it imports both packages elsewhere) can hide a leak.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
MODULES = [
    "repro_torch", "repro_torch.core", "repro_torch.core.batched_pq",
    "repro_torch.core.sharded_pq", "repro_torch.core.pc_pq",
    "repro_torch.core.combining", "repro_torch.core.faults",
    "repro_torch.core.flat_combining", "repro_torch.core.locks",
    "repro_torch.core.seq_pq", "repro_torch.core.skiplist_pq",
    "repro_torch.core.substrate", "repro_torch.kernels",
    "repro_torch.kernels._build", "repro_torch.kernels._common",
    "repro_torch.kernels.heap_kmin", "repro_torch.kernels.heap_kmin.ref",
    "repro_torch.kernels.heap_sift", "repro_torch.kernels.heap_sift.ref",
    "repro_torch.kernels.heap_insert",
    "repro_torch.kernels.heap_insert.ref",
]


def _run(code: str, **env):
    full = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
                **env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=240)


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in MODULES]
        + ["import chip_smoke",
           "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'jaxlib', 'repro'))",
           "print('BAD', bad)", "assert not bad, bad"])
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_have_no_jax_or_reference_imports():
    pat = re.compile(r"^\s*(import|from) (jax|repro)\b", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


def test_entry_points_refuse_to_run_without_cuda():
    """``device=None`` means the card: with no CUDA device the entry
    points raise instead of running on the CPU."""
    code = """
import pytest
from repro_torch.core import (BatchedPriorityQueue, ShardedBatchedPQ,
                              pc_sharded_priority_queue)
for make in (lambda: ShardedBatchedPQ(64, 4),
             lambda: BatchedPriorityQueue(64, 4),
             lambda: pc_sharded_priority_queue(64, 4, n_shards=2),
             lambda: ShardedBatchedPQ(64, 4, device="cuda")):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
print("refused")
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0 and "refused" in r.stdout, r.stdout + r.stderr


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """Without a card — or copied away from the repository — the script
    exits non-zero before printing any result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_kernel_sources_ship_with_the_package():
    srcs = sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu"))
    assert srcs == ["heap_insert.cu", "heap_kmin.cu", "heap_sift.cu"]
    for name in srcs:
        text = (PORT / "kernels" / "csrc" / name).read_text()
        assert "src/repro/kernels/" in text          # names what it replaces
        assert "cudaGetLastError" in text

