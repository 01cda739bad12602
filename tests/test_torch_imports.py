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
    "repro_torch.core.placement", "repro_torch.launch.mesh",
    "repro_torch.core.combining", "repro_torch.core.faults",
    "repro_torch.core.flat_combining", "repro_torch.core.locks",
    "repro_torch.core.seq_pq", "repro_torch.core.skiplist_pq",
    "repro_torch.core.substrate", "repro_torch.kernels",
    "repro_torch.kernels._build", "repro_torch.kernels._common",
    "repro_torch.kernels.heap_kmin", "repro_torch.kernels.heap_kmin.ref",
    "repro_torch.kernels.heap_sift", "repro_torch.kernels.heap_sift.ref",
    "repro_torch.kernels.heap_insert",
    "repro_torch.kernels.heap_insert.ref",
    "repro_torch.core.dynamic_graph", "repro_torch.core.device_graph",
    "repro_torch.core.read_opt", "repro_torch.core.seq_union_find",
    "repro_torch.core.batched_union_find", "repro_torch.core.pc_union_find",
    "repro_torch.kernels.label_prop", "repro_torch.kernels.label_prop.ops",
    "repro_torch.kernels.label_prop.ref",
    "repro_torch.kernels.sorted_merge", "repro_torch.kernels.sorted_merge.ops",
    "repro_torch.kernels.sorted_merge.ref", "repro_torch.core.seq_map",
    "repro_torch.core.batched_map", "repro_torch.core.pc_map",
    "repro_torch.core.seq_sketch", "repro_torch.core.batched_sketch",
    "repro_torch.core.pc_sketch", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.linear_scan", "repro_torch.kernels.linear_scan.ops",
    "repro_torch.kernels.linear_scan.ref", "repro_torch.models",
    "repro_torch.models.recurrent", "repro_torch.models.moe",
    "repro_torch.models.mla",
    "repro_torch.models.config", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.transformer",
    "repro_torch.models.lm", "repro_torch.models.convert",
    "repro_torch.configs", "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.serving", "repro_torch.serving.scheduler",
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.optim.compress",
    "repro_torch.optim.tree", "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpoint", "repro_torch.launch.steps",
    "repro_torch.launch.train", "repro_torch.kernels._sharded",
    "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
] + [f"repro_torch.configs.{a}" for a in (
    "deepseek_v2_lite_16b", "gemma2_2b", "hubert_xlarge", "internlm2_20b",
    "llama4_scout_17b_a16e", "llama_3_2_vision_11b", "qwen2_0_5b",
    "recurrentgemma_2b", "rwkv6_3b", "yi_6b")]


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
from repro_torch.core import (BatchedMap, BatchedPriorityQueue,
                              BatchedUnionFind, DeviceGraph, DynamicGraph,
                              ShardedBatchedPQ, ShardedMap, ShardedSketch,
                              pc_adaptive_graph, pc_adaptive_map,
                              pc_adaptive_sketch, pc_batched_union_find,
                              pc_megapass_map, pc_megapass_priority_queue,
                              pc_sharded_map, pc_sharded_priority_queue,
                              pc_sharded_sketch)
for make in (lambda: ShardedBatchedPQ(64, 4),
             lambda: BatchedPriorityQueue(64, 4),
             lambda: pc_sharded_priority_queue(64, 4, n_shards=2),
             lambda: ShardedBatchedPQ(64, 4, device="cuda"),
             lambda: DeviceGraph(16, edge_capacity=64, c_max=4),
             lambda: DynamicGraph(16),
             lambda: BatchedUnionFind(16),
             lambda: pc_adaptive_graph(16, edge_capacity=64, c_max=4),
             lambda: pc_batched_union_find(16),
             lambda: pc_megapass_priority_queue(64, 4),
             lambda: ShardedMap(64, 4),
             lambda: BatchedMap(64, 4),
             lambda: pc_sharded_map(64, 4, key_range=(0.0, 1.0)),
             lambda: pc_megapass_map(64, 4, key_range=(0.0, 1.0)),
             lambda: pc_adaptive_map(64, 4, key_range=(0.0, 1.0)),
             lambda: ShardedSketch(64, 4),
             lambda: pc_sharded_sketch(64, 4),
             lambda: pc_adaptive_sketch(64, 4)):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
print("refused")
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0 and "refused" in r.stdout, r.stdout + r.stderr


def test_model_entry_points_refuse_to_run_without_cuda():
    """The model stack's entry points, like the structures', take
    ``device=None`` as the card and raise without one: for a dense and
    both recurrent configs."""
    code = """
import pytest
from repro_torch import configs
from repro_torch.launch.serve import DecodeExecutor
from repro_torch.models import convert, init_cache, model_init
for arch in ("qwen2_0_5b", "rwkv6_3b", "recurrentgemma_2b"):
    cfg = configs.get_reduced(arch)
    for make in (lambda: model_init(0, cfg),
                 lambda: model_init(0, cfg, device="cuda"),
                 lambda: init_cache(cfg, 2, 16),
                 lambda: DecodeExecutor(cfg),
                 lambda: convert.tree_from_numpy({"a": [1.0]})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
print("refused")
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0 and "refused" in r.stdout, r.stdout + r.stderr


def test_trainer_refuses_to_run_without_cuda():
    """``train`` and its CLI take ``device=None`` / no ``--device`` as
    the card and raise without one."""
    code = """
import pytest
from repro_torch.launch.train import main, train
with pytest.raises(RuntimeError, match="no CUDA device"):
    train("qwen2_0_5b", steps=1)
with pytest.raises(RuntimeError, match="no CUDA device"):
    main(["--arch", "qwen2_0_5b", "--steps", "1"])
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
    assert srcs == ["flash_attention.cu", "heap_insert.cu", "heap_kmin.cu",
                    "heap_sift.cu", "label_prop.cu", "rglru_scan.cu",
                    "rglru_scan_bwd.cu", "rwkv6_scan.cu",
                    "rwkv6_scan_bwd.cu", "sorted_merge.cu"]
    for name in srcs:
        text = (PORT / "kernels" / "csrc" / name).read_text()
        assert "src/repro/kernels/" in text          # names what it replaces
        assert "cudaGetLastError" in text

