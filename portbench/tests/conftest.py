"""A benchmark tree at test size: the repository's ``BENCHMARK.json`` and
``portbench/`` copied under a temporary directory, with tiny cells added
as data (``data/``), run on the CPU in process."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
TINY_CELLS = {
    "tiny-rwkv6.serve": ("tiny-rwkv6", "tiny-serve"),
    "tiny-rwkv6.train": ("tiny-rwkv6", "tiny-train"),
    "tiny-deepseek.train": ("tiny-deepseek", "tiny-train"),
}


def make_tree(root: Path, limits: dict) -> Path:
    """``root`` with a copy of the benchmark plus the tiny cells; returns
    it.  ``limits``: cell -> {number: limit}."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for conf in {c for c, _ in TINY_CELLS.values()}:
        shutil.copy(DATA / f"{conf}.json", root / "portbench" / "configs")
        bench["configs"].append({"name": conf, "source": "test",
                                 "file": f"portbench/configs/{conf}.json",
                                 "reduced": [], "why": "test"})
    for mix in {t for _, t in TINY_CELLS.values()}:
        shutil.copy(DATA / f"{mix}.json", root / "portbench" / "traffic")
    for name, (conf, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": mix, "chips": 1, "why": "t"})
        lim = {k: {"limit": v} for k, v in limits.get(name, {}).items()}
        (root / "portbench" / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": lim}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c in TINY_CELLS if c.endswith("train")]
    # serving's metrics, whose cell is not in BENCHMARK.json (PERF.md
    # section 7), for the tiny serving cell
    serve = json.loads((DATA / "serve-metrics.json").read_text())
    for key in ("end_to_end", "per_layer"):
        bench[key] += serve[key]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


# limits at test size, from six seeds on the CPU (d_model 64 in bf16 is
# noisier than the cells' widths): above the port's readings, below the
# planted faults' and, for one number at least, the float8 control's
TINY_LIMITS = {
    "tiny-rwkv6.serve": {"gap_max": 0.1, "short_answers": 0},
    "tiny-rwkv6.train": {"loss_gap": 0.025, "grad_gap": 0.2,
                         "change_gap": 0.09},
    "tiny-deepseek.train": {"loss_gap": 0.012, "grad_gap": 0.025,
                            "change_gap": 0.08},
}


@pytest.fixture
def tiny_tree(tmp_path):
    return make_tree(tmp_path, TINY_LIMITS)
