"""A later cell, configuration, traffic mix and metric are new files and
new entries: the harness finds them by name, and no file that was there
changes."""
from __future__ import annotations

import hashlib
import json

from portbench import harness

from .conftest import DATA

METRIC = '''
"""A throwaway metric: requests a call, doubled."""


def read(run):
    return 2 * run["counters"]["sched_mean_batch"]
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tiny_tree):
    before = _digests(tiny_tree / "portbench")
    data = tiny_tree / "portbench"
    conf = json.loads((DATA / "tiny-rwkv6.json").read_text())
    conf["name"] = "later-model"
    (data / "configs" / "later-model.json").write_text(json.dumps(conf))
    mix = json.loads((DATA / "tiny-serve.json").read_text())
    mix["sessions"] = 3
    (data / "traffic" / "later-mix.json").write_text(json.dumps(mix))
    (data / "metrics" / "later_metric.py").write_text(METRIC)
    (data / "limits" / "later-model.later-mix.json").write_text(json.dumps(
        {"limits": {"gap_max": {"limit": 0.1},
                    "short_answers": {"limit": 0}}}))
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "later-model", "source": "test",
                             "file": "portbench/configs/later-model.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "later-model.later-mix",
                               "config": "later-model",
                               "traffic": "later-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "later_metric", "unit": "x",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["later-model.later-mix"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("later-model.later-mix")
    (tiny_tree / "BENCHMARK.json").write_text(json.dumps(bench))

    res = harness.run_cell(tiny_tree, "later-model.later-mix", 5, 0.3, True,
                           "cpu")
    assert res["correct"]
    assert res["metrics"]["later_metric"]["value"] >= 2
    # a metric whose workloads list leaves the new cell out stays out
    assert "sched_mean_batch" not in res["metrics"]
    e2e = harness.run_cell(tiny_tree, "later-model.later-mix", 5, 0.3,
                           False, "cpu")["metrics"]
    assert {"serve_tokens_per_s", "serve_p95_ms", "setup_s"} <= set(e2e)
    after = _digests(tiny_tree / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
