"""One run of one cell: find its files by name, run its mix, read its
metrics, judge its check, print its result line.

Everything a cell needs is found from ``BENCHMARK.json`` by name under
the benchmark's data directory: the configuration's file, the traffic
mix ``traffic/<mix>.json`` (its ``kind`` names the driver, the module
``portbench/<kind>.py``), each per-layer metric's reader
``metrics/<metric>.py`` (a ``read(run)`` that returns a number, or
``None`` where it finds nothing to read) and the cell's limits
``limits/<cell>.json``.  A later cell, configuration or
metric is new files and new entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is, whole, one of
    :data:`FORBIDDEN` (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    hooks that time set-up and hand the device over to the check."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float, control=None):
        self.root = Path(root)
        self.data = self.root / "portbench"
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(self.root / confs[self.cell["config"]]["file"])
        self.traffic = load_json(self.data / "traffic"
                                 / f"{self.cell['traffic']}.json")
        lim = self.data / "limits" / f"{workload}.json"
        self.limits = load_json(lim)["limits"] if lim.exists() else {}
        self.seed = int(seed)
        self.weight_seed = int(np.random.SeedSequence(
            [self.seed % (1 << 64), 4]).generate_state(1, np.uint64)[0]
            >> np.uint64(1))
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.control = control
        self.t_start = t_start
        self.t_window: Optional[float] = None
        self.peak = 0

    # -- the system under test ------------------------------------------
    def arch(self):
        """The port's ``ArchConfig``: its registry entry with the
        configuration file's overrides (``a.b`` sets field b of field a)."""
        from repro_torch import configs

        port = self.config["port"]
        cfg = configs.get(port["arch"])
        for key, val in port.get("overrides", {}).items():
            if "." in key:
                outer, inner = key.split(".", 1)
                cfg = cfg.with_(**{outer: dataclasses.replace(
                    getattr(cfg, outer), **{inner: val})})
            else:
                cfg = cfg.with_(**{key: val})
        return cfg

    def weights(self):
        """The weights both sides get, drawn by the benchmark from the
        seed on the device (the family's ``reference/<family>.py``
        ``init``), in the layout and dtypes the program takes."""
        from . import checks

        return checks.reference_module(self.config).init(
            self.config, self.weight_seed, self.device)

    def reference_weights(self, requires_grad: bool = False):
        """The same weights drawn again from the seed, in f32 for the
        reference."""
        import torch

        from .reference.common import tree_to

        drawn = self.weights()

        def f32(t):
            out = t.detach().float().clone()
            return out.requires_grad_(requires_grad)

        with torch.no_grad():
            W = tree_to(drawn, f32)
        del drawn
        self.free()
        return W

    # -- hooks -----------------------------------------------------------
    def sync(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def window_started(self, t: float) -> None:
        self.t_window = t

    def window_closed(self) -> None:
        found = forbidden_loaded()
        if found:
            raise ImportError(f"loaded in this process: {found}")

    def mark_peak(self) -> None:
        import torch

        self.sync()
        if self.device != "cpu":
            self.peak = int(torch.cuda.max_memory_allocated())


def _reader(data: Path, name: str):
    path = data / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control=None,
             t_start: Optional[float] = None) -> Dict[str, Any]:
    """Runs the cell once; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Context(root, workload, seed, seconds, trace, device, t_start,
                  control)
    driver = importlib.import_module(f"portbench.{ctx.traffic['kind']}")
    res = driver.run(ctx)
    name = ctx.cell["name"]
    run = dict(res, config=ctx.config, traffic=ctx.traffic, cell=ctx.cell)
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in ctx.bench["end_to_end"]:
            if not _applies(m, name):
                continue
            val = (ctx.t_window - ctx.t_start if m["name"] == "setup_s"
                   else res["end_to_end"].get(m["name"]))
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        for m in ctx.bench["per_layer"]:
            if not _applies(m, name):
                continue
            val = _reader(ctx.data, m["name"])(run)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": "cpu" if device == "cpu" else "gpu",
                           "kind": _device_name(device), "count": 1,
                           "memory_peak_bytes": ctx.peak}
    out: Dict[str, Any] = {}
    tr = res.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(10)}
    rows = _judge(res["check"], ctx.limits)
    correct = bool(rows) and all(ok for *_, ok in rows) and \
        res["failed"] == 0
    found = forbidden_loaded()
    if found:
        raise ImportError(f"loaded in this process: {found}")
    result = {"correct": correct, "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": dev}
    result.update(out)
    result["readings"] = dict(res.get("readings", {}),
                              **{k: v for k, v in res["check"].items()
                                 if k not in ctx.limits})
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in rows}
    return result


def _judge(numbers: Dict[str, Any], limits: Dict[str, dict]) -> List[list]:
    rows = []
    for name, lim in limits.items():
        val = numbers.get(name)
        ok = (isinstance(val, (int, float)) and val == val
              and val <= lim["limit"])
        rows.append([name, val, lim["limit"], bool(ok)])
    return rows


def _device_name(device: str) -> str:
    import torch

    if device == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(0)
