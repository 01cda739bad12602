"""Multi-pod dry run: every (arch × shape × mesh) cell on a fake world
(the port of the reference's ``launch/dryrun.py``).

For each cell the dry run:
  1. starts the ``"fake"`` process group at 256 ranks (the 16×16 mesh) or
     512 (2×16×16) — this process is rank 0 of it, and its collectives
     move nothing — and builds the production mesh on it;
  2. builds the cell as the reference's ``build_lowerable`` does (serve
     shapes keep TP for attention archs), with the parameters, optimizer
     state, batch and cache as fake tensors (``FakeTensorMode``: shapes,
     no storage) laid out by ``launch/sharding.py`` as DTensors on the
     axes the cell's layout uses (``layout_mesh``: an axis no spec and
     not the batch names holds replicas, which compute the same);
  3. runs the step once — forward, backward and AdamW for ``train`` —
     under a dispatch mode that counts the local FLOPs
     (``torch.utils.flop_counter``'s formulas) and records every
     collective DTensor issues (the ``_c10d_functional`` ops: kind, dtype,
     elements, bytes of its result, group size) and tracks the bytes of
     the local tensors the step allocates, for their peak (a storage
     counted once however many views share it, freed when its last
     tensor dies; ``torch.distributed._tools.mem_tracker`` counts a
     DTensor's global size, so it is not used);
  4. writes ``<out>/<arch>__<shape>__<mesh>.json``.

The kernels' wrappers return results of the right shapes on fake tensors
and run nothing (``kernels/_sharded.py``), so no plain version's loop runs.
``--device`` (``cuda`` by default) is the device the fake tensors model;
nothing is allocated and no card is needed.

Eager execution pays for every chunk pair of the blockwise attention, so
a ``prefill`` cell runs two cuts of the model — one full period and two
(with the prefix and remainder layers in both) — and scales the
difference to the full depth: FLOPs and collectives are linear in the
number of periods.  Such a record says ``"scaled": true``; its argument
bytes always cover the full depth (they are the full model's shards).

A cell the port does not run sharded (the MoE dispatch, ROADMAP A19b)
fails with its ``NotImplementedError``; a failing cell is recorded as
``fail`` and the run ends with exit code 1, as the reference's does.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_0_5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from collections import Counter
from typing import Any, Dict, List, Optional

import torch

from .. import configs
from ..models import transformer
from ..optim import adamw_init
from ..optim.tree import leaves, tree_map
from . import sharding as sh
from .mesh import make_production_mesh
from .steps import make_decode_step, make_prefill_step, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

_KIND = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
          torch.uint8: "u8", torch.bool: "pred", torch.float64: "f64"}


def collective_traffic_bytes(colls) -> float:
    """Σ per-device link traffic (ring algorithm accounting), a copy of
    the reference's: AR: 2·S·(g-1)/g; AG (S=full output): S·(g-1)/g; RS
    (S=output shard): S·(g-1); A2A: S·(g-1)/g; permute: S.  Each op ×
    its multiplier ``mult``."""
    total = 0.0
    for c in colls:
        g = max(c["group"], 2)
        s = c["bytes"] * c.get("mult", 1)
        if c["kind"] == "all-reduce":
            total += 2 * s * (g - 1) / g
        elif c["kind"] == "all-gather":
            total += s * (g - 1) / g
        elif c["kind"] == "reduce-scatter":
            total += s * (g - 1)            # bytes field is the shard (output)
        elif c["kind"] == "all-to-all":
            total += s * (g - 1) / g
        else:                               # collective-permute
            total += s
    return total


class Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the local FLOPs and records the collectives of what runs
    under it.  DTensor ops are handed back (``NotImplemented``) so DTensor
    desugars them first: the mode then sees the local ops and the
    collectives each rank runs; the ops DTensor's sharding propagation
    runs on global-shaped stand-ins (once an op signature, then cached)
    are not counted."""

    def __init__(self, inputs=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop = flop_registry
        self.flops = 0
        self.colls: Counter = Counter()
        self._live: Dict[int, List[int]] = {}   # storage -> [bytes, refs]
        self.cur = self.peak = 0
        # the arguments' storages: a view of one allocates nothing
        self._args = {_local(t).untyped_storage()._cdata
                      for tree in inputs if tree is not None
                      for t in leaves(tree)}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        e = self._live.get(key)
        if e is None:
            e = self._live[key] = [st.nbytes(), 0]
            self.cur += e[0]
            self.peak = max(self.peak, self.cur)
        e[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        e = self._live[key]
        e[1] -= 1
        if e[1] == 0:
            self.cur -= e[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _propagating():             # shapes only: nothing runs
            return out
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        packet = getattr(func, "_overloadpacket", None)
        if packet in self._flop:
            self.flops += int(self._flop[packet](*args, **kwargs,
                                                 out_val=out))
        ns = getattr(func, "namespace", "")
        if ns == "_c10d_functional" and func.__name__.split(".")[0] in _KIND:
            self._collective(func.__name__.split(".")[0], args, out)
        return out

    def _collective(self, name, args, out):
        from torch.distributed.distributed_c10d import _resolve_process_group

        outs = out if isinstance(out, (list, tuple)) else [out]
        group = _resolve_process_group(args[-1]).size()
        for o in outs:
            n = o.numel()
            self.colls[(_KIND[name], _DTYPE.get(o.dtype, str(o.dtype)), n,
                        n * o.element_size(), group)] += 1

    def inventory(self, scale: int = 1, minus: Optional["Recorder"] = None):
        """The collectives as the reference's records, each with its
        count as ``mult``; with ``minus``, the count here plus ``scale``
        times its excess over ``minus``'s (a two-period run beside a
        one-period run, scaled to the full depth)."""
        keys = set(self.colls) | set(minus.colls if minus else ())
        out = []
        for k in sorted(keys):
            n = self.colls.get(k, 0)
            if minus is not None:
                n += (n - minus.colls.get(k, 0)) * scale
            if n:
                kind, dtype, elems, nbytes, group = k
                out.append({"kind": kind, "dtype": dtype, "elems": elems,
                            "bytes": nbytes, "group": group, "mult": n})
        return out


def _propagating() -> bool:
    """Whether this call comes from DTensor's sharding propagation, which
    runs ops on global-shaped stand-ins to find output shapes: no rank
    allocates those.  The whole stack is searched (a propagation may sit
    under any depth of checkpoint and autograd frames)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _fake_world(n: int, device: str) -> None:
    """The default process group as rank 0 of a fake world of ``n``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def cell_config(arch_id: str, shape_name: str, overrides=None):
    """The cell's config, as the reference's ``build_lowerable`` sets it:
    serve shapes keep TP for attention archs (``pure_dp`` only where every
    mixer is RWKV), set the cache length and drop remat."""
    cfg = configs.get(arch_id)
    spec = configs.SHAPES[shape_name]
    if spec.kind != "train":
        attn_free = all(s.mixer in ("rwkv6",) for s in cfg.period)
        cfg = cfg.with_(decode_cache_len=spec.seq_len, remat=False,
                        pure_dp=cfg.pure_dp and attn_free)
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg


def _fake(x: sh.ShapeDtype, device) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=device)


def _inputs(cfg, spec, mesh, device):
    """(params, opt-or-None, batch, cache-or-None, cache_len-or-None) for
    the cell, every leaf a DTensor over fake shards (a plain fake tensor
    where ``mesh`` is None: every rank holds it whole); call under
    ``FakeTensorMode``."""
    mode = "train" if spec.kind == "train" else "serve"

    def lay(tree, specs):
        return tree if mesh is None else sh.distribute_tree(tree, specs(),
                                                            mesh)

    params = lay(transformer.model_init(0, cfg, device=device),
                 lambda: sh.param_specs(cfg, mesh, mode))
    ins = sh.input_specs(cfg, spec, mesh)
    batch = lay(tree_map(lambda x: _fake(x, device), ins["batch"]),
                lambda: sh.batch_specs(cfg, spec, mesh))
    opt = adamw_init(params) if spec.kind == "train" else None
    cache = None
    if "cache" in ins:
        cache = lay(tree_map(lambda x: _fake(x, device), ins["cache"]),
                    lambda: sh.cache_specs(cfg, mesh, ins["cache"]))
    cache_len = spec.seq_len - 1 if spec.kind == "decode" else None
    return params, opt, batch, cache, cache_len


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _local_bytes(*trees) -> int:
    total = 0
    for tree in trees:
        if tree is None:
            continue
        for t in leaves(tree):
            t = _local(t)
            total += t.numel() * t.element_size()
    return total


def _run_step(cfg, spec, mesh, device):
    """Build the cell's inputs and run its step once.  Returns (the
    recorder, argument bytes a device)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        params, opt, batch, cache, cache_len = _inputs(cfg, spec, mesh,
                                                       device)
        arg_bytes = _local_bytes(params, opt, batch, cache) + (
            4 if cache_len is not None else 0)
        if spec.kind == "train":
            step = make_train_step(cfg, mesh)
            run = lambda: step(params, opt, batch)        # noqa: E731
        elif spec.kind == "prefill":
            step = make_prefill_step(cfg, mesh)
            run = ((lambda: step(params, batch)) if cfg.encoder_only
                   else (lambda: step(params, batch, cache)))
        else:
            step = make_decode_step(cfg, mesh)
            run = lambda: step(params, cache, cache_len, batch)  # noqa
        rec = Recorder((params, opt, batch, cache))
        with rec:
            res = run()
        del res
    return rec, arg_bytes


def _depth(cfg, periods: int):
    return cfg.with_(n_layers=cfg.n_prefix + periods * len(cfg.period)
                     + cfg.n_remainder)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR, device: str = "cuda", overrides=None,
             tag: str = "") -> Dict[str, Any]:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = f"{arch_id}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag
                                                     else "")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell + ".json")

    ok, why = configs.runnable(arch_id, shape_name)
    if not ok:
        rec = {"cell": cell, "status": "skipped", "reason": why}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {cell}: SKIP ({why})")
        return rec

    t0 = time.time()
    n = 512 if multi_pod else 256
    _fake_world(n, device)
    spec = configs.SHAPES[shape_name]
    cfg = cell_config(arch_id, shape_name, overrides)
    mesh = sh.layout_mesh(cfg, make_production_mesh(multi_pod=multi_pod,
                                                    device=device),
                          "train" if spec.kind == "train" else "serve",
                          spec.global_batch)
    scaled = spec.kind == "prefill" and cfg.n_full_periods > 2
    if scaled:
        arg_bytes = _input_bytes(cfg, spec, mesh, device)
        one, _ = _run_step(_depth(cfg, 1), spec, mesh, device)
        two, _ = _run_step(_depth(cfg, 2), spec, mesh, device)
        k = cfg.n_full_periods - 2
        flops = two.flops + (two.flops - one.flops) * k
        colls = two.inventory(scale=k, minus=one)
        temp = two.peak            # a prefill's temporaries are a layer's
    else:
        rec_, arg_bytes = _run_step(cfg, spec, mesh, device)
        flops, colls, temp = rec_.flops, rec_.inventory(), rec_.peak
    seconds = time.time() - t0

    by_kind: Dict[str, Dict[str, int]] = {}
    for c in colls:
        e = by_kind.setdefault(c["kind"], {"count": 0, "bytes": 0})
        e["count"] += c["mult"]
        e["bytes"] += c["bytes"] * c["mult"]
    rec = {
        "cell": cell, "status": "ok", "arch": arch_id, "shape": shape_name,
        "mesh": mesh_name, "n_devices": n, "device": device,
        "scaled": scaled, "run_s": round(seconds, 1),
        "layout_axes": list(mesh.mesh_dim_names) if mesh is not None
        else [],
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "temp_peak_bytes": temp,
                   "peak_bytes": arg_bytes + temp},
        "flops": float(flops),
        "collectives": {
            "count": sum(c["mult"] for c in colls),
            "by_kind": by_kind,
            "traffic_bytes_per_device": collective_traffic_bytes(colls),
        },
        "collective_ops": colls,
    }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {cell}: OK run={seconds:.0f}s"
          f"{' (scaled)' if scaled else ''} args/dev="
          f"{arg_bytes / 2**30:.2f}GiB peak/dev="
          f"{(arg_bytes + temp) / 2**30:.2f}GiB flops={flops:.3g} "
          f"colls={rec['collectives']['count']}")
    return rec


def _input_bytes(cfg, spec, mesh, device) -> int:
    """The full-depth inputs' bytes a device, with no step run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        params, opt, batch, cache, cache_len = _inputs(cfg, spec, mesh,
                                                       device)
        return _local_bytes(params, opt, batch, cache) + (
            4 if cache_len is not None else 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["1pod", "2pod", "both"],
                    default="1pod")
    ap.add_argument("--out", type=str, default=OUT_DIR)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose .json already says ok/skipped")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors model: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)

    meshes = {"1pod": [False], "2pod": [True], "both": [False, True]}[args.mesh]
    cells: List = []
    if args.all:
        for a, s, _, _ in configs.cells():
            for mp in meshes:
                cells.append((a, s, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    failures = []
    for a, s, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        path = os.path.join(args.out, f"{a}__{s}__{mesh_name}.json")
        if args.skip_done and os.path.exists(path):
            try:
                with open(path) as f:
                    st = json.load(f).get("status")
            except (OSError, ValueError):
                st = None
            if st in ("ok", "skipped"):
                print(f"[dryrun] {a}__{s}__{mesh_name}: cached {st}")
                continue
        try:
            run_cell(a, s, mp, out_dir=args.out, device=args.device)
        except Exception as e:
            traceback.print_exc()
            failures.append((a, s, mp, repr(e)))
            os.makedirs(args.out, exist_ok=True)
            with open(path, "w") as f:
                json.dump({"cell": f"{a}__{s}__{mesh_name}",
                           "status": "fail", "error": repr(e)}, f, indent=1)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f_ in failures:
            print("   ", f_)
        return 1
    print("[dryrun] all cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
