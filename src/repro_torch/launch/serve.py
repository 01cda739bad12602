"""Serving: the parallel-combining scheduler over the decode step.

The port of the reference's ``launch/serve.py``.  Wires the paper's
technique end-to-end: concurrent client sessions submit prompts (or
structure operations); the PC scheduler (``serving/scheduler.py`` —
Listing 1 + the §4 batched-PQ ordering) combines them into dense batches
and drives ONE executor call per combining pass over fixed batch slots.

This is continuous batching with explicit synchronization: slots of
finished requests are refilled from the publication list each pass, which
is exactly the paper's claim — a single combiner with batch-parallel
execution beats fine-grained per-request dispatch once concurrency is high.

Differences from the reference:

* ``StructureExecutor`` and ``run_serving`` take ``device`` (``None``
  means the card and raises without one), and the CLI a ``--device`` flag
  whose default is ``cuda``; the tests pass ``cpu``.
* ``--scheduler pc-pallas`` is accepted, so the reference's command
  lines run unchanged, and selects the same path as ``pc``: the port's
  structures have no switch between kernel and plain version — the
  device decides — so no ``use_pallas`` reaches ``spec.make``, and
  ``run_serving`` has no ``graph_use_pallas``.
* ``--mesh-shards`` / ``mesh_shards`` build the mesh on
  ``torch.distributed`` (``launch/mesh.py``), one process a rank: under
  torchrun every rank runs the command, the leader (mesh index 0) serves
  and the others follow its dispatches on their rows (the reference runs
  one controller over every device).
* The decode workload keeps ``configs.get_reduced(arch_id)`` and ``seed``,
  but the port draws its weights from a ``torch.Generator``, so its tokens
  equal the reference's only when the weights are carried across
  (``models/convert.py``).
* ``run_serving`` re-raises the first error a session met (a failed
  future) after every session has ended, instead of returning stats that
  count the lost requests as served.
* ``main`` takes ``argv`` and returns the stats it prints.

Usage (CPU, reduced config):
  python -m repro_torch.launch.serve --device cpu --sessions 8 --requests 4
  python -m repro_torch.launch.serve --device cpu --workload pq \\
      --scheduler pc-async
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \\
      --workload pq --scheduler pc-async --mesh-shards 4
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import configs
from ..core import substrate
from ..core.batched_pq import resolve_device
from ..core.faults import FaultPlan
from ..core.placement import MeshPlacement
from ..models import lm, transformer
from ..serving import PCScheduler, SerialScheduler
from .mesh import make_combining_mesh, world_from_env


class DecodeExecutor:
    """Slot-based batched decode executor.

    Holds a fixed (max_batch, ...) cache; each call takes ≤ max_batch
    (prompt, n_tokens) requests, left-pads the prompts with token 0 (no
    padding mask, positions from 0, as the reference: a recurrent state
    absorbs the padding tokens), prefills them into the slots and greedily
    decodes n_tokens.  The weights are drawn from ``seed`` (``model_init``)
    unless ``params`` are given.  The cache is K/V for attention layers
    (a ring of window + 1 slots for local ones), the latent ``c`` and the
    rope key ``kr`` for MLA layers (deepseek's prefix too), the recurrent
    state for RWKV-6 and RG-LRU layers (O(1) in the context): K/V, MLA's
    latents, the RG-LRU conv history and the RWKV token-shift inputs in
    ``cache_dtype`` (bf16, as the reference's), the recurrent states in
    f32.  It feeds tokens only, as the reference's executor: the VLM's
    image embeddings and HuBERT's frames do not pass through it.  The generated
    tokens stay on the device until one fetch at the end of the call.
    With ``keep_logits`` the call keeps each step's next-token logits in
    ``step_logits`` (prefill first, then each decode step's).
    """

    def __init__(self, cfg, *, max_batch: int = 8, max_len: int = 128,
                 seed: int = 0, device=None, params=None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 keep_logits: bool = False):
        self.cfg = cfg.with_(decode_cache_len=max_len)
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = (params if params is not None else
                       transformer.model_init(seed, self.cfg,
                                              device=self.device))
        self.cache_dtype = cache_dtype
        self._prefill = lm.make_prefill(self.cfg)
        self._decode = lm.make_decode_step(self.cfg)
        self.device_steps = 0
        self.keep_logits = keep_logits
        self.step_logits: List[torch.Tensor] = []

    def __call__(self, reqs: List[Dict[str, Any]]) -> List[np.ndarray]:
        """reqs: [{'prompt': (S,) int32, 'n_tokens': int}] — one combined
        batch; returns per-request generated token arrays."""
        if len(reqs) > self.max_batch:
            raise ValueError(f"{len(reqs)} requests for {self.max_batch} "
                             "slots")
        S = max(len(r["prompt"]) for r in reqs)
        n_gen = max(int(r["n_tokens"]) for r in reqs)
        toks = np.zeros((self.max_batch, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r["prompt"]):] = r["prompt"]   # left-pad
        cache = transformer.init_cache(self.cfg, self.max_batch,
                                       self.max_len, dtype=self.cache_dtype,
                                       device=self.device)
        tokens = torch.from_numpy(toks).to(self.device)
        logits, cache = self._prefill(self.params, {"tokens": tokens}, cache)
        self.device_steps += 1
        self.step_logits = [logits] if self.keep_logits else []
        last = torch.argmax(logits, -1).to(torch.int32)[:, None]
        pos = S
        gen = []
        for _ in range(n_gen):
            gen.append(last[:, 0])
            nxt, step, cache = self._decode(self.params, cache, pos, last)
            self.device_steps += 1
            if self.keep_logits:
                self.step_logits.append(step)
            last = nxt[:, None]
            pos += 1
        out = (torch.stack(gen, 1).cpu().numpy() if gen else
               np.zeros((self.max_batch, 0), np.int32))
        return [out[i, : int(r["n_tokens"])] for i, r in enumerate(reqs)]


class StructureExecutor:
    """Registry-driven structure executor (DESIGN.md §16) — ONE executor
    class serves EVERY registered :class:`~repro_torch.core.substrate.
    StructureSpec` workload (graph, map, pq, sketch, union-find, and any
    future registration) through the protocol surface alone.

    Each combined batch is a list of ``{'method': ..., 'input': ...}``
    requests.  Updates are applied first in arrival order (ONE fused
    mixed-op device pass per ≤ c_max slice via ``update_batch_async``,
    result masks left on device), then ALL reads are answered with one
    vectorized read program whose single fetch also resolves the update
    handles — the §3.3 read-optimized transform with the scheduler's
    combiner loop playing the combiner.  ``megapass=True``
    (DESIGN.md §17) hands the two to ONE ``mixed_rounds`` call — an
    update round followed by a read round.  The PQ, the map and the
    graph fuse the rounds into one dispatch (the PQ's is one CUDA-graph
    replay on the card; a PQ read round of ``values`` takes the base
    per-round dispatch, as in the reference); the sketch and the
    union-find run the protocol's one-pass-per-round fallback, with the
    same answers.  ``device`` (``None``: the card) reaches ``spec.make``.
    """

    def __init__(self, spec: substrate.StructureSpec, *,
                 megapass: bool = False, device=None, **make_kw):
        self.spec = spec
        self.ds = spec.make(device=device, **make_kw)
        self.megapass = bool(megapass) and hasattr(self.ds, "mixed_rounds")
        self.device_steps = 0
        self.megapass_dispatches = 0
        self.megapass_rounds = 0

    def __call__(self, reqs: List[Dict[str, Any]]) -> List[Any]:
        methods = [r["method"] for r in reqs]
        inputs = [r["input"] for r in reqs]
        ro = self.ds.read_only
        upd = [i for i, m in enumerate(methods) if m not in ro]
        reads = [i for i, m in enumerate(methods) if m in ro]
        out: List[Any] = [None] * len(reqs)
        if self.megapass and upd:
            rounds = [("update", [methods[i] for i in upd],
                       [inputs[i] for i in upd])]
            if reads:
                rounds.append(("read", [methods[i] for i in reads],
                               [inputs[i] for i in reads]))
            handles = self.ds.mixed_rounds(rounds)
            self.device_steps += 1
            self.megapass_dispatches += 1
            self.megapass_rounds += len(rounds)
            if reads:
                for i, r in zip(reads, handles[1].result()):
                    out[i] = r
            for i, r in zip(upd, handles[0].result()):
                out[i] = r
            return out
        handle = None
        if upd:
            handle = self.ds.update_batch_async(
                [methods[i] for i in upd], [inputs[i] for i in upd])
            self.device_steps += 1
        if reads:
            res = self.ds.read_batch([methods[i] for i in reads],
                                     [inputs[i] for i in reads])
            for i, r in zip(reads, res):
                out[i] = r
            self.device_steps += 1
        if handle is not None:
            for i, r in zip(upd, handle.result()):
                out[i] = r
        return out


def _structure_requests(spec: substrate.StructureSpec, rng, sessions: int,
                        requests_per_session: int, read_pct: int,
                        serve_kw: Dict[str, Any]) -> List[List[dict]]:
    """Synthetic per-session request tables from the spec's registered
    op generators: ``read_pct``% reads, the rest updates, drawn from ONE
    shared ctx so sessions revisit each other's keys (the duplicate /
    delete-reinsert schedules the combiner nets out)."""
    ctx = spec.new_ctx()
    if isinstance(ctx, dict) and "n" in serve_kw:
        ctx["n"] = serve_kw["n"]          # sizing knob the generators read
    tab = []
    for _ in range(sessions):
        row = []
        for _ in range(requests_per_session):
            gen = (spec.gen_read
                   if spec.gen_read is not None
                   and rng.random() * 100 < read_pct else spec.gen_update)
            ms, ins = gen(rng, 1, ctx)
            row.append({"method": ms[0], "input": ins[0]})
        tab.append(row)
    return tab


def run_serving(arch_id: str = "qwen2_0_5b", *, sessions: int = 8,
                requests_per_session: int = 4, n_tokens: int = 8,
                prompt_len: int = 16, max_batch: int = 8,
                scheduler: str = "pc", seed: int = 0,
                workload: str = "decode", read_pct: int = 90,
                n_vertices: int = 512,
                rounds_cap: int = 4,
                tier: str = "eliminate",
                megapass: bool = False,
                mesh_shards: Optional[int] = None,
                fault_plan: Optional[FaultPlan] = None,
                device=None) -> Dict[str, Any]:
    """Drive ``sessions`` concurrent client sessions through a scheduler.

    ``scheduler``: "serial" (one dispatch per request), "pc" (async
    combiner, blocking per-session submits), "pc-async" (each session
    publishes ALL its requests via ``submit_async`` up front and gathers
    the futures — the non-blocking client API), "pc-nodonate" (ablation:
    the deadline PQ and the structure clone their state every pass
    instead of updating it in place, EXPERIMENTS §Ablations) or
    "pc-pallas" (the reference's kernel row; here the same path as "pc",
    since the device picks the kernels).

    ``workload``: "decode" (LM decode batches over ``DecodeExecutor``)
    or the name of ANY registered batched structure (``repro_torch.core.
    substrate`` — "graph", "map", "pq", "sketch", "unionfind", ...),
    served through the generic :class:`StructureExecutor` with request
    streams drawn from the spec's registered op generators;
    ``read_pct`` sets each session's share of read queries.  Structure
    sizing comes from the spec's ``extras["serve_kw"]`` (falling back to
    the registered defaults); for the graph workload ``n_vertices``
    still overrides the vertex count.

    ``tier``: ordering-tier override for the PC schedulers
    (DESIGN.md §14) — ``eliminate`` (default), ``host``, ``device``, or
    ``auto`` (the online cost model routes each ordering pass; decisions
    land in the returned ``tier_decisions``).

    ``megapass``: answer each structure pass's update and read rounds
    through ONE ``mixed_rounds`` call (DESIGN.md §17) instead of the
    alternating update/read pair (structure workloads only; the decode
    workload ignores it).

    ``mesh_shards``: place the workload's K shards across a device mesh
    (DESIGN.md §18).  Sets K to this value, builds the 1-D ``("shard",)``
    combining mesh from the current world (``make_combining_mesh`` — D =
    the largest divisor of K that fits; a one-process world gives D = 1)
    and threads the ``MeshPlacement`` into BOTH the workload structure
    (a structure without the registry's placement marker raises
    ``ValueError``; ``decode`` places the deadline PQ alone) and the PC
    scheduler's deadline PQ.
    Every rank of the mesh calls this, with the same arguments: the
    leader (mesh index 0) runs the sessions, the scheduler and the
    executor, and every other rank follows the leader's dispatches on
    its rows of the workload structure and of the deadline PQ, one
    thread each (the decode model runs on the leader alone).  Every rank
    returns the leader's stats; ``stats["placement"]`` names the layout
    and ``stats["mesh_devices"]`` is D.

    ``fault_plan``: optional deterministic :class:`FaultPlan`
    (DESIGN.md §15) shared between the workload structure (transactional
    guarded dispatch) and the PC scheduler (combiner kill + supervisor
    takeover, guarded deadline-PQ dispatch, circuit-breaker tier
    degradation).  Fault counters and the breaker state land in the
    returned ``faults`` stats entry.

    ``device``: ``None`` means the card and raises without one; the
    tests pass ``"cpu"``.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    mesh_pl = None
    if mesh_shards is not None:
        if mesh_shards < 1:
            raise ValueError("--mesh-shards must be >= 1")
        placed = substrate.try_get(workload)
        if workload != "decode" and (
                placed is None or not placed.extras.get("placement")):
            raise ValueError(
                f"workload {workload!r} does not support --mesh-shards "
                "(no placement= constructor knob)")
        mesh_pl = MeshPlacement(make_combining_mesh(mesh_shards,
                                                    device=device))
    follower = mesh_pl is not None and not mesh_pl.is_leader
    if workload != "decode" and substrate.try_get(workload) is not None:
        spec = substrate.get(workload)
        if not spec.serve:
            raise ValueError(f"structure {workload!r} is not enrolled "
                             f"for serving (spec.serve=False)")
        serve_kw = dict(spec.extras.get("serve_kw", {}))
        if workload == "graph":
            serve_kw["n"] = n_vertices
            serve_kw.setdefault("edge_capacity", 16 * n_vertices)
        if mesh_pl is not None:
            serve_kw["n_shards"] = mesh_shards
            serve_kw["placement"] = mesh_pl
        ex: Any = StructureExecutor(
            spec, megapass=megapass, donate=scheduler != "pc-nodonate",
            fault_plan=fault_plan, device=device, **serve_kw)
        reqs_tab = _structure_requests(spec, rng, sessions,
                                       requests_per_session, read_pct,
                                       serve_kw)
    elif workload == "decode":
        cfg = configs.get_reduced(arch_id)
        # the model runs on the leader alone (only the deadline PQ is
        # placed, as in the reference)
        ex = None if follower else DecodeExecutor(
            cfg, max_batch=max_batch, max_len=prompt_len + n_tokens + 1,
            seed=seed, device=device)
        prompts = rng.integers(2, cfg.vocab,
                               (sessions, requests_per_session,
                                prompt_len)).astype(np.int32)
        reqs_tab = [[{"prompt": prompts[s, j], "n_tokens": n_tokens}
                     for j in range(requests_per_session)]
                    for s in range(sessions)]
    else:
        raise ValueError(f"unknown workload {workload!r}")

    if scheduler in ("pc", "pc-async", "pc-nodonate", "pc-pallas"):
        sch_kw: Dict[str, Any] = {}
        if mesh_pl is not None:
            # the deadline PQ rides the same mesh, with the same K
            sch_kw = dict(n_shards=mesh_shards, pq_placement=mesh_pl)
        sch = PCScheduler(ex, max_batch=max_batch, use_pq=True,
                          donate=scheduler != "pc-nodonate",
                          rounds_cap=rounds_cap, tier=tier,
                          fault_plan=fault_plan, device=device, **sch_kw)
    elif scheduler == "serial":
        sch = SerialScheduler(ex)
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    placed = getattr(ex, "ds", None) if mesh_pl is not None else None
    if follower:
        return _follow(mesh_pl, placed, sch)

    results: Dict[int, list] = {}
    errors: List[BaseException] = []
    t0 = time.time()

    def session(sid: int):
        reqs = [(reqs_tab[sid][j],
                 float(sid * requests_per_session + j))
                for j in range(requests_per_session)]
        try:
            if scheduler == "pc-async":
                futs = [sch.submit_async(inp, deadline=d)
                        for inp, d in reqs]
                results[sid] = [f.result() for f in futs]
            else:
                results[sid] = [sch.submit(inp, deadline=d)
                                for inp, d in reqs]
        except BaseException as exc:     # re-raised after every join
            errors.append(exc)

    threads = [threading.Thread(target=session, args=(s,))
               for s in range(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if isinstance(sch, PCScheduler):
        sch.close()
    if placed is not None:
        placed.close()
    if errors:
        if mesh_pl is not None:
            _share(mesh_pl, ("error", repr(errors[0])))
        raise errors[0]

    total_reqs = sessions * requests_per_session
    total_toks = total_reqs * (n_tokens if workload == "decode" else 1)
    stats = {
        "workload": workload,
        "scheduler": scheduler,
        "requests": total_reqs,
        "wall_s": round(wall, 3),
        "req_per_s": round(total_reqs / wall, 2),
        "tok_per_s": round(total_toks / wall, 1),
        "device_steps": ex.device_steps,
        "mean_batch": round(getattr(sch, "mean_batch", 1.0), 2)
        if scheduler != "serial" else 1.0,
        "tier_decisions": dict(getattr(sch, "tier_decisions", {})),
    }
    if mesh_pl is not None:
        stats["placement"] = mesh_pl.describe()
        stats["mesh_devices"] = mesh_pl.n_devices
    if getattr(ex, "megapass_dispatches", 0):
        stats["megapass_dispatches"] = ex.megapass_dispatches
        stats["rounds_per_dispatch"] = round(
            ex.megapass_rounds / ex.megapass_dispatches, 2)
    if fault_plan is not None:
        # robustness counters (DESIGN.md §15): the plan is shared between
        # the structure's dispatch guard and the scheduler, so one
        # snapshot covers faults injected at every layer
        faults: Dict[str, Any] = fault_plan.counters.snapshot()
        if isinstance(sch, PCScheduler):
            faults.update(sch.fault_counters())
        stats["faults"] = faults
    if mesh_pl is not None:
        _share(mesh_pl, ("ok", stats))
    return stats


def _share(mesh_pl: MeshPlacement, outcome):
    """The leader's ``("ok", stats)`` or ``("error", text)``, broadcast to
    every rank of the mesh over its group; returns the leader's stats on
    every rank, and raises on a follower where the leader failed."""
    import torch.distributed as dist

    box = [outcome]
    dist.broadcast_object_list(box, src=mesh_pl.ranks[0],
                               group=mesh_pl.mesh.get_group("shard"),
                               device=mesh_pl.device)
    kind, val = box[0]
    if kind != "ok":
        raise RuntimeError(f"the leader (mesh index 0) failed: {val}")
    return val


def _follow(mesh_pl: MeshPlacement, placed, sch) -> Dict[str, Any]:
    """A follower rank's run: one thread follows the workload structure,
    one the scheduler's deadline PQ, until the leader closes them; then
    the leader's stats."""
    followers = []
    if placed is not None:
        followers.append(placed.follow)
    if isinstance(sch, PCScheduler):
        followers.append(sch.follow)
    errors: List[BaseException] = []

    def run(fn):
        try:
            fn()
        except BaseException as exc:     # re-raised after every join
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(f,)) for f in followers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return _share(mesh_pl, None)


def build_fault_plan(args) -> Optional[FaultPlan]:
    """CLI → :class:`FaultPlan` (DESIGN.md §15); None when no fault flag
    is set, so the default serving path carries zero fault machinery."""
    if args.faults == "standard":
        return FaultPlan.standard(args.fault_seed)
    spikes = tuple(args.fault_latency_spike or ())
    if (args.fault_kill_pass is None and args.fault_dispatch_rate == 0.0
            and not spikes):
        return None
    return FaultPlan(args.fault_seed,
                     kill_combiner_at_pass=args.fault_kill_pass,
                     dispatch_fail_rate=args.fault_dispatch_rate,
                     max_dispatch_failures=64,
                     latency_spike_passes=spikes,
                     latency_spike_s=args.fault_latency_spike_s)


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--scheduler",
                    choices=["pc", "pc-async", "pc-nodonate", "pc-pallas",
                             "serial"],
                    default="pc")
    ap.add_argument("--workload",
                    choices=["decode"] + substrate.names(),
                    default="decode")
    ap.add_argument("--read-pct", type=int, default=90)
    ap.add_argument("--rounds-cap", type=int, default=4,
                    help="cap R on the scheduler's adaptive multi-round "
                         "fused PQ dispatch (DESIGN.md §12)")
    ap.add_argument("--megapass", action="store_true",
                    help="answer each structure pass's update+read rounds "
                         "through one mixed_rounds call (DESIGN.md §17)")
    ap.add_argument("--mesh-shards", type=int, default=None, metavar="K",
                    help="place K shards across a device mesh "
                         "(DESIGN.md §18): pq, map and graph, and the "
                         "deadline PQ of every PC scheduler")
    ap.add_argument("--tier",
                    choices=["auto", "host", "device", "eliminate"],
                    default="eliminate",
                    help="ordering-tier override for the PC scheduler "
                         "(DESIGN.md §14); 'auto' routes per pass via "
                         "the online cost model")
    ap.add_argument("--faults", choices=["none", "standard"],
                    default="none",
                    help="'standard' enables the standard fault plan "
                         "(DESIGN.md §15: kill combiner at pass 3, 10%% "
                         "dispatch failure, one latency spike)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-kill-pass", type=int, default=None,
                    help="kill the combiner loop once at this pass")
    ap.add_argument("--fault-dispatch-rate", type=float, default=0.0,
                    help="probability a guarded device dispatch fails")
    ap.add_argument("--fault-latency-spike", type=int, action="append",
                    default=None, metavar="PASS",
                    help="inject a latency spike at this combiner pass "
                         "(repeatable)")
    ap.add_argument("--fault-latency-spike-s", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu' (the plain "
                         "versions on the host)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """The CLI.  Under torchrun (``WORLD_SIZE`` > 1) it starts the default
    group from the environment, each rank on its own card; only rank 0
    (the mesh's leader) prints."""
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    world_from_env(resolve_device(args.device))
    stats = run_serving(args.arch, sessions=args.sessions,
                        requests_per_session=args.requests,
                        n_tokens=args.tokens, max_batch=args.max_batch,
                        scheduler=args.scheduler, workload=args.workload,
                        read_pct=args.read_pct,
                        rounds_cap=args.rounds_cap, tier=args.tier,
                        megapass=args.megapass,
                        mesh_shards=args.mesh_shards,
                        fault_plan=build_fault_plan(args),
                        device=args.device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("[serve]", stats)
    return stats


if __name__ == "__main__":
    main()
