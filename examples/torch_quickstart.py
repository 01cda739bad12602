"""Quickstart on the PyTorch/CUDA port: the paper's technique in three demos.

The twin of ``examples/quickstart.py``: the same demos, sizes, seeds and
printed lines, on ``repro_torch`` (the card by default, ``--device cpu``
for the plain versions on the host).

1. Parallel combining (Listing 1) turns the §4 batched binary heap into a
   concurrent priority queue: concurrent threads publish requests, one
   combiner drains them, and ONE device batch-apply serves everyone.  On
   the card each pass launches the hand-written heap kernels
   (``heap_kmin``, ``heap_sift``, ``heap_insert``).
2. The same engine powers the read-optimized dynamic graph (§3.3): each
   combined read batch is one gather over the component labels, which the
   graph rebuilds by plain pointer jumping on the device.
3. The device command queue (DESIGN.md §12) amortizes ONE dispatch across
   R combining rounds — tune with ``--rounds``.  On the donated CUDA heap
   the R rounds go out as packed rows and run as one replay of a CUDA
   graph, captured at the first dispatch of its row count, whose captured
   launches are the three heap kernels.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--rounds 4]
      [--device cpu]

``main`` returns what the demos printed, as values: the PQ's initial,
inserted, extracted and remaining keys; the graph's edges, its 800 queries
and their answers; the rounds, their answers and the heap they leave.
"""
import argparse
import threading

import numpy as np

from repro_torch.core import (BatchedPriorityQueue, DynamicGraph,
                              ShardedBatchedPQ, batched_read_optimized,
                              pc_priority_queue)
from repro_torch.core.sharded_pq import to_numpy

INITIAL = [5.0, 1.0, 9.0]


def concurrent_priority_queue(device):
    print("=== parallel-combining priority queue (paper §4) ===")
    pq = BatchedPriorityQueue(capacity=4096, c_max=16, values=INITIAL,
                              device=device)
    engine = pc_priority_queue(pq)

    results = {}

    def session(tid):
        out = []
        for i in range(50):
            if (tid + i) % 2 == 0:
                engine.execute("insert", float(tid * 100 + i))
            else:
                out.append(engine.execute("extract_min"))
        results[tid] = out

    threads = [threading.Thread(target=session, args=(t,)) for t in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]

    extracted = [v for o in results.values() for v in o if v is not None]
    sizes = engine.combined_sizes
    print(f"  200 ops served in {engine.passes} combining passes "
          f"(mean batch {np.mean(sizes):.1f}, max {max(sizes)})")
    print(f"  extracted {len(extracted)} values, {len(pq)} remain "
          f"-> conservation {3 + 100 == len(extracted) + len(pq)}")
    inserted = [float(tid * 100 + i) for tid in range(4) for i in range(50)
                if (tid + i) % 2 == 0]
    return {"initial": list(INITIAL), "inserted": inserted,
            "extracted": extracted, "remaining": pq.values(),
            "passes": engine.passes}


def read_dominated_graph(device):
    print("=== read-optimized dynamic graph (paper §3.3/§5.1) ===")
    g = DynamicGraph(1000, device=device)
    engine = batched_read_optimized(g)
    rng = np.random.default_rng(0)
    edges = []
    for _ in range(500):
        e = (int(rng.integers(1000)), int(rng.integers(1000)))
        edges.append(e)
        engine.execute("insert", e)

    asked = {}

    def reader(tid):
        r = np.random.default_rng(tid)
        out = []
        for _ in range(200):
            u, v = int(r.integers(1000)), int(r.integers(1000))
            out.append(((u, v), bool(engine.execute("connected", (u, v)))))
        asked[tid] = out

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    queries = [q for t in range(4) for q, _ in asked[t]]
    answers = [a for t in range(4) for _, a in asked[t]]
    print(f"  800 connectivity reads in {engine.passes} passes "
          f"(combined read batches answered by one device call each)")
    print(f"  connected fraction: {sum(answers) / 800:.2f}")
    return {"n": 1000, "edges": edges, "queries": queries,
            "answers": answers, "passes": engine.passes}


def fused_rounds(n_rounds: int, device):
    print(f"=== fused multi-round dispatch, R={n_rounds} (DESIGN.md §12) ===")
    rng = np.random.default_rng(0)
    values = rng.uniform(0, 100, 64).astype(np.float32)
    pq = ShardedBatchedPQ(4096, c_max=16, n_shards=4, values=values,
                          device=device)
    # R sequential combining rounds — extract 4 + insert 4 each — applied
    # by ONE dispatch (one CUDA-graph replay on the card) instead of R
    rounds = [(4, rng.uniform(0, 100, 4).astype(np.float32).tolist())
              for _ in range(n_rounds)]
    answers = pq.apply_rounds(rounds)
    print(f"  {n_rounds} rounds x (4 extracts + 4 inserts) = "
          f"{8 * n_rounds} ops in ONE device dispatch")
    for r, ans in enumerate(answers):
        print(f"  round {r}: extracted {[round(v, 1) for v in ans]}")
    print(f"  {len(pq)} keys remain; answers are per-round ascending")
    a, size = to_numpy(pq.state)
    return {"values": values, "rounds": rounds, "answers": answers,
            "heap": a, "sizes": size, "graph_captures": pq.graph_captures,
            "graph_replays": pq.graph_replays}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4,
                    help="R for the fused multi-round demo (apply_rounds "
                         "on the sharded PQ)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    return {"pq": concurrent_priority_queue(args.device),
            "graph": read_dominated_graph(args.device),
            "rounds": fused_rounds(args.rounds, args.device)}


if __name__ == "__main__":
    main()
