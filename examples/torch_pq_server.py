"""Serving example on the PyTorch/CUDA port: parallel-combining scheduler
over a real decode model.

The twin of ``examples/pq_server.py``: the same arguments (plus
``--device``, the card by default) and the same rows, on
``repro_torch.launch.serve.run_serving``.  Concurrent client sessions
submit prompts with deadlines; the async PC scheduler (DESIGN.md §3 —
dedicated combiner loop + the §9 sharded batched-PQ deadline ordering)
combines them into dense decode batches — one device program per
combining pass instead of one per request.  The "pc-async" row uses the
non-blocking ``submit_async`` future API.  At the default sizes the
elimination pre-pass (DESIGN.md §14) orders every request on the host
(a pass may choose 4 x ``--max-batch`` requests, more than are ever in
flight), so the deadline PQ, whose dispatches launch the heap kernels
on the card, stays empty; more sessions than that bring it in.  The
decode model is the reduced config, as in the reference.

Run:  PYTHONPATH=src python examples/torch_pq_server.py --sessions 8
      [--device cpu]

``main`` returns the three rows' stats dicts, keyed by scheduler.
"""
import argparse

from repro_torch.launch.serve import run_serving

SCHEDULERS = ("serial", "pc", "pc-async")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    a = ap.parse_args(argv)

    print(f"[pq_server] {a.sessions} sessions × {a.requests} requests, "
          f"{a.tokens} tokens each (reduced {a.arch})")
    rows = {}
    for sched in SCHEDULERS:
        stats = run_serving(a.arch, sessions=a.sessions,
                            requests_per_session=a.requests,
                            n_tokens=a.tokens, max_batch=a.max_batch,
                            scheduler=sched, seed=0, device=a.device)
        print(f"  {sched:8s}: {stats['req_per_s']:7.2f} req/s  "
              f"{stats['device_steps']:4d} device dispatches  "
              f"mean batch {stats['mean_batch']}")
        rows[sched] = stats
    print("  -> combining serves the same requests in a fraction of the "
          "device dispatches (the paper's free-cycles claim)")
    return rows


if __name__ == "__main__":
    main()
