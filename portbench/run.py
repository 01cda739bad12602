"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port (``src/repro_torch``)
beside ``BENCHMARK.json`` and ``portbench/``.  It needs as many CUDA
devices as the cell asks for, and exits with a code other than 0, with
no result, without them.  The last line of standard output is the
result's JSON object; the numbers the check compared, each with its
limit, are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# this file's folder on the path would let its modules shadow others
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
# the only kernel cache besides the port's own build directory
# (<checkout>/build/repro_torch_kernels): a fixed place in the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"{torch.cuda.device_count()} CUDA devices; the cell asks "
              f"for {chips[args.workload]}", file=sys.stderr)
        return 3
    try:
        res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", t_start=T_START)
    except Exception:
        traceback.print_exc()
        return 1
    for k, v in res.get("readings", {}).items():
        print(f"reading {k}: {v}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
