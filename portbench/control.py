"""Readings the limits are set from, on the chip at a cell's own size:
the control's (the reference in float8 in the program's place, judged
under the cell's limits as the program is, with the program's own
numbers beside it as ``program_*``) or a planted fault's, for each
seed, in one process.

    python3 portbench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault half_batch]

The benchmark's own runs never run this.  Each run prints one JSON line:
the seed, what ran (``control`` or the fault), whether it came out
correct, and the numbers.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import faults, harness
    from portbench.reference.precision import FP8

    for seed in args.seeds:
        t = time.perf_counter()
        if args.fault:
            with faults.FAULTS[args.fault]():
                res = harness.run_cell(ROOT, args.workload, seed,
                                       args.seconds, False, args.device)
            what = args.fault
        else:
            res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                   False, args.device, control=FP8)
            what = "control"
        nums = dict(res["readings"])
        nums.update({k: v["value"] for k, v in res["checks"].items()})
        print(json.dumps({"seed": seed, "ran": what,
                          "correct": res["correct"],
                          "seconds": time.perf_counter() - t,
                          "memory_peak_bytes":
                          res["device"]["memory_peak_bytes"],
                          "metrics": res["metrics"], "numbers": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
