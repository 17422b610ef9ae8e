"""Readings for the limits of a cell's check: the cell run on many seeds in one
process (its set-up paid once per seed, the kernel built once), the program
as the configuration states it or, with ``--control``, its lower-precision
control, or with ``--fault`` a fault of ``faults.py`` planted in it.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--control | --fault NAME] [--config key=value] \\
        [--out readings.jsonl]

Prints one JSON line a seed: the seed, the control or fault, the numbers
compared, the readings printed beside them, ``correct`` against the current
limits, and the run's end-to-end metrics."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated run seeds")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None, help="a fault of perfbench/tools/faults.py")
    parser.add_argument("--out", default=None, help="also append the lines to this file")
    parser.add_argument("--config", action="append", default=[], metavar="KEY=VALUE",
                        help="override a number of the cell's configuration file")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import cell, spec
    from perfbench.tools import faults

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    if args.fault:
        faults.plant(args.fault, spec.cell(args.workload)["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        config = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.config)}
        result = cell.run_cell(args.workload, seed, args.seconds, False, control=args.control,
                               overrides={"config": config})
        line = json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                           "fault": args.fault, "config": config,
                           "correct": result["correct"], "failed": result["failed"],
                           "checks": {k: v["value"] for k, v in result["checks"].items()},
                           "readings": result["readings"],
                           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
