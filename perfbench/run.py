"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations and traffic, and the metrics are listed in
``BENCHMARK.json`` at the checkout's root.  The last line on standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last); the
numbers compared by the check, each beside its limit, are also the last
lines on standard error.  Without a CUDA device, or with fewer than the cell
asks for, the run prints no result and exits with 2; if the JAX package or
JAX is loaded once the window has closed, with 3."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dropout_hamiltonian_montecarlo_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True,
                        help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0,
                        help="1: profile a stretch of the window, report per-layer metrics")
    args = parser.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "perfbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import cell, spec

    bench = spec.benchmark()
    chips = int(spec.cell(args.workload, bench)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell {args.workload} needs {chips} CUDA device(s), found "
              f"{found}; no result", file=sys.stderr)
        return 2
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START, bench=bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
