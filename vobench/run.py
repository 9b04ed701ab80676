"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m vobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 3.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiled stretch at the
start of the window. The last line of standard output is the result; the
last lines of standard error are the output check's numbers beside their
limits.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no JAX
    pulled in by a library."""
    build = REPO / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))

    import torch

    from vobench import harness

    cell = harness.cell(args.workload, REPO)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vobench: the cell {cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {found}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result, code = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), STARTED)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
