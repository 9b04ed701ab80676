"""The readings a cell's limits are set from (``limits/<workload>.json``).

    python3 -m vobench.calibrate --workload <name> --seeds 1-12 [--control-seeds 1-3]
        [--out <file.jsonl>]

Each reading is one ``harness.run`` of the cell, in this one process, with a
window of two passes of the pool: for each seed of ``--seeds`` the program's
run (the lower readings), for each seed of
``--control-seeds`` the control's, the reference in bfloat16 (the precision
below the program's float32) put in the program's place and judged by the
same rule (the upper readings). One JSON line a run, on standard output and
in ``--out``: the compared numbers, ``correct``, frames/s and the occupancy.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            out += list(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))

    import torch

    from vobench import harness

    if not torch.cuda.is_available():
        print("vobench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    c = harness.cell(args.workload, REPO)
    runs = [(s, None) for s in seeds(args.seeds)]
    runs += [(s, torch.bfloat16) for s in seeds(args.control_seeds)]
    out = open(args.out, "a") if args.out else None
    for seed, control in runs:
        t0 = time.perf_counter()
        result, code = harness.run(c, seed, 0.0, False, device, t0, control)
        row = {"workload": c.name, "side": "control" if control else "program", "seed": seed,
               "code": code}
        if result is not None:
            row.update(correct=result["correct"],
                       **{k: v["value"] for k, v in result["checks"].items()},
                       frames_per_s=result["metrics"]["frames_per_s"]["value"],
                       reference_s=result["reference_s"], occupancy=result["occupancy"])
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
