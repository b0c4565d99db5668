"""The readings the correctness limit is set from, on a card at a cell's
own size: for each seed, one run of the cell (a short window at its own
load) and, over the same sampled blocks, the control: the plain reference
with its bank in bfloat16 (the precision below the float32 the
configuration states) put in the program's place.

    python3 -m zlbench.control --workload <name> --seeds 1,2,3 \\
        --seconds 3

Prints one JSON line a seed: the program's `master_gap` (a lower
reading) and the control's `control_gap` (an upper reading), each beside
the configuration's limit. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, harness, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m zlbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        age, t_age = harness.process_age_s(), time.perf_counter()
        line, checks, _ = run.run_cell(cell, seed, args.seconds, False,
                                       args.device, t_age, age,
                                       control=True)
        program = {k: v for k, v in checks.items() if k != "control_gap"}
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": check.judge(program),
                          "control_fails": not check.judge(
                              {"c": checks["control_gap"]}),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
