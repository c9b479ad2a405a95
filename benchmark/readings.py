"""Read a cell's compared numbers over many seeds in one process: the
program's (the lower readings its limits are set from) or its control's
(the upper ones), each run on a short window at the cell's own load.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control] [--out chiprun_out/<file>.jsonl]

``--control`` puts the control named in the cell's file (or ``--control
<name>``, another the driver knows) in the program's place. Prints one
line per seed with every number and its limit, and appends the same as
JSON to ``--out``. Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", nargs="?", const="", default=None,
                   help="put the cell's control (or the one named) in the "
                   "program's place")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from benchmark import harness

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    control = (args.control or cell["control"]
               if args.control is not None else None)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = harness.driver(cell).run(cell, seed=seed, seconds=args.seconds,
                                       trace=False, device="cuda",
                                       t_start=t0, control=control)
        line = harness.result_line(run, False)
        record = {"workload": args.workload, "seed": seed,
                  "control": control, "correct": line["correct"],
                  "attempted": line["attempted"], "checks": line["checks"]}
        print(json.dumps(record), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
