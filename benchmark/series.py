"""Run one cell several times, each run a process of its own as a check
runs it, and print the spread of each metric.

    python3 -m benchmark.series --workload <cell> --seeds 11,12,13 \
        --seconds 30 [--trace 1] [--out chiprun_out/<file>.jsonl]

Each run's result line (and the end of its standard error when it gives
none) is appended to ``--out``. The spread is the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median. The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def spread(values):
    """(median, IQR / median) of the values; the spread is None for fewer
    than two."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    print(f"card: {card()}", flush=True)
    values = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            line = None
        record = {"workload": args.workload, "seed": seed,
                  "trace": args.trace, "rc": proc.returncode,
                  "wall_s": wall, "line": line}
        if line is None or not line.get("correct"):
            record["stderr"] = proc.stderr[-6000:]
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(record) + "\n")
        summary = "no result" if line is None else json.dumps(
            {"correct": line["correct"], "attempted": line["attempted"],
             "metrics": {k: v["value"] for k, v in line["metrics"].items()},
             "checks": {k: v["value"] for k, v in line["checks"].items()}})
        print(f"{args.workload} seed {seed} rc {proc.returncode} "
              f"wall {wall:.1f} s: {summary}", flush=True)
        if line is None:
            print(proc.stderr[-3000:], flush=True)
            continue
        for k, v in line["metrics"].items():
            values.setdefault(k, []).append(v["value"])
    for k, vals in values.items():
        med, sp = spread(vals)
        print(f"{args.workload} {k}: median {med!r}, spread {sp!r}, "
              f"values {vals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
