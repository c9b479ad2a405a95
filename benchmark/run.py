"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with a
trace ``breakdown``, and last ``checks``, each number compared against
the plain reference beside its limit; the same numbers are the last lines
of standard error. Exits non-zero with no result when CUDA is absent, the
cell asks for more cards than there are, the program cannot be imported,
or JAX or the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds (the program's nvcc and g++ libraries land
# in build/kernels and build/dicomlite by themselves)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": CHECKOUT / "build" / "torch_extensions",
              "TRITON_CACHE_DIR": CHECKOUT / "build" / "triton"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)
    # a library that would load JAX by itself is kept from doing so
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(CHECKOUT))
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run = harness.driver(cell).run(cell, seed=args.seed,
                                   seconds=args.seconds,
                                   trace=bool(args.trace), device="cuda",
                                   t_start=T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded by the run: {loaded}",
              file=sys.stderr)
        return 3
    line = harness.result_line(run, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
