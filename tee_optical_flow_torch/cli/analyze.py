"""Cohort analysis CLI: HDF5 folder -> 69-column CSV (the JAX package's
cli/analyze.py).

Parity with the reference's chunked legacy CLI
(analyze_optical_flow.py:1570-1620): shard the folder, analyze each clip
under ECG and arterial gating, merge the per-chunk pkl rows to CSV. The
device passes run on ``--device`` (``cuda`` by default).
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Cohort analysis of optical-flow HDF5 files")
    parser.add_argument("--hdf5_folder", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--params", nargs="+", default=["velocity"])
    parser.add_argument("--labels", nargs="+", default=["rv"])
    parser.add_argument("--nchunks", type=int, default=1)
    parser.add_argument("--chunk_index", type=int, default=None,
                        help="run one chunk; default runs all serially")
    parser.add_argument("--recalculate", action="store_true")
    parser.add_argument("--no_aggregate", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the analysis computes")
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from ..batch.cohort import run_cohort_analysis
    from ..core import resolve_device

    device = resolve_device(args.device)
    chunk_list = ([args.chunk_index] if args.chunk_index is not None
                  else list(range(args.nchunks)))
    errors = []
    for i, chunk in enumerate(chunk_list):
        last = i == len(chunk_list) - 1
        errors += run_cohort_analysis(
            args.hdf5_folder, args.save_dir, args.params, args.labels,
            nchunks=args.nchunks, chunk_index=chunk,
            recalculate=args.recalculate,
            aggregate=(last and not args.no_aggregate),
            verbose=args.verbose, device=device)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
