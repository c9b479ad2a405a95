"""Shared pieces of the benchmark's CPU tests.

    python -m pytest benchmark/tests -q

The card-only tests are marked ``cuda`` and skip without a card; they
decide inside a fixture, never at import.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402

# a clip cell at a size the CPU can hold: 9 frames of 64x96, two clips in
# the pool
SMALL_TRAFFIC = dict(pool=2, frames=9, height=64, width=96, checked_clips=2,
                     profiled_clips=1)


def small_cell(name: str) -> dict:
    cell = copy.deepcopy(harness.load_cell(name))
    cell["traffic_data"].update(SMALL_TRAFFIC)
    return cell


def run_small(name: str, seed: int = 5, control=None,
              device="cpu") -> dict:
    """One short run of a small copy of ``name`` (on the CPU, the look
    for a card skipped); returns the result line."""
    cell = small_cell(name)
    run = harness.driver(cell).run(cell, seed=seed, seconds=0.0,
                                   trace=False, device=device, t_start=0.0,
                                   control=control)
    return harness.result_line(run, False)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
