"""Shared small helpers (copies of the JAX package's utils/helpers.py)."""

from __future__ import annotations

import math
import os


def safe_makedir(path: str) -> None:
    """mkdir -p (reference optical_flow_utils.py:26-28)."""
    os.makedirs(path, exist_ok=True)


def pad_to_multiple(n: int, m: int) -> int:
    """Next multiple of ``m`` at or above ``n`` (``n`` itself for m <= 1)."""
    return int(math.ceil(n / m) * m) if m > 1 else int(n)
