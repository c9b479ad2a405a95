"""Pickle persistence (reference file_io.py:119-147; the port's copy of
the JAX package's io/pickle_io.py)."""

from __future__ import annotations

import os
import pickle as pkl
from typing import Any

from ..utils import safe_makedir


class PickleSerializer:
    @staticmethod
    def save(data: Any, filepath: str) -> None:
        parent = os.path.dirname(filepath)
        if parent:
            safe_makedir(parent)
        with open(filepath, "wb") as f:
            pkl.dump(data, f)

    @staticmethod
    def load(filepath: str) -> Any:
        with open(filepath, "rb") as f:
            return pkl.load(f)
