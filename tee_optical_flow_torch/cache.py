"""LRU caching for expensive computations (the JAX package's cache.py;
reference optical_flow/cache.py:15-161: array-content hashing, a
decorator, an explicit cache object with access-order eviction).

Keys are the JAX package's for NumPy arrays and plain values. A
``torch.Tensor`` is hashed as the array of its contents (moved to the
host), so a tensor and the array it holds give the same key, on any
device.
"""

from __future__ import annotations

import functools
import hashlib
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch


def hash_array(arr) -> str:
    """md5 of the raw bytes of an array or a tensor's contents (reference
    cache.py:15-25)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.ascontiguousarray(arr)
    return hashlib.md5(arr.tobytes()).hexdigest()


def _part(value) -> str:
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return hash_array(value)
    return repr(value)


def hash_args(*args, **kwargs) -> str:
    """Stable hash across arrays, tensors and plain values (reference
    cache.py:28-41)."""
    parts = [_part(a) for a in args]
    parts += [f"{k}={_part(kwargs[k])}" for k in sorted(kwargs)]
    return hashlib.md5("|".join(parts).encode()).hexdigest()


class ComputationCache:
    """LRU cache with access-order eviction (reference cache.py:82-147)."""

    def __init__(self, max_size: int = 32):
        self.max_size = max_size
        self._store: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        if key in self._store:
            self._store.move_to_end(key)
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def set(self, key: str, value: Any) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.max_size:
            self._store.popitem(last=False)

    def invalidate(self, key: str) -> bool:
        return self._store.pop(key, None) is not None

    def clear(self) -> None:
        self._store.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)


_GLOBAL_CACHE = ComputationCache()


def get_cache() -> ComputationCache:
    return _GLOBAL_CACHE


def clear_cache() -> None:
    _GLOBAL_CACHE.clear()


def cached_computation(func: Callable = None, *,
                       cache: Optional[ComputationCache] = None):
    """Decorator caching by content hash of all args (reference
    cache.py:44-79)."""

    def decorate(f: Callable):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            c = cache or _GLOBAL_CACHE
            key = (f"{f.__module__}.{f.__qualname__}:"
                   f"{hash_args(*args, **kwargs)}")
            hit = c.get(key)
            if hit is not None:
                return hit
            result = f(*args, **kwargs)
            c.set(key, result)
            return result

        return wrapper

    if func is not None:
        return decorate(func)
    return decorate
