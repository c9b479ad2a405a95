"""The cohort's work split (the JAX package's parallel/mesh.py
``host_shard_list``).

The reference shards a folder into ``nchunks`` deterministic pieces and
each job takes one (calculate_optical_flow.py:266-269); no piece talks to
another. The device mesh of the JAX module is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def host_shard_list(items: Sequence, nchunks: int, chunk_index: int) -> List:
    """Deterministic nchunks split of a work list (the reference's batch-job
    sharding pattern); no in-band communication."""
    arr = np.array_split(np.asarray(list(items), dtype=object), nchunks)
    if chunk_index >= len(arr):
        return []
    return list(arr[chunk_index])
