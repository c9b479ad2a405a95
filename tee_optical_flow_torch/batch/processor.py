"""Folder-scale orchestration with per-file error recovery.

Parity with reference optical_flow/batch_processing.py:18-118: each file is
processed in isolation (failures accumulate, never kill the batch), each
chunk owns its output, errors persist to ``errors/error_filelist.pkl``,
and the folder is split into nchunks deterministic shards (the port's copy
of the JAX package's batch/processor.py).
"""

from __future__ import annotations

import logging
import os
import traceback
from typing import Callable, List, Optional

from ..io.pickle_io import PickleSerializer
from ..parallel.mesh import host_shard_list
from ..utils import safe_makedir

logger = logging.getLogger(__name__)


class BatchProcessor:
    def __init__(self, save_dir: str, verbose: bool = False):
        self.save_dir = save_dir
        self.verbose = verbose
        self.error_list: List[str] = []

    def process_single_file(self, filepath: str, process_func: Callable,
                            **kwargs) -> Optional[object]:
        """Run process_func(filepath, **kwargs); on failure record and
        continue (reference :35-55)."""
        try:
            return process_func(filepath, **kwargs)
        except Exception as exc:
            logger.error("Error processing %s: %s", filepath, exc)
            if self.verbose:
                traceback.print_exc()
            self.error_list.append(filepath)
            return None

    def process_chunk(self, file_list: List[str], process_func: Callable,
                      **kwargs) -> List[object]:
        """(reference :57-77)."""
        results = []
        for filepath in file_list:
            result = self.process_single_file(filepath, process_func, **kwargs)
            if result is not None:
                results.append(result)
        return results

    def save_errors(self) -> Optional[str]:
        """Persist the failure manifest (reference :79-87)."""
        if not self.error_list:
            return None
        error_dir = os.path.join(self.save_dir, "errors")
        safe_makedir(error_dir)
        path = os.path.join(error_dir, "error_filelist.pkl")
        PickleSerializer.save(self.error_list, path)
        logger.warning("Saved %d errors to %s", len(self.error_list), path)
        return path


def analyze_hdf5_folder(folder: str, save_dir: str, param_list: List[str],
                        label_list: List[str], process_func: Callable,
                        nchunks: int = 10, chunk_index: int = 0,
                        recalculate: bool = False,
                        verbose: bool = True) -> List[str]:
    """Shard the HDF5 folder and run process_func per (file, param, label)
    (reference :90-118). Returns the error list."""
    files = sorted(f for f in os.listdir(folder)
                   if f.endswith((".hdf5", ".h5")))
    my_files = host_shard_list(files, nchunks, chunk_index)
    processor = BatchProcessor(save_dir, verbose=verbose)

    for fname in my_files:
        filepath = os.path.join(folder, fname)
        for param in param_list:
            for label in label_list:
                out_dir = os.path.join(save_dir, f"{param}_{label}", "pkl_files")
                safe_makedir(out_dir)
                out_path = os.path.join(out_dir, fname.rsplit(".", 1)[0] + ".pkl")
                if os.path.exists(out_path) and not recalculate:
                    if verbose:
                        logger.info("%s exists, skipping", out_path)
                    continue
                row = processor.process_single_file(
                    filepath, process_func, param=param, label=label,
                    save_dir=save_dir)
                if row is not None:
                    PickleSerializer.save(row, out_path)
    processor.save_errors()
    return processor.error_list
