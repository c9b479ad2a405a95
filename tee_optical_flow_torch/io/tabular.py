"""Cohort CSV export.

Parity with reference file_io.py:153-251: same directory layout
(``<save_dir>/<param>_<label>/pkl_files/*.pkl`` -> ``<save_dir>/csv/
<label>_<param>_data.csv``) and the same 69-column header (15 metadata
columns + ECG/ART x Total/Radial/Long x Peak/Mean x S/E/L/A + cycle
counts). Uses pandas (the reference used polars; same CSV bytes), imported
inside the functions that write: a machine without pandas can still import
this module and make the header.

The port's copy of the JAX package's io/tabular.py."""

from __future__ import annotations

import logging
import os
from typing import List

from ..utils import safe_makedir
from .pickle_io import PickleSerializer

logger = logging.getLogger(__name__)


def cohort_csv_header(param: str) -> List[str]:
    """The 69-column cohort schema (reference file_io.py:207-247)."""
    p = param.capitalize()
    header = [
        "Filename", "MRN", "FrameRate", "PixelSpacing", "HR", "Frames",
        "MeanART", "MaxART", "MinART", "MeanCVP", "MaxCVP", "MinCVP",
        "MeanPAP", "MaxPAP", "MinPAP",
    ]
    for gate in ("ECG", "ART"):
        header += [
            f"{gate}TotalPeakSystolic{p}", f"{gate}TotalMeanSystolic{p}",
            f"{gate}TotalPeakE{p}", f"{gate}TotalMeanE{p}",
            f"{gate}TotalPeakL{p}", f"{gate}TotalMeanL{p}",
            f"{gate}TotalPeakA{p}", f"{gate}TotalMeanA{p}",
            f"{gate}CardiacCycles{p}",
        ]
    for gate in ("ECG", "ART"):
        header += [
            f"{gate}RadialPeakSystolic{p}", f"{gate}RadialMeanSystolic{p}",
            f"{gate}RadialPeakE{p}", f"{gate}RadialMeanE{p}",
            f"{gate}RadialPeakL{p}", f"{gate}RadialMeanL{p}",
            f"{gate}RadialPeakA{p}", f"{gate}RadialMeanA{p}",
            f"{gate}LongPeakSystolic{p}", f"{gate}LongMeanSystolic{p}",
            f"{gate}LongPeakE{p}", f"{gate}LongMeanE{p}",
            f"{gate}LongPeakL{p}", f"{gate}LongMeanL{p}",
            f"{gate}LongPeakA{p}", f"{gate}LongMeanA{p}",
            f"{gate}RadialCardiacCycles{p}", f"{gate}LongCardiacCycles{p}",
        ]
    return header


class CSVExporter:
    @staticmethod
    def export_dataframe(data_list: List[list], header: List[str], filepath: str) -> None:
        import pandas as pd

        parent = os.path.dirname(filepath)
        if parent:
            safe_makedir(parent)
        df = pd.DataFrame(data_list, columns=header)
        df.to_csv(filepath, index=False)
        logger.info("Saved CSV file as %s", filepath)

    @staticmethod
    def aggregate_pkl_files(param_list: List[str], label_list: List[str],
                            save_dir: str) -> None:
        aggregate_pkl_files(param_list, label_list, save_dir)


def aggregate_pkl_files(param_list: List[str], label_list: List[str],
                        save_dir: str) -> None:
    """pkl rows -> cohort CSV per (param, label) (reference file_io.py:168-251)."""
    for param in param_list:
        for label in label_list:
            pkl_dir = os.path.join(save_dir, f"{param}_{label}", "pkl_files")
            csv_dir = os.path.join(save_dir, "csv")
            safe_makedir(csv_dir)
            if not os.path.exists(pkl_dir):
                logger.warning("Directory %s does not exist, skipping...", pkl_dir)
                continue
            data_list = []
            for filename in sorted(os.listdir(pkl_dir)):
                if not filename.endswith("pkl"):
                    continue
                try:
                    data_list.append(PickleSerializer.load(os.path.join(pkl_dir, filename)))
                except Exception as exc:  # defensive: never kill a cohort merge
                    logger.warning("Error loading %s: %s", filename, exc)
            if not data_list:
                logger.warning("No data found in %s, skipping CSV export...", pkl_dir)
                continue
            CSVExporter.export_dataframe(
                data_list, cohort_csv_header(param),
                os.path.join(csv_dir, f"{label}_{param}_data.csv"))
