from .dicom import extract_metadata, read_dicom_clip
from .dicom_write import write_dicom_clip
from .hdf5 import HDF5Reader, HDF5Writer, save_optical_flow_hdf5
from .pickle_io import PickleSerializer
from .tabular import CSVExporter, aggregate_pkl_files
from .waveforms import load_all_waveforms

__all__ = ["extract_metadata", "read_dicom_clip", "write_dicom_clip",
           "HDF5Reader", "HDF5Writer", "save_optical_flow_hdf5",
           "PickleSerializer", "CSVExporter", "aggregate_pkl_files",
           "load_all_waveforms"]
