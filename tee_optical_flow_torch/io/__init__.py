from .dicom import extract_metadata, read_dicom_clip
from .dicom_write import write_dicom_clip
from .hdf5 import save_optical_flow_hdf5

__all__ = ["extract_metadata", "read_dicom_clip", "write_dicom_clip",
           "save_optical_flow_hdf5"]
