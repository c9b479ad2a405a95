"""Command-line entry points of the port (the JAX package's cli/, without
train and val, which come with training):

  python -m tee_optical_flow_torch.cli.process     DICOM folder -> HDF5
  python -m tee_optical_flow_torch.cli.peak_plots  one HDF5 -> plots, video
  python -m tee_optical_flow_torch.cli.analyze     HDF5 folder -> cohort CSV

Each takes ``--device`` (``cuda`` by default, ``cpu`` for the plain
versions).
"""
