"""Exception hierarchy of the PyTorch port.

The same classes as the JAX package's ``exceptions`` module (reference:
optical_flow/exceptions.py:6-33), kept as the port's own copy so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations


class OpticalFlowError(Exception):
    """Base class for all framework errors."""


class DICOMReadError(OpticalFlowError):
    """Raised when a DICOM file cannot be read or decoded."""


class WaveformLoadError(OpticalFlowError):
    """Raised when a companion waveform file cannot be loaded."""


class WaveformValidationError(OpticalFlowError):
    """Raised when a waveform fails physiological validation."""


class OpticalFlowCalculationError(OpticalFlowError):
    """Raised when flow computation fails (bad inputs, solver failure)."""


class ConfigurationError(OpticalFlowError):
    """Raised on invalid or inconsistent configuration."""


class CheckpointError(OpticalFlowError):
    """Raised when a model checkpoint cannot be loaded or converted."""


class ShardingError(OpticalFlowError):
    """Raised when a mesh/sharding specification is invalid."""
