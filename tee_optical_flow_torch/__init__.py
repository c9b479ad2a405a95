"""PyTorch/CUDA port of tee_optical_flow_tpu for NVIDIA Hopper (H100).

The JAX package ``tee_optical_flow_tpu`` stays beside it as the
reference; this package imports nothing of it. The slices ported so far
are the production paths: DICOM read (the native C++ parser of
``csrc/dicomlite.cpp`` first, with uncompressed, RLE and JPEG-Lossless
frames; the pure-Python parser and cv2 for the rest) -> luma -> Otsu
masks (fill-holes, remove-small-objects, temporal moving average) or the
SAM segmentor's masks (``models/``, cleaned per label) -> per-frame
normalisation or fine-grained saliency -> TV-L1 (with OpenCV's gamma
illumination term when asked) or DeepFlow flow over all frame pairs
(with WASE background compensation and companion waveforms in the
segmentor modes) -> float16 -> HDF5 (``flow.pipeline.process_video``),
with the TV-L1 loops and the median (``csrc/tvl1.cu``) and the DeepFlow
SOR solve (``csrc/deepflow.cu``) as CUDA kernels; the gated cohort
analysis (``dataset``, ``analysis``, ``signal``, ``batch.cohort``,
``legacy``): ECG- or arterial-gated cycles, the radial/longitudinal
decomposition about the AV centroid, the S/e'/l'/a' peaks and the
69-value cohort row; and the segmentor's fine-tuning (``train``,
``cli.train``): AdamW steps to a best-DSC ``checkpoint_best.pth`` that
``cli.process`` serves.

Subpackage map (the JAX package's, as far as it is ported):
  config, exceptions    typed config tree (PipelineConfig, DeviceConfig,
                        TrainConfig, the flow and analysis configs) +
                        error taxonomy
  core, cache           bucketing, the device rule, the kernel build
                        cache; LRU caching by content hash
  io/                   DICOM (native C++ and pure Python; uncompressed,
                        RLE, JPEG), HDF5 (schema-compatible), waveforms,
                        CSV
  dataset               OpticalFlowDataset clip object
  ops/                  CUDA kernels and plain tensor code: TV-L1 (gamma
                        too), DeepFlow, warping, saliency, otsu,
                        morphology, histograms, smoothing
  signal/, peak_detection  cycles, ECG, peaks; S/e'/l'/a' extraction
  analysis/             centroid, radial/longitudinal projection, histograms
  models/               SAM: TinyViT vit_t and the ViT-Det vit_b/l/h
                        encoders, adapters, LoRA, int8 weights, the
                        predictor, the automatic mask generator, export,
                        PromptAutoEncoder + torch checkpoint import; the
                        baseline network zoo (``baselines.get_network``)
  train/                SAM fine-tuning: losses, schedule, AdamW loop
                        (one card, or a mesh of processes), checkpoints,
                        CSV dataset, prompts, eval, GAN
  flow/                 DICOM -> masks -> flow -> HDF5 production pipeline
  viz/                  heatmaps, peak-line plots, overlay video frames
  batch/, api, legacy   cohort orchestration; analyze, plot, batch; the
                        reference monolith's names
  parallel/             the device mesh (frame-axis data parallelism of
                        the flow, ``flow.pipeline.compute_clip_flow_
                        sharded``, and of the segmentor); the trainer's
                        ranks (``launch``), their collectives and the
                        weight sharding rule (``shardings``); host-side
                        sharding of file lists
  cli/                  process, peak_plots, analyze, train, val

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line), where the kernels' plain PyTorch
versions run instead.
"""

__version__ = "0.1.0"

from . import config as config
from . import exceptions as exceptions
from .exceptions import (
    ConfigurationError, DICOMReadError, OpticalFlowCalculationError,
    OpticalFlowError, WaveformLoadError, WaveformValidationError,
)

__all__ = [
    "config", "exceptions", "__version__",
    "OpticalFlowError", "DICOMReadError", "WaveformLoadError",
    "WaveformValidationError", "OpticalFlowCalculationError",
    "ConfigurationError",
]
