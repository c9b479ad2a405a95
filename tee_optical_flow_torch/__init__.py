"""PyTorch/CUDA port of tee_optical_flow_tpu for NVIDIA Hopper (H100).

The JAX package ``tee_optical_flow_tpu`` stays beside it as the
reference; this package imports nothing of it. The slices ported so far
are the production paths: DICOM read -> luma -> Otsu masks (fill-holes,
remove-small-objects, temporal moving average) or the SAM vit_t
segmentor's masks (``models/``, cleaned per label) -> per-frame
normalisation or fine-grained saliency -> TV-L1 or DeepFlow flow over all
frame pairs (with WASE background compensation and companion waveforms in
the segmentor modes) -> float16 -> HDF5 (``flow.pipeline.process_video``),
with the TV-L1 loops (``csrc/tvl1.cu``) and the DeepFlow SOR solve
(``csrc/deepflow.cu``) as CUDA kernels; and the gated cohort analysis
(``dataset``, ``analysis``, ``signal``, ``batch.cohort``): ECG- or
arterial-gated cycles, the radial/longitudinal decomposition about the AV
centroid, the S/e'/l'/a' peaks and the 69-value cohort row.

Subpackage map (the JAX package's, as far as it is ported):
  config, exceptions    typed config tree (PipelineConfig, DeviceConfig,
                        the flow and analysis configs) + error taxonomy
  core, cache           bucketing, the device rule, the kernel build
                        cache; LRU caching by content hash
  io/                   DICOM, HDF5 (schema-compatible), waveforms, CSV
  dataset               OpticalFlowDataset clip object
  ops/                  CUDA kernels and plain tensor code: TV-L1,
                        DeepFlow, warping, saliency, otsu, morphology,
                        histograms, smoothing
  signal/, peak_detection  cycles, ECG, peaks; S/e'/l'/a' extraction
  analysis/             centroid, radial/longitudinal projection, histograms
  models/               SAM vit_t + torch checkpoint import
  flow/                 DICOM -> masks -> flow -> HDF5 production pipeline
  viz/                  heatmaps, peak-line plots, overlay video frames
  batch/, api           cohort orchestration; analyze, plot, batch
  parallel/             host-side sharding of file lists
  cli/                  process, peak_plots, analyze
Not ported yet (ROADMAP.md, queue 1): the multi-card paths, compressed
DICOM frames, the ViT-Det encoders and int8 weights, TV-L1 gamma,
training.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line), where the kernels' plain PyTorch
versions run instead.
"""

__version__ = "0.1.0"
