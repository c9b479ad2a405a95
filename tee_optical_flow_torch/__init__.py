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

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
