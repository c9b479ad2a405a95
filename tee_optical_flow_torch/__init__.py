"""PyTorch/CUDA port of tee_optical_flow_tpu for NVIDIA Hopper (H100).

The JAX package ``tee_optical_flow_tpu`` stays beside it as the
reference; this package imports nothing of it. The slices ported so far
are the production paths with Otsu masks: DICOM read -> luma -> Otsu masks
(fill-holes, remove-small-objects, temporal moving average) -> per-frame
normalisation or fine-grained saliency -> TV-L1 or DeepFlow flow over all
frame pairs -> float16 -> HDF5 (``flow.pipeline.process_video(mode="otsu",
OF_algo="TVL1" or "deepflow")``), with the TV-L1 loops
(``csrc/tvl1.cu``) and the DeepFlow SOR solve (``csrc/deepflow.cu``) as
CUDA kernels.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
