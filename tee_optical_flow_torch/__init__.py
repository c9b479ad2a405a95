"""PyTorch/CUDA port of tee_optical_flow_tpu for NVIDIA Hopper (H100).

The JAX package ``tee_optical_flow_tpu`` stays beside it as the
reference; this package imports nothing of it. The slice ported so far is
the production main path: DICOM read -> luma -> Otsu masks (fill-holes,
remove-small-objects, temporal moving average) -> per-frame normalisation
-> TV-L1 flow over all frame pairs -> float16 -> HDF5
(``flow.pipeline.process_video(mode="otsu", OF_algo="TVL1",
no_saliency=True)``), with the TV-L1 loops as CUDA kernels
(``csrc/tvl1.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
