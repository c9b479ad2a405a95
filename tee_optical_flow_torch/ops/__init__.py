"""Device ops of the PyTorch port: plain PyTorch, plus the CUDA kernels of
``csrc/tvl1.cu`` behind ``warp.median_filter_5x5`` and
``tvl1_kernels.tvl1_outer_loop`` / ``tvl1_inner_block``."""
