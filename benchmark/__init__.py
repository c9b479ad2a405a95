"""The benchmark of tee_optical_flow_torch on one NVIDIA H100: see README.md."""
