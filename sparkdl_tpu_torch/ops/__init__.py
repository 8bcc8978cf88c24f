"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(port of ``sparkdl_tpu.ops``)."""
