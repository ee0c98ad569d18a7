"""Hand-written CUDA kernels, their plain PyTorch versions and the
dispatching entry points (``ops``)."""
