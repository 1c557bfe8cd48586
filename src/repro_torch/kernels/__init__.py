"""Hand-written CUDA kernels of the checkpoint path, their plain PyTorch
versions, and the device dispatch (``ops``)."""
