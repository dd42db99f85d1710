"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the device dispatch (``ops``).  Nothing here is compiled at import time."""
