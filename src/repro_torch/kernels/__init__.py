"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and the device-based dispatch between them."""
