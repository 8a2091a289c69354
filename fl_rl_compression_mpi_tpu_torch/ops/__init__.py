"""The kernels (CUDA) with their plain PyTorch twins, the host dispatch
around them, and the NumPy goldens."""
