"""Dense FL kernels (CUDA) and the host dispatch around them."""
