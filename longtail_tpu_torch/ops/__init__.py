"""Compute: the CDC chunker, the chunk hashes and the block codecs — the
host versions (the port's copies of the JAX package's), the plain PyTorch
versions of the device kernels and their CUDA wrappers."""
