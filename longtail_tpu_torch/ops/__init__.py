"""Hashing: BLAKE3 constants, its plain batched form and the CUDA kernel."""
