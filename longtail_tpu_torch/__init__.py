"""longtail-tpu on PyTorch and CUDA.

The upsync chunk+hash data plane (HPCDC scan and cut walk, chunk pack,
BLAKE3 and BLAKE2 hashes) and the match search of the LZ4 and zstd block
codecs run on the CUDA card, through hand-written kernels for Hopper
(``csrc/``), each beside a plain PyTorch version of the same function.
The host layers (formats, stores, host codecs and hashers, dedup, diff,
write and change, the native C helpers) are the package's own copies of
the JAX package's; nothing here imports jax or ``longtail_tpu``.

Entry points: ``api.upsync(...)`` (on the card by default; ``device="cpu"``
for the plain versions, ``device=None`` for the host path),
``api.downsync``, ``api.validate_version`` and
``python -m longtail_tpu_torch.cli <command>``.
"""
