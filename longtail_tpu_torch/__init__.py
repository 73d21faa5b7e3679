"""longtail-tpu on PyTorch and CUDA.

The upsync chunk+hash data plane (HPCDC scan and cut walk, chunk pack,
BLAKE3 tree hash) runs as hand-written CUDA kernels for Hopper
(``csrc/``), each beside a plain PyTorch version of the same function.
Host layers that are not ported yet come from the ``longtail_tpu``
package through ``_host``; nothing here imports jax.

Entry points: ``api.upsync(..., device=...)`` and
``python -m longtail_tpu_torch.cli upsync --device ...``.
"""
