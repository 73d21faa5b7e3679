"""Where the data plane runs: the one device decision that the api, the
indexer, the block stores and the device codecs share."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing CUDA when no card is present: no
    path continues on the CPU in place of the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (torch.cuda.is_available() is False)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
