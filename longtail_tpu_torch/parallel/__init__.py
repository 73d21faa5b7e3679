"""The device chunk+hash data plane: stage 1 (scan + walk) and the
batched pipeline (one hash launch per batch)."""
