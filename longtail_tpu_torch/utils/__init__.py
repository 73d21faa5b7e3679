"""Cross-cutting utilities: logging, progress, cancellation, stats."""
