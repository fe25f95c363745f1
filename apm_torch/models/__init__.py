"""Model layer: the end-to-end scan pipeline."""

from .scanner import Scanner, scan_counts

__all__ = ["Scanner", "scan_counts"]
