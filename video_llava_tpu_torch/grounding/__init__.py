"""Grounded chat: detection, segmentation, tracking and tagging."""
