"""Grounding benchmark datasets (VidSTG, HC-STVG)."""
