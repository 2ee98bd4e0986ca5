"""Offline data tooling (the grounding annotations' preprocessing)."""
