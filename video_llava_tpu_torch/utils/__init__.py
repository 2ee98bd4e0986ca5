"""Utilities: logging, timing, profiling hooks."""
