"""Reference-named runner entry points (thin aliases of eval/run_inference.py)."""
