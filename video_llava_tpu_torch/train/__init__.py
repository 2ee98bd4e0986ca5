"""Training: projector (and embedding) tuning on precomputed video
features (data.py, train_step.py, train.py)."""
