"""PyTorch + CUDA port of video_llava_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (ops/, models/, engine/, runtime/,
media/). The chat path runs through three hand-written CUDA kernels
(csrc/): CLIP encoder attention, spatio-temporal pooling and decode
attention over the stacked KV cache. Nothing here imports JAX.
"""
