"""The end-to-end benchmark of video_llava_tpu_torch on one CUDA card.

Run a cell: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Every cell,
configuration, traffic kind and per-layer metric is found by its name in
files under this directory (see run.py).
"""
