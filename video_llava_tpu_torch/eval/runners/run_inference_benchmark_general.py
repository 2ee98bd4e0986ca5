"""Alias for video_chatgpt/eval/run_inference_benchmark_general.py: the
unified runner (eval/run_inference.py) with --dataset benchmark."""

import sys

from video_llava_tpu_torch.eval.run_inference import main

if __name__ == "__main__":
    main(["--dataset", "benchmark"] + sys.argv[1:])
