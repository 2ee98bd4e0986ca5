"""Alias for video_chatgpt/eval/run_inference_benchmark_consistency.py: the
unified runner (eval/run_inference.py) with --dataset consistency."""

import sys

from video_llava_tpu_torch.eval.run_inference import main

if __name__ == "__main__":
    main(["--dataset", "consistency"] + sys.argv[1:])
