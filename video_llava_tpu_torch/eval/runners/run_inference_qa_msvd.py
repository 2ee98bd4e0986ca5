"""Entry-point-parity alias for the reference script
video_chatgpt/eval/run_inference_qa_msvd.py: delegates to the unified
runner (eval/run_inference.py) with --dataset msvd."""

import sys

from video_llava_tpu_torch.eval.run_inference import main

if __name__ == "__main__":
    main(["--dataset", "msvd"] + sys.argv[1:])
