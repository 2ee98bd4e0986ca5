"""chip_smoke.py and the port stand alone: no line of them names JAX or
the JAX package (nor `transformers` or `requests`, which the card's
machine does not have), and both import with all of these made
unimportable, leaving none in sys.modules."""

import ast
import glob
import os
import subprocess
import sys

from video_llava_tpu_torch.ops import cuda_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE = ("jax", "jaxlib", "video_llava_tpu", "transformers", "requests")
GROUNDING = ("video_llava_tpu_torch.grounding.builders",
             "video_llava_tpu_torch.grounding.tracker",
             "video_llava_tpu_torch.grounding.fused_clip",
             "video_llava_tpu_torch.grounding.memory_tracker",
             "video_llava_tpu_torch.grounding.tagging",
             "video_llava_tpu_torch.grounding.entity_matching",
             "video_llava_tpu_torch.grounding.results",
             "video_llava_tpu_torch.eval.openai_client",
             "video_llava_tpu_torch.media.scene",
             "video_llava_tpu_torch.models.grounding_dino",
             "video_llava_tpu_torch.models.swin",
             "video_llava_tpu_torch.models.bert",
             "video_llava_tpu_torch.models.tiny_vit",
             "video_llava_tpu_torch.models.sam",
             "video_llava_tpu_torch.ops.deformable",
             "video_llava_tpu_torch.ops.box_ops",
             "video_llava_tpu_torch.ops.topk")
# The decode dispatch and kernels 9 and 11, the int4 dispatch and kernel
# 6's W4A16 pair: what chip_smoke.py and the model call by name.
ENTRIES = {
    "video_llava_tpu_torch.ops.attention": (
        "set_default_impl", "enable_paged_kernel", "decode_attention",
        "decode_attention_reference", "decode_attention_mxu",
        "decode_attention_mxu_plain", "decode_attention_pallas",
        "decode_attention_pallas_plain"),
    "video_llava_tpu_torch.ops.quant4": (
        "A8_DECODE", "A8_BLOCK", "A8_MAX_BATCH", "w4a16_matvec",
        "w4a16_block", "int4_matmul_w4a16_matvec_plain",
        "int4_matmul_w4a16_block_plain"),
}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_smoke_and_port_import_nothing_of_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")] + glob.glob(
        os.path.join(REPO, "video_llava_tpu_torch", "**", "*.py"),
        recursive=True)
    assert len(files) > 20
    for path in files:
        assert [n for n in _imports(path)
                if n.split(".")[0] in JAX_SIDE] == [], path
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__") for p in files)
    assert set(GROUNDING) <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {JAX_SIDE!r}: sys.modules[m] = None\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"for m, names in {ENTRIES!r}.items():\n"
            "    missing = [n for n in names\n"
            "               if not hasattr(sys.modules[m], n)]\n"
            "    assert not missing, (m, missing)\n"
            f"left = [m for m in sys.modules if m.split('.')[0] in "
            f"{JAX_SIDE!r} and sys.modules[m] is not None]\n"
            "assert not left, left\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

    # each C entry point that ops/cuda_lib.py binds is defined in a
    # csrc/*.cu file (there is no nvcc here to find a missing one)
    text = "".join(open(p).read() for p in cuda_lib._sources())
    for name in cuda_lib._SIGNATURES:
        assert f'extern "C" int {name}(' in text, name
