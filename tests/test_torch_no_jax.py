"""The port and chip_smoke.py run where JAX, `optax`, `transformers`,
`requests`, `tokenizers`, `safetensors`, `sentencepiece` and
`google.protobuf` are not installed (the card's machine has none of
them)."""

import os
import pkgutil
import subprocess
import sys

import video_llava_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Makes `import jax` (optax, transformers, requests, tokenizers,
# safetensors, sentencepiece, google.protobuf) raise ImportError, as on a
# machine without them.
BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
             "sys.modules['optax'] = None; "
             "sys.modules['transformers'] = None; "
             "sys.modules['requests'] = None; "
             "sys.modules['tokenizers'] = None; "
             "sys.modules['safetensors'] = None; "
             "sys.modules['sentencepiece'] = None; "
             "sys.modules['google.protobuf'] = None; ")


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def _jax_package_paths():
    """(file, line, text) of every string in the port's modules, other
    than a docstring, that names the JAX package's directory."""
    import ast
    import re

    found = []
    root = os.path.dirname(video_llava_tpu_torch.__file__)
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            docs = {id(node.body[0].value) for node in ast.walk(tree)
                    if isinstance(node, (ast.Module, ast.ClassDef,
                                         ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                    and node.body and isinstance(node.body[0], ast.Expr)
                    and isinstance(node.body[0].value, ast.Constant)}
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and id(node) not in docs
                        and re.search(r"(^|[/\\])video_llava_tpu($|[/\\])",
                                      node.value)):
                    found.append((path, node.lineno, node.value))
    return found


def test_port_imports_no_jax(tmp_path):
    """Every module of the port, and chip_smoke.py, imports with JAX
    unimportable, and none pulls JAX in, nor names a file of the JAX
    package (video_llava_tpu/) in its code; the chat (with --use_asr and
    the checkpoint flags), serving, training and eval CLIs' --help run;
    a checkpoint's tokenizer.json and safetensors shards load without
    the tokenizer and safetensors libraries."""
    modules = [m.name for m in pkgutil.walk_packages(
        video_llava_tpu_torch.__path__, "video_llava_tpu_torch.")]
    assert "video_llava_tpu_torch.runtime.chat" in modules
    code = (BLOCK_JAX + "import importlib\n"
            f"for m in {modules + ['chip_smoke']!r}: "
            "importlib.import_module(m)\n"
            "assert sys.modules['jax'] is None\n"
            "assert not [m for m in sys.modules if m.startswith(("
            "'jax.', 'optax.', 'tokenizers.', 'safetensors.', "
            "'sentencepiece.', 'google.protobuf.'))]\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    # and no module of the port names a file of the JAX package (a path
    # built from 'video_llava_tpu' or written under 'video_llava_tpu/')
    assert _jax_package_paths() == []

    from torch_ckpt_pair import hf_llama, write_shards, write_tokenizer_json

    write_shards(str(tmp_path), hf_llama(layers=1).state_dict(),
                 "safetensors", shards=2)
    write_tokenizer_json(str(tmp_path))
    proc = _run(BLOCK_JAX + (
        "from video_llava_tpu_torch.engine import weights\n"
        "from video_llava_tpu_torch.runtime.tokenizer import load_tokenizer\n"
        f"sd = weights.load_checkpoint_dir({str(tmp_path)!r})\n"
        "assert sd['model.norm.weight'].shape == (256,)\n"
        f"tok = load_tokenizer({str(tmp_path)!r})\n"
        "assert tok.decode(tok.encode('Hello world')) == 'Hello world'\n"
        "print(tok.vid_patch_token_id)"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["400"]

    proc = _run(BLOCK_JAX + "import runpy; sys.argv = ['chat', '--help']; "
                "runpy.run_module('video_llava_tpu_torch.runtime.chat', "
                "run_name='__main__')")
    assert proc.returncode == 0, proc.stderr
    assert "--model_size" in proc.stdout
    assert "--with_grounding" in proc.stdout and "--sam_variant" in proc.stdout
    assert "--use_asr" in proc.stdout
    assert all(f in proc.stdout for f in ("--model-name", "--clip_path",
                                          "--projection_path"))
    assert {"video_llava_tpu_torch.audio.builders",
            "video_llava_tpu_torch.audio.transcribe",
            "video_llava_tpu_torch.audio.align",
            "video_llava_tpu_torch.audio.tokenizer",
            "video_llava_tpu_torch.audio.synthetic",
            "video_llava_tpu_torch.models.whisper",
            "video_llava_tpu_torch.models.wav2vec2",
            "video_llava_tpu_torch.ops.audio",
            "video_llava_tpu_torch.media.audio"} <= set(modules)
    assert "video_llava_tpu_torch.grounding.builders" in modules
    # the learned grounding build: XMem with its ResNet trunks, the CLIP
    # crop filter and text tower, and the CLIP tokenizer read without a
    # tokenizer library
    assert {"video_llava_tpu_torch.models.resnet",
            "video_llava_tpu_torch.models.xmem",
            "video_llava_tpu_torch.models.clip",
            "video_llava_tpu_torch.grounding.clip_filter",
            "video_llava_tpu_torch.grounding.memory_tracker",
            "video_llava_tpu_torch.grounding.fused_clip",
            "video_llava_tpu_torch.grounding.tracker"} <= set(modules)
    from torch_xmem_pair import write_clip_vocab
    from video_llava_tpu_torch.runtime.tokenizer import CLIPTokenizer

    clip_dir = tmp_path / "clip"
    clip_dir.mkdir()
    write_clip_vocab(clip_dir)
    text = "A photo of a Dog."
    proc = _run(BLOCK_JAX + (
        "from video_llava_tpu_torch.runtime.tokenizer import CLIPTokenizer\n"
        "from video_llava_tpu_torch.grounding import builders, tracker\n"
        "from video_llava_tpu_torch.models import xmem, resnet, clip\n"
        f"print(*CLIPTokenizer({str(clip_dir)!r}).encode({text!r}))"))
    assert proc.returncode == 0, proc.stderr
    want = CLIPTokenizer(str(clip_dir)).encode(text)
    assert len(want) > 2 and proc.stdout.split() == [str(i) for i in want]
    assert "video_llava_tpu_torch.serving.server" in modules
    proc = _run(BLOCK_JAX + "import runpy; sys.argv = ['serve', '--help']; "
                "runpy.run_module('video_llava_tpu_torch.serving', "
                "run_name='__main__')")
    assert proc.returncode == 0, proc.stderr
    assert "--continuous" in proc.stdout and "--prefix_cache" in proc.stdout
    assert "video_llava_tpu_torch.train.train" in modules
    proc = _run(BLOCK_JAX + "import runpy; sys.argv = ['train', '--help']; "
                "runpy.run_module('video_llava_tpu_torch.train.train', "
                "run_name='__main__')")
    assert proc.returncode == 0, proc.stderr
    assert "--tune_mode" in proc.stdout and "--llm_weights" in proc.stdout
    # the eval CLIs: the unified runner, a reference-named alias, the
    # judge and the benchmark orchestrator (its HTTP through urllib)
    for mod, flags in (
            ("eval.run_inference", ("--runner", "--batch_size", "--quant",
                                    "--device")),
            ("eval.runners.run_inference_qa_activitynet",
             ("--gt_file_question", "--num_slots")),
            ("eval.judge", ("--task", "--pred_path", "--rps")),
            ("eval.evaluate_benchmark", ("--pred_dir", "--api_base"))):
        name = "video_llava_tpu_torch." + mod
        assert name in modules
        proc = _run(BLOCK_JAX + f"import runpy; sys.argv = ['x', '--help']; "
                    f"runpy.run_module({name!r}, run_name='__main__')")
        assert proc.returncode == 0, (name, proc.stderr)
        assert all(f in proc.stdout for f in flags), (name, proc.stdout)
    # the W4A16 chat: the int4 switches are read at import, as the JAX
    # package reads VLT_INT4_A8 / VLT_INT4_A8_BLOCK
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(VLT_INT4_A8="0", VLT_INT4_A8_BLOCK="0")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX + (
            "from video_llava_tpu_torch.ops import quant4\n"
            "assert not quant4.A8_DECODE and not quant4.A8_BLOCK\n"
            "import runpy; sys.argv = ['chat', '--help']; "
            "runpy.run_module('video_llava_tpu_torch.runtime.chat', "
            "run_name='__main__')")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--quant" in proc.stdout
    # the grounding stack from checkpoints and its evaluation: SAM's ViT,
    # RAM, the BERT WordPiece tokenizer and the VidSTG / HC-STVG
    # annotations' preprocessing, with no tokenizer library
    assert {"video_llava_tpu_torch.models.ram",
            "video_llava_tpu_torch.models.sam",
            "video_llava_tpu_torch.grounding.eval_grounding",
            "video_llava_tpu_torch.grounding.synthetic",
            "video_llava_tpu_torch.datasets.grounding_datasets",
            "video_llava_tpu_torch.scripts.preprocess_grounding_annotations",
            } <= set(modules)
    from video_llava_tpu_torch.grounding import synthetic
    from video_llava_tpu_torch.runtime.tokenizer import BertTokenizer

    vocab_dir = synthetic.write_bert_vocab(str(tmp_path / "bert"), 2048)
    synthetic.write_hcstvg_annotations(str(tmp_path / "hc_videos"),
                                       str(tmp_path / "hc_ann"), n_videos=1)
    text = "Who is next to the Dog?"
    proc = _run(BLOCK_JAX + (
        "from video_llava_tpu_torch.runtime.tokenizer import BertTokenizer\n"
        "from video_llava_tpu_torch.scripts import "
        "preprocess_grounding_annotations as pre\n"
        f"pre.main(['hcstvg', '--video_dir', {str(tmp_path / 'hc_videos')!r},"
        f" '--ann_dir', {str(tmp_path / 'hc_ann')!r}])\n"
        f"print(*BertTokenizer({vocab_dir!r}).encode({text!r}))"))
    assert proc.returncode == 0, proc.stderr
    want = BertTokenizer(vocab_dir).encode(text)
    assert want[0] == 101 and want[-2:] == [1029, 102]
    assert proc.stdout.split()[-len(want):] == [str(i) for i in want]
    assert (tmp_path / "hc_ann" / "val_v2_proc.json").exists()
    # W8A8 CLIP and its quality preflight, the windowed batcher's flags,
    # and the training-data tools: each CLI's --help, and the
    # instruction converter and the transforms run, with JAX blocked
    assert {"video_llava_tpu_torch.ops.video_transforms",
            "video_llava_tpu_torch.scripts.save_features",
            "video_llava_tpu_torch.scripts.convert_instruction_data",
            "video_llava_tpu_torch.scripts.validate_quant_quality",
            } <= set(modules)
    for mod, flags in (
            ("scripts.validate_quant_quality", ("--preflight", "--vision",
                                                "--device")),
            ("scripts.save_features", ("--clip_feat_path", "--device")),
            ("scripts.convert_instruction_data", ("--clip_feature_path",)),
            ("serving", ("--batching", "--max_batch", "--window_ms"))):
        name = "video_llava_tpu_torch." + mod
        proc = _run(BLOCK_JAX + f"import runpy; sys.argv = ['x', '--help']; "
                    f"runpy.run_module({name!r}, run_name='__main__')")
        assert proc.returncode == 0, (name, proc.stderr)
        assert all(f in proc.stdout for f in flags), (name, proc.stdout)
    src = tmp_path / "instruct.json"
    src.write_text('[{"video_id": "v1", "q": "Why?", "a": "Because."}]')
    proc = _run(BLOCK_JAX + (
        "from video_llava_tpu_torch.scripts import convert_instruction_data"
        " as c\n"
        f"c.main(['--input_json_file', {str(src)!r}, '--output_json_file', "
        f"{str(tmp_path / 'out.json')!r}])\n"
        "import numpy as np\n"
        "from video_llava_tpu_torch.ops.video_transforms import "
        "make_video_transforms\n"
        "clip, _ = make_video_transforms('train', seed=0)("
        "np.zeros((2, 48, 64, 3), np.uint8))\n"
        "print(clip.dtype, clip.shape[0])"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-2:] == ["float32", "2"]
    assert '"video": "v1.pkl"' in (tmp_path / "out.json").read_text()
    # the tools: utils (timing, trace_tools, logging), the tracking-quality
    # suite, the qualitative demo, weight_tools, QA generation and the
    # profilers; each script's --help, and weight_tools' safetensors round
    # trip through the port's own reader and writer
    tools = ("utils.timing", "utils.trace_tools", "utils.logging",
             "scripts.tracking_quality", "scripts.qualitative_demo",
             "scripts.weight_tools", "scripts.generate_benchmark_qa",
             "scripts.profile_decode", "scripts.profile_xmem",
             "scripts.profile_gdino")
    assert {"video_llava_tpu_torch." + m for m in tools} <= set(modules)
    for mod, flags in (
            ("scripts.tracking_quality", ("--train_steps", "--xmem_checkpoint",
                                          "--lt_frames", "--device")),
            ("scripts.qualitative_demo", ("--video_path", "--sam_variant",
                                          "--device")),
            ("scripts.weight_tools", ("make-delta", "apply-delta",
                                      "consolidate")),
            ("scripts.generate_benchmark_qa", ("--task", "--num_tasks",
                                               "--api_base")),
            ("scripts.profile_decode", ("--steps", "--trace_dir",
                                        "--device")),
            ("scripts.profile_xmem", ("--frames", "--trace_dir",
                                      "--device")),
            ("scripts.profile_gdino", ("--batch", "--impl", "--device"))):
        name = "video_llava_tpu_torch." + mod
        proc = _run(BLOCK_JAX + f"import runpy; sys.argv = ['x', '--help']; "
                    f"runpy.run_module({name!r}, run_name='__main__')")
        assert proc.returncode == 0, (name, proc.stderr)
        assert all(f in proc.stdout for f in flags), (name, proc.stdout)
    base, target = tmp_path / "b.safetensors", tmp_path / "t.safetensors"
    proc = _run(BLOCK_JAX + (
        "import torch\n"
        "from video_llava_tpu_torch.engine import weights\n"
        "from video_llava_tpu_torch.scripts import weight_tools as wt\n"
        "g = torch.Generator().manual_seed(0)\n"
        "b = torch.randn(5, 3, generator=g).to(torch.bfloat16)\n"
        "t = torch.randn(7, 3, generator=g).to(torch.bfloat16)\n"
        f"weights.save_safetensors({str(base)!r}, "
        "{'model.embed_tokens.weight': b})\n"
        f"weights.save_safetensors({str(target)!r}, "
        "{'model.embed_tokens.weight': t})\n"
        f"d, o = {str(tmp_path / 'd.safetensors')!r}, "
        f"{str(tmp_path / 'o.safetensors')!r}\n"
        f"wt.main(['make-delta', '--base', {str(base)!r}, '--target', "
        f"{str(target)!r}, '--delta', d])\n"
        f"wt.main(['apply-delta', '--base', {str(base)!r}, '--delta', d, "
        "'--target', o])\n"
        "got = weights.load_safetensors(o)['model.embed_tokens.weight']\n"
        "assert got.dtype == torch.bfloat16 and torch.equal(got[5:], t[5:])\n"
        "print('roundtrip', (got.float() - t.float()).abs().max().item() "
        "< 0.05)"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-2:] == ["roundtrip", "True"]
    # tensor parallel: the parallel/ modules and the follower loop import
    # with JAX blocked, and the chat, serving and eval CLIs take the mesh
    # flags
    assert {"video_llava_tpu_torch.parallel",
            "video_llava_tpu_torch.parallel.mesh",
            "video_llava_tpu_torch.parallel.sharding",
            "video_llava_tpu_torch.parallel.multihost",
            "video_llava_tpu_torch.parallel.driver"} <= set(modules)
    proc = _run(BLOCK_JAX + (
        "from video_llava_tpu_torch.parallel import driver, make_mesh, "
        "multihost, shard_params, videollava_param_specs\n"
        "assert make_mesh().shape == {'data': 1, 'model': 1}\n"
        "print(driver.start(None, device='cpu').world_size)"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1"]
    for mod in ("runtime.chat", "serving", "eval.run_inference"):
        name = "video_llava_tpu_torch." + mod
        proc = _run(BLOCK_JAX + f"import runpy; sys.argv = ['x', '--help']; "
                    f"runpy.run_module({name!r}, run_name='__main__')")
        assert proc.returncode == 0, (name, proc.stderr)
        assert all(f in proc.stdout for f in (
            "--mesh_model", "--dist_backend", "--dist_init", "--device",
            "--dtype")), (name, proc.stdout)
