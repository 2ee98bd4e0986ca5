"""parallel/sharding.py's rule tables against the JAX package's: on the
same bf16, int8 and int4 VideoLLaVA trees (bf16 in
tests/test_sharding.py's tiny configuration; int8 and int4 at hidden
256, where every LLM kernel reaches the quantizers' default size and wo
and down pack to int4 with 8 and 16 groups of 32 rows),
videollava_param_specs gives every leaf the JAX spec (the replicated
int4 qvalues_packed and multi-group scales of wo/down included);
module_param_specs gives each of the port's per-layer parameters its
stacked leaf's spec without the layer axis; and shard_params keeps on
each 'model' rank of a (1, 2) mesh exactly the shard JAX's shard_params
places on that device. Also divisible_spec, batch_spec and the four
cache specs, and the layouts shard_params refuses: the fused
wqkv/gate_up and an int4 width a rank would hold off the 128-column tile
(wq's 256 / 4 = 64, as gate's 11,008 / 4 is for Vicuna-7B). A rank's
slice needs no process group; last, a W8A8 CLIP tower's specs follow
the JAX rules and its features over a (1, 2) mesh of 2 gloo ranks equal
one process's exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_dp_pair import clip_a8_worker
from torch_tp_pair import run_ranks, tiny_cfg
from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.models import video_llava as jvl
from video_llava_tpu.ops.quant import quantize_params as jquant8
from video_llava_tpu.ops.quant4 import quantize_params_int4 as jquant4
from video_llava_tpu.parallel import make_mesh as jmake_mesh
from video_llava_tpu.parallel import sharding as jsh
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.parallel import sharding as psh
from video_llava_tpu_torch.parallel.mesh import Mesh


def _jcfg(hidden=64, heads=8, hd=8, ffn=128, layers=2):
    return dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig(vocab_size=512, hidden_size=hidden,
                        intermediate_size=ffn, num_layers=layers,
                        num_heads=heads, num_kv_heads=heads, head_dim=hd,
                        max_position_embeddings=512),
        vid_patch_token_id=259, vid_start_token_id=260,
        vid_end_token_id=261)


def _compare(jspecs, pspecs, path=""):
    """Walk both spec trees; every leaf equal; returns the leaf count."""
    if isinstance(jspecs, dict):
        assert set(jspecs) == set(pspecs), path
        return sum(_compare(jspecs[k], pspecs[k], f"{path}/{k}")
                   for k in jspecs)
    if isinstance(jspecs, (list, tuple)) and not hasattr(jspecs, "_parts"):
        if type(jspecs).__name__ != "PartitionSpec":
            assert len(jspecs) == len(pspecs), path
            return sum(_compare(a, b, f"{path}/{i}")
                       for i, (a, b) in enumerate(zip(jspecs, pspecs)))
    assert tuple(jspecs) == pspecs, (path, jspecs, pspecs)
    return 1


def _wide():
    """Hidden 256 (8 heads of 32, FFN 512): every LLM kernel and the
    embedding reach the quantizers' default min_size, as the port's
    models quantize, and a rank of a (1, 2) mesh keeps 128-column int4
    widths."""
    return _jcfg(hidden=256, hd=32, ffn=512)


def _trees():
    params = jax.jit(lambda k: jvl.init_params(k, _jcfg(), jnp.float32))(
        jax.random.PRNGKey(0))
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    wide = jax.jit(lambda k: jvl.init_params(k, _wide(), jnp.float32))(
        jax.random.PRNGKey(1))
    int8 = dict(wide, llm=jquant8(wide["llm"]))
    int4 = dict(wide, llm=jquant4(wide["llm"], group_size=32))
    return {"bf16": bf16, "int8": int8, "int4": int4}


def test_specs_match_jax(tmp_path):
    trees = _trees()
    layers = trees["int4"]["llm"]["layers"]
    assert set(layers["wo"]["kernel"]) == {"qvalues_packed", "scales"}
    assert layers["wo"]["kernel"]["scales"].shape[-2] == 8
    for fsdp in (False, True):
        for name, tree in trees.items():
            np_tree = jax.tree.map(np.asarray, tree)
            jspecs = jsh.videollava_param_specs(tree, fsdp)
            pspecs = psh.videollava_param_specs(np_tree, fsdp)
            n = _compare(jspecs, pspecs, name)
            assert n == len(jax.tree.leaves(tree)), name
    pl = psh.videollava_param_specs(
        jax.tree.map(np.asarray, trees["int4"]))["llm"]["layers"]
    for kname in ("wo", "down"):
        assert pl[kname]["kernel"] == {"qvalues_packed": (), "scales": ()}
    for kname in ("wq", "gate"):
        assert pl[kname]["kernel"]["qvalues_packed"] == (None, None, "model")
    int8_wq = psh.videollava_param_specs(jax.tree.map(
        np.asarray, trees["int8"]))["llm"]["layers"]["wq"]["kernel"]
    assert int8_wq == {"qvalues": (None, None, "model"),
                       "scales": (None, None, "model")}

    # module specs: the stacked leaf's spec without the layer axis
    for name in ("bf16", "int8", "int4"):
        tree = jax.tree.map(np.asarray, trees[name])
        model = params_from_jax(tree, _jcfg() if name == "bf16" else _wide())
        specs = psh.module_param_specs(model)
        flat_specs = {}
        _flatten_specs(psh.videollava_param_specs(tree), "", flat_specs)
        for pname, spec in specs.items():
            parts = pname.split(".")
            if parts[0] in ("vision", "llm") and parts[1] == "layers":
                key = ".".join(parts[:2] + parts[3:])
                want = flat_specs[key]
                want = want[1:] if want else ()
            else:
                want = flat_specs[pname]
            assert spec == want, (name, pname, spec, want)

    # shard_params keeps JAX's shard of each leaf on each rank
    tree = jax.tree.map(np.asarray, trees["int4"])
    jmesh = jmake_mesh(1, 2)
    jsharded = jsh.shard_params(trees["int4"],
                                jsh.videollava_param_specs(trees["int4"]),
                                jmesh)
    jflat = {}
    _flatten_specs(jsharded, "", jflat, leaves=True)
    for rank in (0, 1):
        model = params_from_jax(tree, _wide())
        psh.shard_params(model, Mesh(1, 2, rank, None, (0, 1)))
        dev = jmesh.devices[0, rank]
        for pname, p in model.named_parameters():
            parts = pname.split(".")
            stacked = parts[0] in ("vision", "llm") and parts[1] == "layers"
            key = ".".join(parts[:2] + parts[3:]) if stacked else pname
            shard = next(s for s in jflat[key].addressable_shards
                         if s.device == dev)
            want = np.asarray(shard.data)
            if stacked:
                want = want[int(parts[2])]
            got = p.detach()
            if str(got.dtype) == "torch.bfloat16":
                got = got.view(__import__("torch").int16)
                want = want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=pname)
        assert model.llm.cfg.num_heads == 4
        assert model.llm.layers[0].wo.tp is None  # int4 rows replicate
        assert model.llm.layers[0].wq.tp == "out"
        assert model.llm.embed_tokens.tp == "rows"
        assert model.vision.layers[0].fc2.tp == "in"
        assert model.projector.layers[0].tp is None

    # divisible_spec, batch and cache specs
    for m in (2, 4, 8):
        jm, pm = jmake_mesh(1, m), Mesh(1, m)
        for spec, shape in ((("model", None), (32006, 64)),
                            ((None, "model"), (64, 32256)),
                            ((None, None, "model"), (2, 64, 11008)),
                            (("model",), (1,)), ((None, "model"), (4, 6))):
            want = jsh.divisible_spec(jax.sharding.PartitionSpec(*spec),
                                      shape, jm)
            assert psh.divisible_spec(spec, shape, pm) == tuple(want)
    for fn in ("cache_spec", "cache_scale_spec", "paged_cache_spec",
               "paged_cache_scale_spec"):
        assert getattr(psh, fn)() == tuple(getattr(jsh, fn)()), fn
    assert psh.batch_spec(3) == tuple(jsh.batch_spec(3))

    # layouts that do not shard
    from video_llava_tpu_torch.models.clip import quantize_a8_
    from video_llava_tpu_torch.models.video_llava import VideoLLaVA

    cfg = tiny_cfg()
    with pytest.raises(ValueError, match="fused"):
        psh.shard_params(VideoLLaVA(cfg, device="meta", llm_quant="int8",
                                    llm_fuse=True), Mesh(1, 2))
    # a W8A8 CLIP tower shards by the JAX rules (qvalues_a8 on 'model'
    # as the kernel it replaces; the scales of o and fc2 replicate), and
    # its features over a (1, 2) mesh of 2 gloo ranks equal one
    # process's: each row-sharded product takes its row scale from the
    # whole row and adds exact int32 partial sums
    tree_bf16 = jax.tree.map(np.asarray, trees["bf16"])
    model = params_from_jax(tree_bf16, cfg)
    quantize_a8_(model.vision, min_size=0)
    specs = psh.module_param_specs(model)
    assert specs["vision.layers.0.q.kernel.qvalues_a8"] == (None, "model")
    assert specs["vision.layers.0.q.kernel.scales"] == (None, "model")
    assert specs["vision.layers.0.fc2.kernel.qvalues_a8"] == ("model", None)
    assert specs["vision.layers.0.fc2.kernel.scales"] == ()
    pixels = np.random.default_rng(0).normal(size=(4, 56, 56, 3)).astype(
        np.float32)
    got = run_ranks(clip_a8_worker, 2, tmp_path, tree_bf16, cfg, pixels)
    want = clip_a8_worker(0, 1, tree_bf16, cfg, pixels)
    np.testing.assert_array_equal(got, want)
    model = params_from_jax(tree, _wide())
    with pytest.raises(ValueError, match="128-column"):
        psh.shard_params(model, Mesh(1, 4, 1))


def _flatten_specs(tree, path, out, leaves=False):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_specs(v, f"{path}.{k}" if path else k, out, leaves)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten_specs(v, f"{path}.{i}" if path else str(i), out, leaves)
    else:
        out[path] = tree
