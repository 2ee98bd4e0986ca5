"""models/llama.pad_vocab and the -inf logit mask against the JAX package's
(models/llama.py:468-518, :707-711), on a vocab of 510 that 4 ranks do
not divide: raw f32 and int8 (quantize_params: per-row int8 embedding,
int8 lm_head) trees padded to a multiple of 128 by each package hold the
same bytes, the padded rows and columns zero with unit int8 scales; the
padded model's logits equal JAX's on the padded tree (1e-5 in f32 where
finite; -inf on every padded column), equal the unpadded model's on the
real columns, and its greedy tokens are the unpadded model's. (int8 runs
its activations in bf16 from the embedding on, so against JAX it holds
to 0.05, tests/test_sharding.py's int8 bound.) Unpadded, a 4-way mesh
replicates the embedding and the head (divisible_spec); padded, it
shards both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_tp_pair import greedy_gen
from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.models import llama as jllama
from video_llava_tpu.models import video_llava as jvl
from video_llava_tpu.ops.quant import quantize_params as jquant8
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.engine.generate import generate
from video_llava_tpu_torch.models.layers import Int8Kernel
from video_llava_tpu_torch.models.llama import pad_vocab
from video_llava_tpu_torch.parallel.mesh import Mesh
from video_llava_tpu_torch.parallel.sharding import shard_params

VOCAB = 510


def _cfg():
    return dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig(vocab_size=VOCAB, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=8,
                        num_kv_heads=8, head_dim=32,
                        max_position_embeddings=512),
        vid_patch_token_id=259, vid_start_token_id=260,
        vid_end_token_id=261)


def _leaves(llm):
    """embed_tokens and lm_head of a port Llama as numpy, by JAX name."""
    out = {}
    for name, mod, leaf in (("embed_tokens/weight", llm.embed_tokens,
                             "weight"), ("lm_head/kernel", llm.lm_head,
                                         "kernel")):
        t = getattr(mod, leaf)
        if isinstance(t, Int8Kernel):
            out[name + "/qvalues"] = t.qvalues.numpy()
            out[name + "/scales"] = t.scales.numpy()
        else:
            out[name] = t.detach().numpy()
    return out


def _jleaves(p):
    out = {}
    for name in ("embed_tokens/weight", "lm_head/kernel"):
        a, b = name.split("/")
        v = p[a][b]
        if isinstance(v, dict):
            for k in ("qvalues", "scales"):
                out[f"{name}/{k}"] = np.asarray(v[k])
        else:
            out[name] = np.asarray(v)
    return out


def test_pad_vocab_matches_jax():
    cfg = _cfg()
    params = jax.jit(lambda k: jvl.init_params(k, cfg, jnp.float32))(
        jax.random.PRNGKey(0))
    trees = {"f32": params,
             "int8": dict(params, llm=jquant8(params["llm"]))}
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(2, 12))
    for name, tree in trees.items():
        np_tree = jax.tree.map(np.asarray, tree)
        jpadded = jllama.pad_vocab(tree["llm"], 128)
        model = params_from_jax(np_tree, cfg)
        plain = params_from_jax(np_tree, cfg)
        assert pad_vocab(model.llm, 128) is model.llm
        got, want = _leaves(model.llm), _jleaves(jpadded)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].shape == want[k].shape, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert model.llm.embed_tokens.rows == 512
        if name == "int8":
            assert isinstance(model.llm.lm_head.kernel, Int8Kernel)
            assert (got["embed_tokens/weight/scales"][VOCAB:] == 1).all()
            assert (got["lm_head/kernel/scales"][:, VOCAB:] == 1).all()
        # -inf on the padded columns, the JAX logits elsewhere
        jlogits = jax.jit(lambda p, i: jllama.forward(
            p, cfg.llm, input_ids=i)[0])(jpadded, jnp.asarray(ids))
        jlogits = np.asarray(jlogits)
        with torch.inference_mode():
            logits, _ = model.llm(input_ids=torch.from_numpy(ids))
            base, _ = plain.llm(input_ids=torch.from_numpy(ids))
        logits = logits.float().numpy()
        assert logits.shape == (2, 12, 512)
        assert np.isneginf(logits[..., VOCAB:]).all()
        assert np.isneginf(jlogits[..., VOCAB:]).all()
        tol = 1e-5 if name == "f32" else 0.05
        np.testing.assert_allclose(logits[..., :VOCAB], jlogits[..., :VOCAB],
                                   atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_allclose(logits[..., :VOCAB],
                                   base.float().numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
        # tokens unchanged
        lens = torch.tensor([12, 9], dtype=torch.int32)
        with torch.inference_mode():
            toks = [generate(m, greedy_gen(8), torch.from_numpy(ids), lens,
                             None, cache_dtype=torch.float32).tokens
                    for m in (model, plain)]
        assert torch.equal(toks[0], toks[1]), name

        # a vocab 4 ranks do not divide replicates; padded, it shards
        for m, tp in ((params_from_jax(np_tree, cfg), (None, None)),
                      (params_from_jax(np_tree, cfg), ("rows", "out"))):
            if tp[0]:
                pad_vocab(m.llm, 4 * 128)
            shard_params(m, Mesh(1, 4, 3))
            assert (m.llm.embed_tokens.tp, m.llm.lm_head.tp) == tp, name
            rows = m.llm.embed_tokens.rows
            assert rows == (128 if tp[0] else VOCAB), name
