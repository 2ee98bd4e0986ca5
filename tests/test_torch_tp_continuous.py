"""The continuous engine under tensor parallel (2 gloo ranks on the CPU,
stepped in lockstep) against the JAX package's under its (1, 2) mesh,
after tests/test_continuous_tp.py: the slot cache, the paged pool and
the paged pool with prefix caching, greedy over three prompts (two
sharing a long preamble), token for token equal to the JAX TP engine's
and to the unsharded port engine's, on tests/test_continuous_tp.py's
tiny f32 configuration."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from torch_tp_pair import continuous_worker, run_ranks
from torch_xmem_pair import one_torch_thread
from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.engine.continuous import ContinuousEngine as JEngine
from video_llava_tpu.engine.continuous import SlotRequest as JRequest
from video_llava_tpu.models import video_llava as jvl
from video_llava_tpu.parallel import make_mesh, shard_params
from video_llava_tpu.parallel import videollava_param_specs
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch import config as pconfig
from video_llava_tpu_torch.engine.continuous import ContinuousEngine
from video_llava_tpu_torch.engine.continuous import SlotRequest
from video_llava_tpu_torch.engine.convert import params_from_jax

MAX_NEW = 10


def _cfgs(tok):
    llm = dict(num_layers=2, hidden_size=64, intermediate_size=128,
               num_heads=8, num_kv_heads=8, head_dim=8)
    ids = dict(vid_patch_token_id=tok.vid_patch_token_id,
               vid_start_token_id=tok.vid_start_token_id,
               vid_end_token_id=tok.vid_end_token_id)
    return (dataclasses.replace(
        VideoLLaVAConfig.tiny(), llm=dataclasses.replace(
            LlamaConfig.tiny(vocab_size=512), **llm), **ids),
        dataclasses.replace(
        pconfig.VideoLLaVAConfig.tiny(), llm=dataclasses.replace(
            pconfig.LlamaConfig.tiny(vocab_size=512), **llm), **ids))


def _run(eng, prompts, request, eos):
    handles = [eng.submit(request(p, max_new_tokens=MAX_NEW,
                                  eos_token_id=eos)) for p in prompts]
    for _ in range(300):
        if all(h.done for h in handles):
            break
        eng.step_once()
    assert all(h.done for h in handles)
    return [list(h.tokens) for h in handles]


@one_torch_thread()
def test_tp_continuous_matches_jax_and_unsharded(tmp_path):
    tok = ByteTokenizer()
    cfg, pcfg = _cfgs(tok)
    params = jax.jit(lambda k: jvl.init_params(k, cfg, jnp.float32))(
        jax.random.PRNGKey(0))
    pre = list(b"a shared preamble of useful length ")
    prompts = [[tok.bos_token_id] + pre + list(b"q1"),
               [tok.bos_token_id] + list(b"beta longer prompt"),
               [tok.bos_token_id] + pre + list(b"q3 somewhat longer")]
    base = dict(num_slots=2, max_cache_len=128, chunk=4, prompt_pad=16)
    paged = dict(base, paged=True, block_size=16)
    layouts = [base, paged, dict(paged, prefix_cache=True)]

    mesh = make_mesh(1, 2)
    sharded = shard_params(params, videollava_param_specs(params), mesh)
    want = [_run(JEngine(sharded, cfg, cache_dtype=jnp.float32, mesh=mesh,
                         **kw), prompts, JRequest, tok.eos_token_id)
            for kw in layouts]

    tree = jax.tree.map(np.asarray, params)
    pkw = [dict(kw, cache_dtype=__import__("torch").float32)
           for kw in layouts]
    got = run_ranks(continuous_worker, 2, tmp_path, tree, pcfg, prompts,
                    pkw, MAX_NEW, tok.eos_token_id)
    model = params_from_jax(tree, pcfg)
    plain = [_run(ContinuousEngine(model, pcfg, **kw), prompts, SlotRequest,
                  tok.eos_token_id) for kw in pkw]
    for name, g, w, p in zip(("slot", "paged", "prefix"), got, want, plain):
        assert g == w, name
        assert g == p, name
        assert all(len(t) > 0 for t in g), name
