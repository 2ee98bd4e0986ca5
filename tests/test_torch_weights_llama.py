"""convert_llama (engine/weights.py): a tiny transformers
LlamaForCausalLM written as .bin shards and as safetensors shards, read
by the port one shard at a time straight into its Llama module (f32),
against transformers' own logits and the JAX package's convert_llama +
llama.forward on the same directory: logits within 2e-4 (f32 on every
side, sums in another order). The vocabulary grows by three rows of the
embedding's mean (the video tokens), as in the JAX package; a bf16
safetensors copy loads bit for bit into a bf16 module; a missing tensor
raises."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_ckpt_pair import BASE_VOCAB, hf_llama, write_shards
from video_llava_tpu.config import LlamaConfig as JaxLlamaConfig
from video_llava_tpu.engine import weights as jax_weights
from video_llava_tpu.models import llama as jax_llama
from video_llava_tpu_torch.config import LlamaConfig
from video_llava_tpu_torch.engine import weights
from video_llava_tpu_torch.models.llama import Llama


def test_llama_shards_match_transformers_and_jax(tmp_path):
    model = hf_llama()
    sd = model.state_dict()
    ids = torch.tensor([[1, 5, 77, 123, 399, 2, 42, 8, 300, 17]])
    with torch.no_grad():
        want = model(ids).logits[0].numpy()
    cfg = LlamaConfig.tiny(vocab_size=BASE_VOCAB + 3)
    jcfg = JaxLlamaConfig.tiny(vocab_size=BASE_VOCAB + 3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for fmt in ("bin", "safetensors"):
        d = str(tmp_path / fmt)
        write_shards(d, sd, fmt, shards=3)
        llm = Llama(cfg, device="cpu", dtype=torch.float32)
        weights.convert_llama(weights.checkpoint_shards(d), llm)
        with torch.no_grad():
            got = llm(input_ids=ids)[0][0].numpy()
        np.testing.assert_allclose(got[:, :BASE_VOCAB], want, atol=2e-4,
                                   rtol=0, err_msg=fmt)
        if fmt == "bin":  # the JAX loader reads .bin
            params = jax_weights.convert_llama(
                jax_weights.load_checkpoint_dir(d), jcfg, jnp.float32)
            jgot = np.asarray(jax_llama.forward(
                params, jcfg, input_ids=jnp.asarray(ids.numpy()))[0][0])
            np.testing.assert_allclose(got, jgot, atol=2e-4, rtol=0)
            emb = np.asarray(params["embed_tokens"]["weight"])
            np.testing.assert_allclose(
                llm.embed_tokens.weight.numpy(), emb, atol=1e-7, rtol=0)
        # the added rows: the mean of the checkpoint's rows
        emb = llm.embed_tokens.weight
        for t in (emb, llm.lm_head.kernel.t()):
            torch.testing.assert_close(
                t[BASE_VOCAB:], t[:BASE_VOCAB].double().mean(0).float()
                .expand(3, -1), atol=1e-7, rtol=0)

    # bf16 safetensors into a bf16 module: every tensor bit for bit
    d = str(tmp_path / "bf16")
    write_shards(d, sd, "safetensors", shards=2, dtype=torch.bfloat16)
    llm = Llama(cfg, device="cpu", dtype=torch.bfloat16)
    weights.convert_llama(weights.checkpoint_shards(d), llm)
    own = dict(llm.named_parameters())
    for i in range(cfg.num_layers):
        for hf, ours in weights.LLAMA_LINEARS.items():
            assert torch.equal(own[f"layers.{i}.{ours}.kernel"],
                               sd[f"model.layers.{i}.{hf}"].bfloat16().t())
    assert torch.equal(own["final_norm.scale"],
                       sd["model.norm.weight"].bfloat16())
    assert torch.equal(own["embed_tokens.weight"][:BASE_VOCAB],
                       sd["model.embed_tokens.weight"].bfloat16())

    partial = {k: v for k, v in sd.items() if "layers.3.mlp.up" not in k}
    with pytest.raises(KeyError, match="layers.3.mlp.up_proj"):
        weights.convert_llama(partial, Llama(cfg, device="meta",
                                             dtype=torch.float32))
