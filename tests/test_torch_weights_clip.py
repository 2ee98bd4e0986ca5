"""convert_clip_vision and convert_clip_text (engine/weights.py). A tiny
transformers CLIPVisionModel (quick_gelu, 56 px, the stride-14 conv),
saved as pytorch_model.bin, read into the port's CLIPVisionTower (f32):
its penultimate patches against transformers' hidden_states[-2][:, 1:]
and against the JAX package's convert_clip_vision +
vision_penultimate_patches on the same directory, within 1e-4 (f32 on
every side, sums in another order; features of magnitude ~3). A
CLIPTextModel through convert_clip_text: every leaf equal to the JAX
package's convert_clip_text tree (its stacked layers split), the
identity projection where the checkpoint has none. (The port has no
text tower module yet: the crop filter that reads it is still to
port.)"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch
import transformers

from torch_ckpt_pair import hf_clip_vision
from video_llava_tpu.config import CLIPTextConfig as JaxTextConfig
from video_llava_tpu.config import CLIPVisionConfig as JaxVisionConfig
from video_llava_tpu.engine import weights as jax_weights
from video_llava_tpu.models import clip as jax_clip
from video_llava_tpu_torch.config import CLIPVisionConfig
from video_llava_tpu_torch.engine import weights
from video_llava_tpu_torch.engine.convert import flatten_tree
from video_llava_tpu_torch.models.clip import CLIPVisionTower


def test_clip_towers_match_transformers_and_jax(tmp_path):
    cfg = CLIPVisionConfig(image_size=56, patch_size=14, hidden_size=64,
                           intermediate_size=256, num_layers=3, num_heads=4)
    jcfg = JaxVisionConfig(**dataclasses.asdict(cfg))
    model = hf_clip_vision(cfg)
    d = str(tmp_path / "clip")
    model.save_pretrained(d, safe_serialization=False)
    pixels = np.random.default_rng(0).normal(
        size=(2, 56, 56, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(pixels).permute(0, 3, 1, 2),
                    output_hidden_states=True)
    want = out.hidden_states[-2][:, 1:].numpy()

    tower = CLIPVisionTower(cfg, device="cpu", dtype=torch.float32)
    weights.convert_clip_vision(weights.checkpoint_shards(d), tower)
    with torch.no_grad():
        got = tower.penultimate_patches(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    params = jax_weights.convert_clip_vision(
        jax_weights.load_checkpoint_dir(d), jcfg, jnp.float32)
    jgot = np.asarray(jax_clip.vision_penultimate_patches(
        params, jnp.asarray(pixels), jcfg))
    np.testing.assert_allclose(got, jgot, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tower.patch_embedding.numpy(),
                                  np.asarray(params["patch_embedding"]))

    tcfg = JaxTextConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                         num_layers=2, num_heads=4, projection_dim=16)
    torch.manual_seed(3)
    text = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4))
    sd = dict(text.state_dict())
    for with_proj in (False, True):
        if with_proj:
            sd["text_projection.weight"] = torch.randn(16, 32)
        tree = weights.convert_clip_text(sd, tcfg)
        jtree = jax_weights.convert_clip_text(
            {k: v.numpy() for k, v in sd.items()}, tcfg, jnp.float32)
        want = flatten_tree(jax.tree.map(np.asarray, jtree))
        got = flatten_tree(tree)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)
