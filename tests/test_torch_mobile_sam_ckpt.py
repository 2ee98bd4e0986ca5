"""MobileSAM from its official checkpoint layout, port against the JAX
package: one mobile_sam.pt-style state dict, the image_encoder.* keys of
tests/test_mobile_sam.py's torch mirror of tiny_vit_sam.py (random
weights and BatchNorm statistics away from the identity, no
attention_bias_idxs buffers) beside the prompt_encoder.* / mask_decoder.*
keys of a tiny HF SamModel renamed to the official names (that test's
_to_official), goes through both packages' convert_tiny_vit and
convert_official_sam_decoder: trees equal leaf for leaf (the folded
BatchNorms included), and the TinyViT encoders agree on seeded pixels
within 1e-5 of the embeddings' scale. The port's build_sam reads the
file saved as a training checkpoint ({'model': ...}) with variant
'mobile' on the CPU into the same tree, and grounding/synthetic
.mobile_sam_state writes the tree back into that layout, leaf for
leaf."""

import numpy as np
import torch
import jax.numpy as jnp

from test_mobile_sam import (
    TEST_CFG,
    TTinyViT,
    _hf_sd,
    _randomize,
    _to_official,
)
from torch_grounding_ckpt_pair import (
    assert_trees_equal,
    one_torch_thread,
    rel_err,
)
from video_llava_tpu.models import sam as jsam
from video_llava_tpu.models import tiny_vit as jtv
from video_llava_tpu_torch.grounding import builders as tbuild
from video_llava_tpu_torch.grounding import synthetic
from video_llava_tpu_torch.models import sam as tsam
from video_llava_tpu_torch.models import tiny_vit as ttv

PORT_CFG = ttv.TinyViTConfig(
    image_size=TEST_CFG.image_size, embed_dims=TEST_CFG.embed_dims,
    depths=TEST_CFG.depths, num_heads=TEST_CFG.num_heads,
    window_sizes=TEST_CFG.window_sizes,
    output_channels=TEST_CFG.output_channels)


def test_mobile_sam_official_checkpoint_matches_jax(tmp_path):
    mirror = _randomize(TTinyViT(TEST_CFG), seed=3)
    sd = {"image_encoder." + k: v.detach().numpy()
          for k, v in mirror.state_dict().items()
          if "attention_bias_idxs" not in k}
    jcfg, tcfg = jsam.SamConfig.tiny_test(), tsam.SamConfig.tiny_test()
    sd.update({k: v for k, v in _to_official(_hf_sd(jcfg)).items()
               if k.startswith(("prompt_encoder.", "mask_decoder."))})
    j_vision = jtv.convert_tiny_vit(sd, TEST_CFG)
    t_vision = ttv.convert_tiny_vit(sd, PORT_CFG)
    assert_trees_equal(j_vision, t_vision)
    assert_trees_equal(jsam.convert_official_sam_decoder(sd, jcfg),
                       tsam.convert_official_sam_decoder(sd, tcfg))

    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jtv.encoder(j_vision, jnp.asarray(x), TEST_CFG))
    with one_torch_thread(), torch.inference_mode():
        got = ttv.encoder(t_vision, torch.from_numpy(x), PORT_CFG).numpy()
    assert got.shape == want.shape == (2, 4, 4, 16)
    assert rel_err(got, want) < 1e-5

    path = tmp_path / "mobile_sam.pt"
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    seg = tbuild.build_sam(str(path), tcfg, variant="mobile",
                           tiny_cfg=PORT_CFG, device="cpu")
    assert_trees_equal({"vision": t_vision,
                        **tsam.convert_official_sam_decoder(sd, tcfg)},
                       seg.params)
    written = synthetic.mobile_sam_state(seg.params, PORT_CFG)
    assert_trees_equal(seg.params, {
        "vision": ttv.convert_tiny_vit(written, PORT_CFG),
        **tsam.convert_official_sam_decoder(written, tcfg)})
