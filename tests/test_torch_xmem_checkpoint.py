"""convert_xmem_checkpoint, port against the JAX package, on one
official-layout XMem state dict (tests/test_xmem.py's torch module:
key_encoder / key_proj / value_encoder / decoder, default init, BN
statistics away from the identity), saved as a training checkpoint
({'network': state dict}) and read back through the port's
engine/weights.load_torch_checkpoint_file. The port's tree equals the
JAX package's carried across (every leaf exactly), and one session
through each package's LearnedMemoryTracker on seeded 60 x 60 float
frames (edge-padded to 64 x 64 on each side: a reference write, two
steps with writes) agrees: probabilities within 1e-4."""

import numpy as np
import jax
import torch

from test_xmem import TXMem
from torch_xmem_pair import META, tx, one_torch_thread
from video_llava_tpu.grounding.memory_tracker import (
    LearnedMemoryTracker as JTracker,
)
from video_llava_tpu.models import xmem as jx
from video_llava_tpu_torch.engine.convert import xmem_from_jax
from video_llava_tpu_torch.engine.weights import load_torch_checkpoint_file
from video_llava_tpu_torch.grounding.memory_tracker import (
    LearnedMemoryTracker,
)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


@one_torch_thread()
def test_xmem_checkpoint_converts_as_jax(tmp_path):
    torch.manual_seed(0)
    tm = TXMem().eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.7, 1.3)
    path = tmp_path / "XMem.pth"
    torch.save({"network": tm.state_dict(), "it": 1000}, path)
    sd = load_torch_checkpoint_file(str(path))
    assert set(sd) == set(tm.state_dict())

    kw = dict(max_objects=2, mem_slots=3, top_k=8, mem_every=1)
    jcfg, tcfg = jx.XMemConfig(**kw), tx.XMemConfig(**kw)
    jp = jx.convert_xmem_checkpoint(tm.state_dict(), jcfg)
    tp = tx.convert_xmem_checkpoint(sd, tcfg)
    carried = xmem_from_jax(jax.tree.map(np.asarray, jp),
                            tx.init_params(META, tcfg))
    got, want = dict(_leaves(tp)), dict(_leaves(carried))
    assert got.keys() == want.keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)

    rng = np.random.default_rng(3)
    fr = rng.random((3, 60, 60, 3)).astype(np.float32)
    mask = np.zeros((1, 60, 60), np.float32)
    mask[0, 10:30, 12:40] = 1
    jt, tt = JTracker(jp, jcfg), LearnedMemoryTracker(tp, tcfg)
    jt.add_reference(fr[0], mask)
    tt.add_reference(fr[0], mask)
    assert tt.num_objects == jt.num_objects == 1
    for f in fr[1:]:
        want = jt.step(f)
        got = tt.step(f)
        assert got.shape == want.shape == (2, 60, 60)
        np.testing.assert_allclose(got, want, atol=1e-4)
    assert tt.state.next_slot == int(jt.state.next_slot) == 3
