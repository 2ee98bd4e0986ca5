"""grounding/memory_tracker.py against the JAX package's STM on seeded
frames of random patch colors (tests/torch_grounding_pair.patchy_frames:
no near ties in the top-k readout that rounding could reorder; exact
ties go to the lower index, as jax.lax.top_k breaks them), 64 x 100
(the last 4 columns fall outside the 8 px
patch grid) and box masks: the features, the mask <-> grid maps
(edge rows and columns zero), add_reference, a step that writes memory
(soft and binary) and one that does not, the ring buffer wrapping past
mem_slots. States (keys, values, valid slots, pointer, object count)
within 1e-5 and masks within 1e-4 (f32); binary masks agree except
where the soft mask is within 1e-4 of 0.5."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.grounding import memory_tracker as jmt
from video_llava_tpu_torch.grounding import memory_tracker as tmt
from torch_grounding_pair import patchy_frames


def _state_close(t, j):
    np.testing.assert_allclose(t.keys.numpy(), np.asarray(j.keys), atol=1e-5)
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values),
                               atol=1e-5)
    np.testing.assert_array_equal(t.slot_valid.numpy(),
                                  np.asarray(j.slot_valid))
    assert t.next_slot == int(j.next_slot)
    assert t.num_objects == int(j.num_objects)


def test_stm_step_and_add_reference_match_jax():
    cfg = jmt.TrackerConfig(max_objects=4, mem_slots=3)
    tcfg = tmt.TrackerConfig(max_objects=4, mem_slots=3)
    frames = patchy_frames(6, 64, 100, seed=1)
    np.testing.assert_allclose(
        tmt.default_features(torch.from_numpy(frames[0]), tcfg).numpy(),
        np.asarray(jmt.default_features(jnp.asarray(frames[0]), cfg)),
        atol=1e-6)
    masks = np.zeros((2, 64, 100), np.float32)
    masks[0, 5:40, 10:50] = 1
    masks[1, 30:64, 60:100] = 1  # reaches the uncovered edge columns
    grid = tmt.masks_to_grid(torch.from_numpy(masks), tcfg)
    np.testing.assert_allclose(
        grid.numpy(), np.asarray(jmt.masks_to_grid(jnp.asarray(masks), cfg)),
        atol=1e-6)
    back = tmt.grid_to_masks(grid, (64, 100), tcfg).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jmt.grid_to_masks(jnp.asarray(grid.numpy()),
                                           (64, 100), cfg)))
    assert not back[:, :, 96:].any()

    jt, tt = jmt.MemoryTracker(cfg), tmt.MemoryTracker(tcfg)
    for tr in (jt, tt):
        tr.add_reference(frames[0], masks, num_objects=2)
    _state_close(tt.state, jt.state)
    for i, (upd, binary) in enumerate(((True, False), (False, False),
                                       (True, True), (True, False),
                                       (True, False))):
        want = jt.step(frames[i + 1], update_memory=upd, binary=binary)
        got = tt.step(frames[i + 1], update_memory=upd, binary=binary)
        assert got.dtype == want.dtype and got.shape == want.shape
        if binary:
            assert np.mean(got != want) <= 1e-3
        else:
            np.testing.assert_allclose(got, want, atol=1e-4)
        _state_close(tt.state, jt.state)
    assert tt.state.next_slot == 5 > tcfg.mem_slots  # the ring wrapped
    assert tt.num_objects == jt.num_objects == 2
    tt.add_reference(frames[5], masks[:1].astype(np.uint8))
    jt.add_reference(frames[5], masks[:1].astype(np.uint8))
    _state_close(tt.state, jt.state)
