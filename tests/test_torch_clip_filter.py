"""The port's ClipCropFilter against the JAX package's, over the same
tiny towers (2 layers, width 32, 56 px crops) carried across and
random_clip_filter's crc32 tokenizer: the zero-shot class weights within
1e-5; the per-crop embeddings (embed_crops) within 1e-4; the batched
device scores of 5 frames x 3 boxes (chunks of 4, the last padded by
repetition; boxes across the frame's edges) within 1e-5; the keep masks
of filter_frames_device and of the per-frame host __call__ equal to the
JAX package's, with the thresholds set between the scores so that the
filter keeps some boxes and drops others; and the device path's masks
equal to the host path's."""

import numpy as np

from torch_xmem_pair import clip_pair, crc32_tokenize, one_torch_thread

CLASSES = ["person", "dog", "traffic light"]


@one_torch_thread()
def test_clip_filter_matches_jax():
    jf, tf = clip_pair(crc32_tokenize())
    np.testing.assert_allclose(tf.zeroshot_weights(CLASSES).numpy(),
                               np.asarray(jf.zeroshot_weights(CLASSES)),
                               atol=1e-5)
    assert tf.zeroshot_weights(CLASSES) is tf.zeroshot_weights(CLASSES)

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(5, 48, 72, 3), dtype=np.uint8)
    boxes = np.stack([np.asarray([[2.5 + f, 3.1, 30.7, 40.2],
                                  [-4.0, 20.0, 18.6, 52.3],
                                  [40.2 + f, 8.8, 75.0, 30.1]], np.float32)
                      for f in range(5)])
    cls = rng.integers(0, 3, size=(5, 3))
    np.testing.assert_allclose(
        tf.embed_crops(frames[0], boxes[0]).numpy(),
        np.asarray(jf.embed_crops(frames[0], boxes[0])), atol=1e-4)
    want = jf.score_frames_device(frames, boxes, CLASSES)
    got = tf.score_frames_device(frames, boxes, CLASSES)
    assert got.shape == (5, 3, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)

    # thresholds between the selected classes' probabilities and scores
    probs = np.exp(100 * want) / np.exp(100 * want).sum(-1, keepdims=True)
    psel = np.take_along_axis(probs, cls[..., None], -1)[..., 0].ravel()
    sel = np.take_along_axis(want, cls[..., None], -1)[..., 0].ravel()
    p_sorted, s_sorted = np.sort(psel), np.sort(sel)
    for f in (jf, tf):
        f.prob_threshold = float(p_sorted[4] + p_sorted[5]) / 2
        f.score_threshold = float(s_sorted[1] + s_sorted[2]) / 2
    valid = np.ones((5, 3), bool)
    valid[4, 2] = False
    keep = tf.filter_frames_device(frames, boxes, valid, cls, CLASSES)
    np.testing.assert_array_equal(keep, np.asarray(jf.filter_frames_device(
        frames, boxes, valid, cls, CLASSES)))
    assert keep.any() and not keep[valid].all() and not keep[4, 2]
    for f in range(5):
        host = tf(frames[f], boxes[f], cls[f], CLASSES)
        np.testing.assert_array_equal(
            host, jf(frames[f], boxes[f], cls[f], CLASSES))
        np.testing.assert_array_equal(host[valid[f]], keep[f][valid[f]])
