"""utils/trace_tools' span recorder in train/train_step: a
projector+embed step of the tiny model under an outer span records
``train.loss_and_grad`` and then ``train.update`` from where it ended,
both under the outer span."""

import torch

from torch_spans_tiny import opened, prompts, recording, tiny_engine
from video_llava_tpu_torch.constants import IGNORE_INDEX
from video_llava_tpu_torch.train import train_step as ts
from video_llava_tpu_torch.utils import trace_tools


def test_train_step_spans():
    model = tiny_engine(seed=1).model
    names = ts.trainable_mask(model, "projector+embed")
    tx = ts.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = ts.init_train_state(model, tx, names)
    ids, _ = prompts(b=2)
    labels = ids.clone()
    labels[:, :4] = IGNORE_INDEX
    with recording():
        with opened("step"):
            state, metrics = ts.make_train_step(tx)(
                state, {"input_ids": ids, "labels": labels})
        spans = trace_tools.drain()
    assert torch.isfinite(metrics["loss"]) and state.step == 1
    outer, grad, update = spans
    assert (outer.name, grad.name, update.name) == (
        "step", "train.loss_and_grad", "train.update")
    assert grad.parent == update.parent == outer.id
    assert outer.start_ns <= grad.start_ns <= grad.end_ns == update.start_ns
    assert update.end_ns <= outer.end_ns
