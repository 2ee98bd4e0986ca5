"""The training step: loss, gradients of the trainable set, AdamW.

Counterpart of video_llava_tpu/train/train_step.py. The loss is the
shifted masked cross-entropy with the video features spliced into the
prompt (models/video_llava.forward, each decoder layer recomputed in the
backward pass). Trainability follows the JAX package's path rule: the
projector, plus embed_tokens in 'projector+embed', everything in
'full'; frozen parameters get neither gradients nor optimizer state.
The optimizer is optax.adamw as the JAX package builds it (b1 0.9, b2
0.999, eps 1e-8, decoupled weight decay, a warmup-cosine schedule read
at the update count before the update), computed in each parameter's
dtype as optax does, and applied in place. With the span recorder on
(utils/trace_tools), a step records ``train.loss_and_grad`` and then
``train.update`` (the optimizer and the gradient norm). They mark where
the host is, not the device: the first ends once the backward is
queued, and the update's first host-to-device copies wait for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import numpy as np
import torch

from video_llava_tpu_torch.constants import IGNORE_INDEX
from video_llava_tpu_torch.models.video_llava import shifted_log_likelihood
from video_llava_tpu_torch.parallel import collectives
from video_llava_tpu_torch.utils import trace_tools

TUNE_MODES = ("projector", "projector+embed", "full")


def is_trainable(name: str, mode: str = "projector+embed") -> bool:
    """The JAX package's rule (_is_trainable) on a parameter's dotted
    path: 'projector.layers.0.kernel', 'llm.embed_tokens.weight', ..."""
    if mode not in TUNE_MODES:
        raise ValueError(f"tune mode: one of {TUNE_MODES}, got {mode!r}")
    if mode == "full" or name.startswith("projector"):
        return True
    return mode == "projector+embed" and "embed_tokens" in name


def trainable_mask(model: torch.nn.Module,
                   mode: str = "projector+embed") -> List[str]:
    """Set requires_grad on exactly the trainable parameters of `model`
    (and off on the rest); return their names. A quantized (integer)
    leaf cannot train: 'full' over a quantized LLM raises."""
    names = []
    for name, p in model.named_parameters():
        train = is_trainable(name, mode)
        if train and not p.is_floating_point():
            raise ValueError(f"{name} is {p.dtype}: a quantized leaf cannot "
                             f"train (tune mode {mode!r})")
        p.requires_grad_(train)
        if train:
            names.append(name)
    return names


def linear_schedule(init_value: float, end_value: float, steps: int):
    """optax.linear_schedule, in f32."""
    def schedule(count: int) -> np.float32:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return np.float32(init_value - end_value) * frac + np.float32(
            end_value)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1), in f32."""
    def schedule(count: int) -> np.float32:
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        return np.float32(init_value) * (np.float32(1 - alpha) * cosine
                                         + np.float32(alpha))
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear warmup, then cosine
    decay over the remaining decay_steps - warmup_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warmup(count) if count < warmup_steps
                          else decay(count - warmup_steps))


class AdamW:
    """optax.adamw(schedule, b1, b2, eps, eps_root=0, weight_decay) with
    mu_dtype None: the moments in the parameter's dtype, every update
    step in that dtype in optax's order (moments, bias correction with
    1 - b**count in f32 cast to the moment's dtype, mu_hat / (sqrt(nu_hat)
    + eps), + weight_decay * p, times -lr cast to the dtype, added to p).
    State: {"count": updates taken, "mu": {name: t}, "nu": {name: t}}."""

    def __init__(self, schedule: Callable[[int], float],
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay, self.b1, self.b2, self.eps = (weight_decay, b1,
                                                         b2, eps)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> dict:
        """Apply one update to `params` in place; return the new state."""
        count = state["count"] + 1
        lr = float(self.schedule(state["count"]))
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        mu_new, nu_new = {}, {}
        for name, p in params.items():
            g = grads[name]
            mu = (1 - b1) * g + b1 * state["mu"][name]
            nu = (1 - b2) * (g * g) + b2 * state["nu"][name]
            mu_hat = mu / bc1.to(device=mu.device, dtype=mu.dtype)
            nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.weight_decay * p
            u = torch.tensor(-lr, dtype=u.dtype, device=u.device) * u
            p.copy_(p + u)
            mu_new[name], nu_new[name] = mu, nu
        return {"count": count, "mu": mu_new, "nu": nu_new}


def make_optimizer(learning_rate: float = 2e-3, weight_decay: float = 0.0,
                   warmup_steps: int = 100,
                   total_steps: int = 10_000) -> AdamW:
    """AdamW with HF's cosine-with-warmup recipe (the JAX package's
    make_optimizer)."""
    if warmup_steps > 0:
        schedule = warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps,
            max(total_steps, warmup_steps + 1))
    else:
        schedule = cosine_decay_schedule(learning_rate, max(total_steps, 1))
    return AdamW(schedule, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model (whose parameters the step updates in place), the
    optimizer state of its trainable parameters, and the step count."""

    model: torch.nn.Module
    opt_state: dict
    step: int = 0

    @property
    def trainable(self) -> List[str]:
        return list(self.opt_state["mu"])


def init_train_state(model: torch.nn.Module, tx: AdamW,
                     trainable: List[str]) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(model, tx.init({n: params[n] for n in trainable}), 0)


def loss_fn(model: torch.nn.Module, batch) -> torch.Tensor:
    """batch: input_ids (b, s), labels (b, s), video_features (b,
    video_token_len, mm_hidden) raw pooled CLIP features. Each decoder
    layer is recomputed in the backward pass (remat)."""
    _, loss = model(batch["input_ids"], batch.get("video_features"),
                    labels=batch["labels"], remat=True)
    return loss


def log_likelihood(model: torch.nn.Module, batch):
    """(summed log-likelihood, count of valid targets) of this rank's
    rows: :func:`loss_fn`'s parts (remat as there)."""
    logits, _ = model(batch["input_ids"], batch.get("video_features"),
                      remat=True)
    return shifted_log_likelihood(logits, batch["labels"])


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm, summed in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def sharded_global_norm(tensors, axes, mesh) -> torch.Tensor:
    """The global norm of a gradient whose leaves are sharded over
    `axes` (each leaf's tuple of mesh axes): each leaf's squares summed
    over the ranks that hold its distinct shards, a replicated leaf
    counted once. One all_reduce over the mesh: slot i holds the leaves
    sharded over ('model' in axes) + 2 ('data' in axes), and a rank adds
    to a slot only at coordinate 0 of each axis the slot replicates."""
    sq = torch.zeros(4, dtype=torch.float32, device=tensors[0].device)
    for t, ax in zip(tensors, axes):
        i = int("model" in ax) + 2 * int("data" in ax)
        sq[i] += t.float().square().sum()
    d0, m0 = mesh.coords["data"] == 0, mesh.coords["model"] == 0
    keep = torch.tensor([d0 and m0, d0, m0, True], dtype=torch.float32,
                        device=sq.device)
    sq = sq * keep
    torch.distributed.all_reduce(sq)
    return torch.sqrt(sq.sum())


def _grad(loss, targets):
    """d loss / d targets; a target the loss does not reach (the vision
    tower under 'full' on precomputed features) gets zeros, as under
    jax.grad."""
    return torch.autograd.grad(loss, targets, allow_unused=True,
                               materialize_grads=True)


def _sum_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """t summed over 'data' (parallel/collectives.summed)."""
    return collectives.summed(t, mesh, "data")


def make_train_step(tx: AdamW, grad_accum: int = 1, mesh=None):
    """(state, batch) -> (state, {"loss", "grad_norm"}), the parameters
    updated in place.

    grad_accum > 1 splits the batch into `grad_accum` strided
    microbatches (row j of microbatch a is row j * grad_accum + a) and
    takes one update on the token-weighted f32 average of their
    gradients (each microbatch's mean-loss gradient weighted by its
    count of valid targets), which equals the full batch's gradient.

    Under a mesh of more than one rank (parallel/sharding.shard_params
    sharded the model) the batch is this rank's rows, those of its
    'data' coordinate, and the step is the JAX package's over the global
    batch: the loss is the mean over the global batch's valid targets,
    so each rank differentiates its summed log-likelihood divided by the
    global count (summed over 'data'), and the gradient of every leaf
    is summed over 'data' (an FSDP leaf's in its gather's backward
    pass). A mean of the ranks' means would weigh a rank's targets by
    its own count. The microbatches stride this rank's rows, which is
    how the JAX package's strided split falls on a data shard. The
    norm counts every shard once (:func:`sharded_global_norm`) and
    AdamW updates each rank's shard."""
    if mesh is not None and mesh.world > 1:
        return _sharded_step(tx, grad_accum, mesh)

    @trace_tools.unwinding
    def step(state: TrainState, batch):
        span = trace_tools.begin("train.loss_and_grad")
        params = dict(state.model.named_parameters())
        names = state.trainable
        targets = [params[n] for n in names]
        if grad_accum == 1:
            loss = loss_fn(state.model, batch)
            grads = list(_grad(loss, targets))
            loss = loss.detach()
        else:
            b = batch["input_ids"].shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"grad_accum {grad_accum}")
            gacc = [torch.zeros_like(p, dtype=torch.float32)
                    for p in targets]
            lsum = wsum = torch.zeros((), dtype=torch.float32,
                                      device=targets[0].device)
            for a in range(grad_accum):
                mb = {k: v[a::grad_accum] for k, v in batch.items()}
                ntok = (mb["labels"][:, 1:] != IGNORE_INDEX).sum().float()
                loss = loss_fn(state.model, mb)
                for acc, g in zip(gacc, _grad(loss, targets)):
                    acc.add_(g.float() * ntok)
                lsum = lsum + loss.detach() * ntok
                wsum = wsum + ntok
            w = wsum.clamp_min(1.0)
            grads = [(acc / w).to(p.dtype) for acc, p in zip(gacc, targets)]
            loss = lsum / w
        span = trace_tools.switch(span, "train.update")
        opt_state = tx.update(dict(zip(names, grads)), state.opt_state,
                              dict(zip(names, targets)))
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        trace_tools.end(span)
        return TrainState(state.model, opt_state, state.step + 1), metrics

    return step


def _sharded_step(tx: AdamW, grad_accum: int, mesh):
    from video_llava_tpu_torch.parallel.sharding import sharded_axes

    @trace_tools.unwinding
    def step(state: TrainState, batch):
        span = trace_tools.begin("train.loss_and_grad")
        model = state.model
        params = dict(model.named_parameters())
        names = state.trainable
        targets = [params[n] for n in names]
        specs = getattr(model, "param_specs", {})
        axes = [sharded_axes(specs.get(n), mesh) for n in names]
        b = batch["input_ids"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"grad_accum {grad_accum}")
        dev = targets[0].device
        gacc = [torch.zeros_like(p, dtype=torch.float32) for p in targets]
        lsum = wsum = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(grad_accum):
            mb = (batch if grad_accum == 1 else
                  {k: v[a::grad_accum] for k, v in batch.items()})
            logp, n = log_likelihood(model, mb)
            # the global batch's count and log-likelihood, summed over
            # 'data'
            ntok = mesh.all_sum(n.float().reshape(1), "data")[0]
            w = ntok.clamp_min(1.0)
            grads = _grad(-logp / w, targets)
            total = mesh.all_sum(logp.detach().reshape(1).clone(),
                                 "data")[0]
            if grad_accum == 1:
                gacc = list(grads)
                lsum, wsum = -total / w, w
                break
            for acc, g in zip(gacc, grads):
                acc.add_(g.float() * ntok)
            lsum = lsum - total / w * ntok
            wsum = wsum + ntok
        # the data-parallel sum of every leaf an FSDP gather did not sum
        gacc = [g if "data" in ax else _sum_data(g, mesh)
                for g, ax in zip(gacc, axes)]
        if grad_accum == 1:
            grads, loss = gacc, lsum
        else:
            w = wsum.clamp_min(1.0)
            grads = [(g / w).to(p.dtype) for g, p in zip(gacc, targets)]
            loss = lsum / w
        span = trace_tools.switch(span, "train.update")
        opt_state = tx.update(dict(zip(names, grads)), state.opt_state,
                              dict(zip(names, targets)))
        metrics = {"loss": loss,
                   "grad_norm": sharded_global_norm(grads, axes, mesh)}
        trace_tools.end(span)
        return TrainState(model, opt_state, state.step + 1), metrics

    return step
