"""XMem learned space-time-memory mask propagation.

Counterpart of video_llava_tpu/models/xmem.py: the reference tracker
propagates masks with a trained DEVA network (grounding_evaluation/
grounding_new_api.py:20-24, :279-286, :503-509), whose propagation core
is XMem: a ResNet-50 key encoder, a ResNet-18 value encoder, the
anisotropic-similarity memory read with a top-k softmax, and a grouped
decoder with a sensory GRU (key_dim 64, value_dim 512, top_k 30,
mem_every 5 at grounding_new_api.py:44-59).

As in the JAX package: objects fold into the batch dim up to
`max_objects`; the working memory is a ring of `mem_slots` frames whose
slot 0 (the first write) is never evicted; the optional long-term store
(`lt_slots` > 0) takes the `lt_prototypes` most-used elements of each
evicted slot. Layout is torch's (NCHW activations, OIHW weights; see
models/resnet.py). A memory key flattens its (h, w) grid row-major, the
order the top-k and the consolidation index. The state's tensors are
updated in place (each step returns the state with its host counters
advanced); its counters (next slot, live objects, long-term cursor) are
Python ints, so no step waits on the device for them. Ties in the top-k
break toward the lower index, as jax.lax.top_k does
(ops/topk.stable_topk).

`propagate_chunk` is a loop over the chunk (the JAX package's lax.scan)
after one batched key encode, with the same per-frame update / deep /
valid flags. `convert_xmem_checkpoint` maps the official torch layout
(XMem.pth, the XMem-lineage submodules of DEVA-propagation.pth).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import TreeInit
from video_llava_tpu_torch.models.resnet import (
    ResNetTrunkConfig,
    batch_norm,
    bn_init,
    conv2d,
    conv_init,
    convert_torch_trunk,
    init_trunk_params,
    torch_bn,
    torch_conv,
    trunk_forward,
)
from video_llava_tpu_torch.ops.topk import stable_topk

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class XMemConfig:
    key_dim: int = 64  # grounding_new_api.py:46
    value_dim: int = 512  # :47
    hidden_dim: int = 64  # sensory memory channels
    max_objects: int = 8
    mem_slots: int = 10  # mid-term frames (:52)
    top_k: int = 30  # :55
    mem_every: int = 5  # (:56)
    deep_update_every: int = 5
    # Long-term prototypes (0: off, the <= 100-frame regime). When > 0,
    # each eviction of a ring slot moves its lt_prototypes most-used
    # elements into a ring of lt_slots elements that reads attend to.
    # As in the JAX package: the prototype values are the elements' own,
    # and the long-term store is itself a ring.
    lt_slots: int = 0
    lt_prototypes: int = 64

    @property
    def f16_dim(self) -> int:  # ResNet-50 layer3
        return 1024

    @property
    def value_trunk_dim(self) -> int:  # ResNet-18 layer3
        return 256


KEY_TRUNK = ResNetTrunkConfig.resnet50()
VALUE_TRUNK = ResNetTrunkConfig.resnet18(in_channels=5)  # rgb+mask+others


# -- building blocks ----------------------------------------------------------


def _group_res_block_init(init: TreeInit, cin: int, cout: int) -> dict:
    p = {"conv1": conv_init(init, 3, 3, cin, cout, use_bias=True),
         "conv2": conv_init(init, 3, 3, cout, cout, use_bias=True)}
    if cin != cout:
        p["downsample"] = conv_init(init, 3, 3, cin, cout, use_bias=True)
    return p


def group_res_block(p, g: torch.Tensor) -> torch.Tensor:
    out = conv2d(p["conv1"], F.relu(g))
    out = conv2d(p["conv2"], F.relu(out))
    if "downsample" in p:
        g = conv2d(p["downsample"], g)
    return out + g


def _cbam_init(init: TreeInit, c: int, reduction: int = 16) -> dict:
    mid = c // reduction
    return {
        "mlp1": {"kernel": init.normal((c, mid), math.sqrt(2.0 / c)),
                 "bias": init.zeros((mid,))},
        "mlp2": {"kernel": init.normal((mid, c), math.sqrt(2.0 / mid)),
                 "bias": init.zeros((c,))},
        "spatial": {"conv": conv_init(init, 7, 7, 2, 1),
                    "bn": bn_init(init, 1)},
    }


def cbam(p, x: torch.Tensor) -> torch.Tensor:
    """Channel gate (a shared MLP on the average- and max-pooled
    channels), then the spatial gate (a 7x7 conv with BN on the [max,
    mean] channel maps). x (..., C, H, W)."""
    def gate(pooled):
        h = F.relu(pooled @ p["mlp1"]["kernel"] + p["mlp1"]["bias"])
        return h @ p["mlp2"]["kernel"] + p["mlp2"]["bias"]

    avg = x.mean(dim=(-2, -1))
    mx = x.amax(dim=(-2, -1))
    x = x * torch.sigmoid(gate(avg) + gate(mx))[..., None, None]
    comp = torch.stack([x.amax(dim=-3), x.mean(dim=-3)], dim=-3)
    sp = batch_norm(p["spatial"]["bn"], conv2d(p["spatial"]["conv"], comp))
    return x * torch.sigmoid(sp)


def _fuser_init(init: TreeInit, x_dim: int, g_dim: int, mid: int,
                out: int) -> dict:
    return {"block1": _group_res_block_init(init, x_dim + g_dim, mid),
            "attention": _cbam_init(init, mid),
            "block2": _group_res_block_init(init, mid, out)}


def feature_fusion(p, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (Cx, h, w) frame feature, g (O, Cg, h, w) per object -> (O, out,
    h, w)."""
    g = torch.cat([x[None].expand((g.shape[0],) + x.shape), g], dim=1)
    g = group_res_block(p["block1"], g)
    r = cbam(p["attention"], g)
    return group_res_block(p["block2"], g + r)


def _gru_update(transform_p, inputs: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """XMem's conv-GRU: values = conv(cat(inputs, h)); new h = forget * h
    * (1 - update) + update * tanh(candidate)."""
    hd = h.shape[-3]
    values = conv2d(transform_p, torch.cat([inputs, h], dim=-3))
    forget = torch.sigmoid(values[:, :hd])
    update = torch.sigmoid(values[:, hd:2 * hd])
    cand = torch.tanh(values[:, 2 * hd:])
    return forget * h * (1.0 - update) + update * cand


def _avg_pool(x: torch.Tensor, ratio: int) -> torch.Tensor:
    return F.avg_pool2d(x, ratio)


def _upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear upsampling by `factor` (jax.image.resize's 'bilinear',
    which at the borders renormalizes its triangle weights to the input
    sample F.interpolate clamps to)."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=False)


# -- model params -------------------------------------------------------------


def init_params(init: TreeInit, cfg: XMemConfig = XMemConfig()) -> dict:
    kd, vd, hd = cfg.key_dim, cfg.value_dim, cfg.hidden_dim
    f16 = cfg.f16_dim
    return {
        "key_encoder": init_trunk_params(init, KEY_TRUNK),
        "key_proj": {
            "key_proj": conv_init(init, 3, 3, f16, kd, use_bias=True),
            "d_proj": conv_init(init, 3, 3, f16, 1, use_bias=True),
            "e_proj": conv_init(init, 3, 3, f16, kd, use_bias=True),
        },
        "value_encoder": {
            "trunk": init_trunk_params(init, VALUE_TRUNK),
            "fuser": _fuser_init(init, f16, cfg.value_trunk_dim, vd, vd),
            "hidden_reinforce": {"transform": conv_init(
                init, 3, 3, vd + hd, hd * 3, use_bias=True)},
        },
        "decoder": {
            "fuser": _fuser_init(init, f16, vd + hd, 512, 512),
            "hidden_update": {
                "g16_conv": conv_init(init, 1, 1, 512, 256, use_bias=True),
                "g8_conv": conv_init(init, 1, 1, 256, 256, use_bias=True),
                "g4_conv": conv_init(init, 1, 1, 257, 256, use_bias=True),
                "transform": conv_init(init, 3, 3, 256 + hd, hd * 3,
                                       use_bias=True),
            },
            "up_16_8": {
                "skip_conv": conv_init(init, 3, 3, 512, 512, use_bias=True),
                "out_conv": _group_res_block_init(init, 512, 256),
            },
            "up_8_4": {
                "skip_conv": conv_init(init, 3, 3, 256, 256, use_bias=True),
                "out_conv": _group_res_block_init(init, 256, 256),
            },
            "pred": conv_init(init, 3, 3, 256, 1, use_bias=True),
        },
    }


def params_device(params) -> torch.device:
    return params["key_encoder"]["conv1"]["weight"].device


# -- forward pieces -----------------------------------------------------------


def normalize_frame(frame: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 (cast / 255 here, on the frame's device) or
    float in [0, 1] -> ImageNet-normalized (..., 3, H, W) f32."""
    x = frame.float() / 255.0 if frame.dtype == torch.uint8 else frame.float()
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).movedim(-1, -3)


def batched_key_encode(params, frames: torch.Tensor):
    """(T, H, W, 3) -> (f4, f8, f16, key, shrinkage, selection), each with
    a leading T: the key encoder over the whole batch. shrinkage =
    d_proj(x)^2 + 1 (T, h, w), selection = sigmoid(e_proj(x)): XMem's
    anisotropic similarity terms."""
    f4, f8, f16 = trunk_forward(params["key_encoder"], normalize_frame(frames),
                                KEY_TRUNK)
    kp = params["key_proj"]
    key = conv2d(kp["key_proj"], f16)
    shrinkage = conv2d(kp["d_proj"], f16).square()[:, 0] + 1.0
    selection = torch.sigmoid(conv2d(kp["e_proj"], f16))
    return f4, f8, f16, key, shrinkage, selection


def encode_key(params, frame: torch.Tensor):
    """frame (H, W, 3) -> (f16, f8, f4, key (Ck, h, w), shrinkage (h, w),
    selection (Ck, h, w)), key and its terms at stride 16."""
    f4, f8, f16, key, shrinkage, selection = batched_key_encode(
        params, frame[None])
    return f16[0], f8[0], f4[0], key[0], shrinkage[0], selection[0]


def encode_value(params, frame: torch.Tensor, f16: torch.Tensor,
                 hidden: Optional[torch.Tensor], masks: torch.Tensor,
                 deep_update: bool = True):
    """frame (H, W, 3), f16 (1024, h, w), masks (O, H, W) in [0, 1] ->
    (value (O, Cv, h, w), new hidden). An object's `others` channel is
    the clamped sum of the other objects' masks."""
    o = masks.shape[0]
    others = torch.clamp(masks.sum(dim=0)[None] - masks, 0.0, 1.0)
    img = normalize_frame(frame)[None].expand(o, -1, -1, -1)
    g = torch.cat([img, masks[:, None], others[:, None]], dim=1)
    p = params["value_encoder"]
    _, _, g16 = trunk_forward(p["trunk"], g, VALUE_TRUNK)
    value = feature_fusion(p["fuser"], f16, g16)
    new_hidden = hidden
    if deep_update and hidden is not None:
        new_hidden = _gru_update(p["hidden_reinforce"]["transform"], value,
                                 hidden)
    return value, new_hidden


def read_memory(mem_keys: torch.Tensor,  # (M, Ck)
                mem_shrinkage: torch.Tensor,  # (M,)
                mem_values: torch.Tensor,  # (M, O, Cv)
                valid: torch.Tensor,  # (M,) bool
                query_key: torch.Tensor,  # (N, Ck)
                selection: torch.Tensor,  # (N, Ck)
                top_k: int, return_attention: bool = False):
    """XMem's anisotropic-L2 memory read -> (N, O, Cv) [, (top_idx (N,
    k), att (N, k))]:
      similarity[n, m] = -(sum_c qe[n, c] (mk[m, c] - qk[n, c])^2)
                         * shrinkage[m] / sqrt(Ck),
    softmax over each query's top_k valid entries."""
    ck = query_key.shape[-1]
    a_sq = selection @ mem_keys.square().T  # (N, M)
    two_ab = 2.0 * ((query_key * selection) @ mem_keys.T)
    b_sq = (selection * query_key.square()).sum(dim=-1)  # (N,)
    sim = (-a_sq + two_ab - b_sq[:, None]) * mem_shrinkage[None, :]
    sim = torch.where(valid[None, :], sim / math.sqrt(ck), -math.inf)
    top_sim, top_idx = stable_topk(sim, min(top_k, sim.shape[1]))
    # invalid entries (-inf) get no weight; a read always has a valid
    # slot after the first write
    att = torch.softmax(top_sim, dim=-1)
    readout = torch.einsum("nk,nkoc->noc", att, mem_values[top_idx])
    if return_attention:
        return readout, (top_idx, att)
    return readout


def decode(params, f16: torch.Tensor, f8: torch.Tensor, f4: torch.Tensor,
           hidden: torch.Tensor,  # (O, hd, h16, w16)
           readout: torch.Tensor,  # (O, Cv, h16, w16)
           update_hidden: bool = True):
    """-> (logits (O, H, W), new hidden): fuse the readout and the sensory
    hidden state with f16, upsample through the f8 and f4 skips, predict
    each object's logits, GRU-update the hidden state."""
    p = params["decoder"]
    g16 = feature_fusion(p["fuser"], f16, torch.cat([readout, hidden], 1))
    g8 = group_res_block(
        p["up_16_8"]["out_conv"],
        conv2d(p["up_16_8"]["skip_conv"], f8)[None] + _upsample(g16, 2))
    g4 = group_res_block(
        p["up_8_4"]["out_conv"],
        conv2d(p["up_8_4"]["skip_conv"], f4)[None] + _upsample(g8, 2))
    logits = conv2d(p["pred"], F.relu(g4))  # (O, 1, h4, w4)
    new_hidden = hidden
    if update_hidden:
        hu = p["hidden_update"]
        g4l = torch.cat([g4, logits], dim=1)
        mid = (conv2d(hu["g16_conv"], g16)
               + conv2d(hu["g8_conv"], _avg_pool(g8, 2))
               + conv2d(hu["g4_conv"], _avg_pool(g4l, 4)))
        new_hidden = _gru_update(hu["transform"], mid, hidden)
    return _upsample(logits, 4)[:, 0], new_hidden


def aggregate(prob: torch.Tensor) -> torch.Tensor:
    """Soft aggregation with an implicit background (XMem's aggregate):
    prob (O, H, W) -> normalized (1 + O, H, W), background first."""
    bg = torch.prod(1.0 - prob, dim=0, keepdim=True)
    new_prob = torch.clamp(torch.cat([bg, prob], dim=0), 1e-7, 1.0 - 1e-7)
    return torch.softmax(torch.log(new_prob / (1.0 - new_prob)), dim=0)


# -- session (ring-buffer working memory) -------------------------------------


class XMemState(NamedTuple):
    keys: torch.Tensor  # (S, N, Ck)
    shrinkage: torch.Tensor  # (S, N)
    values: torch.Tensor  # (S, N, O, Cv)
    slot_valid: torch.Tensor  # (S,) bool
    next_slot: int  # writes so far
    hidden: torch.Tensor  # (O, hd, h16, w16)
    num_objects: int  # live objects
    # long-term store (zero-size when cfg.lt_slots == 0):
    usage: torch.Tensor  # (S, N) attention mass per ring element
    lt_keys: torch.Tensor  # (L, Ck)
    lt_shrinkage: torch.Tensor  # (L,)
    lt_values: torch.Tensor  # (L, O, Cv)
    lt_valid: torch.Tensor  # (L,) bool
    lt_next: int


def init_state(cfg: XMemConfig, h16: int, w16: int, device=None,
               dtype=torch.float32) -> XMemState:
    n = h16 * w16
    ls = cfg.lt_slots
    kw = dict(device=device, dtype=dtype)
    return XMemState(
        keys=torch.zeros((cfg.mem_slots, n, cfg.key_dim), **kw),
        shrinkage=torch.ones((cfg.mem_slots, n), **kw),
        values=torch.zeros((cfg.mem_slots, n, cfg.max_objects,
                            cfg.value_dim), **kw),
        slot_valid=torch.zeros((cfg.mem_slots,), dtype=torch.bool,
                               device=device),
        next_slot=0,
        hidden=torch.zeros((cfg.max_objects, cfg.hidden_dim, h16, w16),
                           **kw),
        num_objects=0,
        usage=torch.zeros((cfg.mem_slots if ls else 0, n if ls else 0),
                          **kw),
        lt_keys=torch.zeros((ls, cfg.key_dim), **kw),
        lt_shrinkage=torch.ones((ls,), **kw),
        lt_values=torch.zeros((ls, cfg.max_objects, cfg.value_dim), **kw),
        lt_valid=torch.zeros((ls,), dtype=torch.bool, device=device),
        lt_next=0,
    )


def _memory_views(state: XMemState, cfg: XMemConfig, n: int):
    """(keys (M, Ck), shrinkage (M,), values (M, O, Cv), valid (M,)):
    the ring's S * n elements first, then the long-term store's."""
    keys = state.keys.reshape(-1, cfg.key_dim)
    shr = state.shrinkage.reshape(-1)
    vals = state.values.reshape(-1, cfg.max_objects, cfg.value_dim)
    valid = state.slot_valid.repeat_interleave(n)
    if cfg.lt_slots:
        keys = torch.cat([keys, state.lt_keys])
        shr = torch.cat([shr, state.lt_shrinkage])
        vals = torch.cat([vals, state.lt_values])
        valid = torch.cat([valid, state.lt_valid])
    return keys, shr, vals, valid


def _accumulate_usage(state: XMemState, cfg: XMemConfig,
                      top_idx: torch.Tensor, att: torch.Tensor,
                      n: int) -> XMemState:
    """Add a read's attention mass onto the ring elements it attended
    (XMem's usage statistic, read at eviction)."""
    if cfg.lt_slots:
        m = cfg.mem_slots * n + cfg.lt_slots
        flat = torch.zeros((m,), dtype=state.usage.dtype,
                           device=att.device).index_add_(
            0, top_idx.reshape(-1), att.reshape(-1).to(state.usage.dtype))
        state.usage.add_(flat[:cfg.mem_slots * n].view(cfg.mem_slots, n))
    return state


def _write_slot(state: XMemState) -> int:
    """The ring slot the next write takes: slot 0 once (the reference
    frame's memory, never evicted), then slots 1..S-1 in turn."""
    size = state.keys.shape[0]
    return (0 if state.next_slot == 0
            else 1 + (state.next_slot - 1) % (size - 1))


def _write(state: XMemState, key: torch.Tensor, shrinkage: torch.Tensor,
           value: torch.Tensor,
           cfg: Optional[XMemConfig] = None) -> XMemState:
    """key (N, Ck), shrinkage (N,), value (N, O, Cv) into the next ring
    slot (consolidating the slot it evicts when the long-term store is
    on)."""
    s = _write_slot(state)
    if cfg is not None and cfg.lt_slots:
        state = _consolidate_evicted(state, s, cfg)
        state.usage[s] = 0.0
    state.keys[s] = key
    state.shrinkage[s] = shrinkage
    state.values[s] = value
    state.slot_valid[s] = True
    return state._replace(next_slot=state.next_slot + 1)


def _consolidate_evicted(state: XMemState, s: int,
                         cfg: XMemConfig) -> XMemState:
    """Before the ring overwrites an occupied slot, copy its
    lt_prototypes most-used elements (ties to the lower index) into the
    long-term ring. A slot is occupied iff an earlier write took it:
    slot s >= 1 is first written at write s."""
    if not (s >= 1 and state.next_slot > s):
        return state
    n = state.keys.shape[1]
    p = min(cfg.lt_prototypes, n)
    _, idx = stable_topk(state.usage[s], p)
    pos = (state.lt_next + torch.arange(p, device=idx.device)) % cfg.lt_slots
    state.lt_keys[pos] = state.keys[s][idx]
    state.lt_shrinkage[pos] = state.shrinkage[s][idx]
    state.lt_values[pos] = state.values[s][idx]
    state.lt_valid[pos] = True
    return state._replace(lt_next=state.lt_next + p)


def _flat(key: torch.Tensor, shrinkage: torch.Tensor,
          value: Optional[torch.Tensor] = None):
    """Stride-16 maps -> memory rows, (h, w) row-major: key (Ck, h, w) ->
    (N, Ck), shrinkage (h, w) -> (N,), value (O, Cv, h, w) -> (N, O,
    Cv)."""
    ck = key.shape[0]
    n = key.shape[1] * key.shape[2]
    out = (key.reshape(ck, n).T, shrinkage.reshape(n))
    if value is not None:
        out += (value.reshape(value.shape[0], value.shape[1], n)
                .permute(2, 0, 1),)
    return out


def read_decode(params, state: XMemState, f16, f8, f4, key, sel,
                cfg: XMemConfig):
    """Memory read and grouped decode of one frame -> (prob (O, H, W),
    new hidden, the state with its usage accumulated): the read half of
    propagate_step."""
    ck, h16, w16 = key.shape
    n = h16 * w16
    mk, ms, mv, mvalid = _memory_views(state, cfg, n)
    readout, (top_idx, att) = read_memory(
        mk, ms, mv, mvalid, key.reshape(ck, n).T, sel.reshape(ck, n).T,
        cfg.top_k, return_attention=True)
    state = _accumulate_usage(state, cfg, top_idx, att, n)
    readout = readout.permute(1, 2, 0).reshape(cfg.max_objects,
                                               cfg.value_dim, h16, w16)
    logits, hidden = decode(params, f16, f8, f4, state.hidden, readout,
                            update_hidden=True)
    obj_valid = (torch.arange(cfg.max_objects, device=logits.device)
                 < state.num_objects)[:, None, None]
    prob = torch.sigmoid(logits) * obj_valid
    return aggregate(prob)[1:], hidden, state


def value_write(params, state: XMemState, frame, f16, key, shr,
                masks: torch.Tensor, cfg: XMemConfig,
                deep: bool) -> XMemState:
    """encode_value of `masks`, then the ring write; the hidden state
    takes the deep update when `deep`."""
    value, hidden_deep = encode_value(params, frame, f16, state.hidden,
                                      masks, deep_update=True)
    if deep:
        state = state._replace(hidden=hidden_deep)
    return _write(state, *_flat(key, shr, value), cfg)


def _out(prob: torch.Tensor, binary: bool) -> torch.Tensor:
    return (prob > 0.5).to(torch.uint8) if binary else prob


@torch.inference_mode()
def add_reference_step(params, state: XMemState, frame: torch.Tensor,
                       masks: torch.Tensor, num_objects: int,
                       cfg: XMemConfig) -> XMemState:
    """Ground-truth or detector masks (O, H, W) of a frame -> a memory
    write with the deep sensory update. uint8 {0, 1} masks cast here."""
    masks = masks.float()
    f16, _, _, key, shrinkage, _ = encode_key(params, frame)
    value, hidden = encode_value(params, frame, f16, state.hidden, masks,
                                 deep_update=True)
    state = state._replace(hidden=hidden, num_objects=max(
        state.num_objects, int(num_objects)))
    return _write(state, *_flat(key, shrinkage, value), cfg)


@torch.inference_mode()
def propagate_step(params, state: XMemState, frame: torch.Tensor,
                   cfg: XMemConfig, update_memory: bool = False,
                   deep_update: bool = False, binary: bool = False
                   ) -> Tuple[torch.Tensor, XMemState]:
    """One tracked frame -> ((O, H, W) object probabilities, or uint8
    {0, 1} masks with `binary`; the state). Replaces deva.step
    (grounding_new_api.py:503-509): encode the query, read the memory,
    decode; with update_memory, value-encode the prediction back into
    memory (the mem_every cadence is the caller's)."""
    f16, f8, f4, key, shrinkage, selection = encode_key(params, frame)
    prob, hidden, state = read_decode(params, state, f16, f8, f4, key,
                                      selection, cfg)
    state = state._replace(hidden=hidden)
    if update_memory:
        value, hidden2 = encode_value(params, frame, f16, state.hidden, prob,
                                      deep_update=deep_update)
        state = _write(state._replace(hidden=hidden2),
                       *_flat(key, shrinkage, value), cfg)
    return _out(prob, binary), state


@torch.inference_mode()
def propagate_chunk(params, state: XMemState, frames: torch.Tensor,
                    update_memory: Sequence[bool], deep_update: Sequence[bool],
                    cfg: XMemConfig, valid: Optional[Sequence[bool]] = None,
                    binary: bool = False) -> Tuple[torch.Tensor, XMemState]:
    """T tracked frames (T, H, W, 3) -> ((T, O, H, W) probabilities, or
    uint8 masks with `binary`; the state): the key encoder once over the
    chunk, then per frame the read, decode and GRU and, where
    update_memory says, the write (deep_update: the write's deep hidden
    update), as T propagate_step calls give. A frame that `valid` marks
    False (the padding of a fixed-length chunk) advances nothing and
    writes nothing, and its output is zeros; as in the JAX package's
    scan, its read still adds to the long-term usage when that store is
    on."""
    t_count = frames.shape[0]
    valid = [True] * t_count if valid is None else [bool(v) for v in valid]
    f4, f8, f16, key, shrinkage, selection = batched_key_encode(params,
                                                                frames)
    h, w = frames.shape[1:3]
    outs = []
    for t in range(t_count):
        if not valid[t]:
            if cfg.lt_slots:
                ck, h16, w16 = key[t].shape
                n = h16 * w16
                _, (top_idx, att) = read_memory(
                    *_memory_views(state, cfg, n), key[t].reshape(ck, n).T,
                    selection[t].reshape(ck, n).T, cfg.top_k,
                    return_attention=True)
                state = _accumulate_usage(state, cfg, top_idx, att, n)
            outs.append(torch.zeros(
                (cfg.max_objects, h, w), device=key.device,
                dtype=torch.uint8 if binary else torch.float32))
            continue
        prob, hidden, state = read_decode(params, state, f16[t], f8[t],
                                          f4[t], key[t], selection[t], cfg)
        state = state._replace(hidden=hidden)
        if update_memory[t]:
            state = value_write(params, state, frames[t], f16[t], key[t],
                                shrinkage[t], prob, cfg,
                                deep=bool(deep_update[t]))
        outs.append(_out(prob, binary))
    return torch.stack(outs), state


# -- torch checkpoint conversion ----------------------------------------------


def _fuser_from_torch(sd, prefix: str, device, dtype) -> dict:
    def conv(name):
        return torch_conv(sd, name, device, dtype)

    def grb(name):
        p = {"conv1": conv(f"{name}.conv1"), "conv2": conv(f"{name}.conv2")}
        if f"{name}.downsample.weight" in sd:
            p["downsample"] = conv(f"{name}.downsample")
        return p

    def t(key):
        return sd[key].to(device=device, dtype=dtype)

    att = f"{prefix}.attention"
    return {
        "block1": grb(f"{prefix}.block1"),
        "attention": {
            "mlp1": {"kernel": t(f"{att}.ChannelGate.mlp.1.weight").T
                     .contiguous(),
                     "bias": t(f"{att}.ChannelGate.mlp.1.bias")},
            "mlp2": {"kernel": t(f"{att}.ChannelGate.mlp.3.weight").T
                     .contiguous(),
                     "bias": t(f"{att}.ChannelGate.mlp.3.bias")},
            "spatial": {
                "conv": conv(f"{att}.SpatialGate.spatial.conv"),
                "bn": torch_bn(sd, f"{att}.SpatialGate.spatial.bn", device,
                               dtype),
            },
        },
        "block2": grb(f"{prefix}.block2"),
    }


def convert_xmem_checkpoint(sd, cfg: XMemConfig = XMemConfig(), device=None,
                            dtype=torch.float32) -> dict:
    """An official XMem-layout torch state dict (XMem.pth; the
    key_encoder / key_proj / value_encoder / decoder submodules of
    DEVA-propagation.pth) -> the params tree on `device`: convolutions
    stay OIHW, the CBAM linears transpose to (in, out). A missing tensor
    raises KeyError."""
    def conv(name):
        return torch_conv(sd, name, device, dtype)

    d = "decoder"
    return {
        "key_encoder": convert_torch_trunk(sd, KEY_TRUNK, "key_encoder.",
                                           device, dtype),
        "key_proj": {k: conv(f"key_proj.{k}")
                     for k in ("key_proj", "d_proj", "e_proj")},
        "value_encoder": {
            "trunk": convert_torch_trunk(sd, VALUE_TRUNK, "value_encoder.",
                                         device, dtype),
            "fuser": _fuser_from_torch(sd, "value_encoder.fuser", device,
                                       dtype),
            "hidden_reinforce": {"transform": conv(
                "value_encoder.hidden_reinforce.transform")},
        },
        "decoder": {
            "fuser": _fuser_from_torch(sd, f"{d}.fuser", device, dtype),
            "hidden_update": {k: conv(f"{d}.hidden_update.{k}")
                              for k in ("g16_conv", "g8_conv", "g4_conv",
                                        "transform")},
            "up_16_8": {
                "skip_conv": conv(f"{d}.up_16_8.skip_conv"),
                "out_conv": {
                    "conv1": conv(f"{d}.up_16_8.out_conv.conv1"),
                    "conv2": conv(f"{d}.up_16_8.out_conv.conv2"),
                    "downsample": conv(f"{d}.up_16_8.out_conv.downsample"),
                },
            },
            "up_8_4": {
                "skip_conv": conv(f"{d}.up_8_4.skip_conv"),
                "out_conv": {
                    "conv1": conv(f"{d}.up_8_4.out_conv.conv1"),
                    "conv2": conv(f"{d}.up_8_4.out_conv.conv2"),
                },
            },
            "pred": conv(f"{d}.pred"),
        },
    }
