"""Seeded stand-ins for what the repository does not hold, for running
the grounding stack from checkpoints and its evaluation without the
released files: parameter trees written as released checkpoints (the
inverse of the converters: GroundingDINO's original-repo .pth, SAM's HF
SamModel, MobileSAM's mobile_sam.pt, RAM's release), a BERT-uncased-style
vocabulary, VidOR / VidSTG / HC-STVG annotation files and seeded frames
for the datasets' decode. Shared by chip_smoke.py and the parity tests.

The writers take the port's trees (any device) and return state dicts of
f32 CPU tensors in the released names and layouts; read back by the
converters, every leaf equals the tree's (BatchNorms are written with
unit statistics so that folding them is exact; RAM's label embeddings
are folded through wordvec_proj, see ram_state).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.models.tiny_vit import attention_bias_index

StateDict = Dict[str, torch.Tensor]


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).contiguous()


def _put_linear(sd: StateDict, prefix: str, p: dict) -> None:
    sd[prefix + "weight"] = _cpu(p["kernel"].t())
    if "bias" in p:
        sd[prefix + "bias"] = _cpu(p["bias"])


def _put_norm(sd: StateDict, prefix: str, p: dict) -> None:
    sd[prefix + "weight"] = _cpu(p["scale"])
    sd[prefix + "bias"] = _cpu(p["bias"])


def _patch_weight(kernel: torch.Tensor, patch: int) -> torch.Tensor:
    """A (P * P * 3, C) patch kernel -> the conv's (C, 3, P, P) weight."""
    return _cpu(kernel.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1))


def _conv_weight(kernel: torch.Tensor) -> torch.Tensor:
    """(in, out) -> (out, in, 1, 1); HWIO -> OIHW."""
    if kernel.dim() == 2:
        return _cpu(kernel.t()[:, :, None, None])
    return _cpu(kernel.permute(3, 2, 0, 1))


# -- Swin and BERT --------------------------------------------------------------


def swin_timm_state(params, cfg, prefix: str = "",
                    final_norm: bool = True) -> StateDict:
    """A Swin tree -> timm names (swin.convert_timm_swin's input);
    final_norm False leaves out the last LayerNorm (GroundingDINO's
    backbone has per-stage norms instead)."""
    sd: StateDict = {}
    pe = params["patch_embed"]
    sd[prefix + "patch_embed.proj.weight"] = _patch_weight(pe["kernel"],
                                                           cfg.patch_size)
    sd[prefix + "patch_embed.proj.bias"] = _cpu(pe["bias"])
    _put_norm(sd, prefix + "patch_embed.norm.", params["patch_norm"])
    for s, stage in enumerate(params["stages"]):
        for i, blk in enumerate(stage["blocks"]):
            p = f"{prefix}layers.{s}.blocks.{i}."
            _put_norm(sd, p + "norm1.", blk["ln1"])
            _put_linear(sd, p + "attn.qkv.", blk["qkv"])
            _put_linear(sd, p + "attn.proj.", blk["proj"])
            sd[p + "attn.relative_position_bias_table"] = _cpu(
                blk["rel_bias"])
            _put_norm(sd, p + "norm2.", blk["ln2"])
            _put_linear(sd, p + "mlp.fc1.", blk["fc1"])
            _put_linear(sd, p + "mlp.fc2.", blk["fc2"])
        if "downsample" in stage:
            d = f"{prefix}layers.{s}.downsample."
            _put_norm(sd, d + "norm.", stage["downsample"]["norm"])
            _put_linear(sd, d + "reduction.",
                        stage["downsample"]["reduction"])
    if final_norm:
        _put_norm(sd, prefix + "norm.", params["final_norm"])
    return sd


def bert_hf_state(params, prefix: str = "") -> StateDict:
    """A BERT tree -> HF BertModel names (bert.convert_hf_bert's
    input)."""
    sd: StateDict = {}
    e = prefix + "embeddings."
    sd[e + "word_embeddings.weight"] = _cpu(
        params["word_embeddings"]["weight"])
    sd[e + "position_embeddings.weight"] = _cpu(
        params["position_embeddings"])
    sd[e + "token_type_embeddings.weight"] = _cpu(
        params["token_type_embeddings"])
    _put_norm(sd, e + "LayerNorm.", params["embed_ln"])
    for i, lp in enumerate(params["layers"]):
        p = f"{prefix}encoder.layer.{i}."
        for ours, theirs in (("q", "attention.self.query."),
                             ("k", "attention.self.key."),
                             ("v", "attention.self.value."),
                             ("attn_out", "attention.output.dense."),
                             ("fc1", "intermediate.dense."),
                             ("fc2", "output.dense.")):
            _put_linear(sd, p + theirs, lp[ours])
        _put_norm(sd, p + "attention.output.LayerNorm.", lp["attn_ln"])
        _put_norm(sd, p + "output.LayerNorm.", lp["out_ln"])
    return sd


# -- GroundingDINO ----------------------------------------------------------------


def gdino_original_state(params, cfg) -> StateDict:
    """A GroundingDINO tree -> the original repo's names and layouts
    (groundingdino_swint_ogc.pth: grounding_dino
    .convert_original_grounding_dino's input)."""
    sd: StateDict = {}

    def fused(prefix, p):
        sd[prefix + "in_proj_weight"] = torch.cat(
            [_cpu(p[n]["kernel"].t()) for n in "qkv"])
        sd[prefix + "in_proj_bias"] = torch.cat([_cpu(p[n]["bias"])
                                                 for n in "qkv"])
        _put_linear(sd, prefix + "out_proj.", p["o"])

    def deform(prefix, p):
        for name in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            _put_linear(sd, f"{prefix}{name}.", p[name])

    def mlp(prefix, p):
        for i in range(len(p)):
            _put_linear(sd, f"{prefix}layers.{i}.", p[f"layer{i}"])

    sd.update(swin_timm_state(params["swin"], cfg.swin, "backbone.0.",
                              final_norm=False))
    for i, si in enumerate(cfg.backbone_stage_indices):
        _put_norm(sd, f"backbone.0.norm{si}.", params["backbone_norms"][i])
    for i, p in enumerate(params["input_proj"]):
        sd[f"input_proj.{i}.0.weight"] = _conv_weight(p["conv"]["kernel"])
        sd[f"input_proj.{i}.0.bias"] = _cpu(p["conv"]["bias"])
        _put_norm(sd, f"input_proj.{i}.1.", p["gn"])
    sd.update(bert_hf_state(params["text_backbone"], "bert."))
    _put_linear(sd, "feat_map.", params["text_projection"])
    sd["transformer.level_embed"] = _cpu(params["level_embed"])
    for i, lp in enumerate(params["encoder_layers"]):
        fus = f"transformer.encoder.fusion_layers.{i}."
        f = lp["fusion"]
        _put_norm(sd, fus + "layer_norm_v.", f["ln_vision"])
        _put_norm(sd, fus + "layer_norm_l.", f["ln_text"])
        sd[fus + "gamma_v"] = _cpu(f["vision_param"])
        sd[fus + "gamma_l"] = _cpu(f["text_param"])
        for theirs, ours in (("v_proj", "vision_proj"),
                             ("l_proj", "text_proj"),
                             ("values_v_proj", "values_vision_proj"),
                             ("values_l_proj", "values_text_proj"),
                             ("out_v_proj", "out_vision_proj"),
                             ("out_l_proj", "out_text_proj")):
            _put_linear(sd, f"{fus}attn.{theirs}.", f[ours])
        txt = f"transformer.encoder.text_layers.{i}."
        te = lp["text_enhancer"]
        fused(txt + "self_attn.", te["attn"])
        _put_linear(sd, txt + "linear1.", te["fc1"])
        _put_linear(sd, txt + "linear2.", te["fc2"])
        _put_norm(sd, txt + "norm1.", te["ln1"])
        _put_norm(sd, txt + "norm2.", te["ln2"])
        dfm = f"transformer.encoder.layers.{i}."
        de = lp["deformable"]
        deform(dfm + "self_attn.", de)
        _put_norm(sd, dfm + "norm1.", de["ln1"])
        _put_linear(sd, dfm + "linear1.", de["fc1"])
        _put_linear(sd, dfm + "linear2.", de["fc2"])
        _put_norm(sd, dfm + "norm2.", de["ln2"])
    for i, lp in enumerate(params["decoder_layers"]):
        p = f"transformer.decoder.layers.{i}."
        fused(p + "self_attn.", lp["self_attn"])
        _put_norm(sd, p + "norm2.", lp["self_attn_ln"])
        fused(p + "ca_text.", lp["text_cross_attn"])
        _put_norm(sd, p + "catext_norm.", lp["text_cross_attn_ln"])
        deform(p + "cross_attn.", lp["deform_cross_attn"])
        _put_norm(sd, p + "norm1.", lp["deform_cross_attn_ln"])
        _put_linear(sd, p + "linear1.", lp["fc1"])
        _put_linear(sd, p + "linear2.", lp["fc2"])
        _put_norm(sd, p + "norm3.", lp["final_ln"])
    _put_linear(sd, "transformer.enc_output.", params["enc_output"])
    _put_norm(sd, "transformer.enc_output_norm.", params["enc_output_norm"])
    mlp("transformer.enc_out_bbox_embed.", params["encoder_bbox_head"])
    sd["transformer.tgt_embed.weight"] = _cpu(params["query_embeds"])
    mlp("transformer.decoder.ref_point_head.", params["ref_point_head"])
    _put_norm(sd, "transformer.decoder.norm.", params["decoder_norm"])
    for i, head in enumerate(params["bbox_heads"]):
        mlp(f"bbox_embed.{i}.", head)
    return sd


# -- SAM -------------------------------------------------------------------------


def _two_way_state(sd: StateDict, dec, norm_name: str) -> None:
    md = "mask_decoder.transformer."

    def attn(prefix, p):
        for ours, theirs in (("q", "q"), ("k", "k"), ("v", "v"),
                             ("o", "out")):
            _put_linear(sd, f"{prefix}{theirs}_proj.", p[ours])

    for i, lp in enumerate(dec["layers"]):
        p = f"{md}layers.{i}."
        attn(p + "self_attn.", lp["self_attn"])
        attn(p + "cross_attn_token_to_image.", lp["cross_attn_t2i"])
        attn(p + "cross_attn_image_to_token.", lp["cross_attn_i2t"])
        _put_linear(sd, p + "mlp.lin1.", lp["fc1"])
        _put_linear(sd, p + "mlp.lin2.", lp["fc2"])
        for j in range(1, 5):
            _put_norm(sd, p + norm_name.format(j), lp[f"ln{j}"])
    attn(md + "final_attn_token_to_image.", dec["final_attn"])


def sam_hf_state(params, cfg) -> StateDict:
    """A SAM tree with its ViT encoder under 'vision' -> HF SamModel's
    names (sam.convert_hf_sam's input; facebook/sam-vit-base's
    layout)."""
    sd: StateDict = {}
    v, ve = params["vision"], "vision_encoder."
    sd[ve + "patch_embed.projection.weight"] = _patch_weight(
        v["patch_embed"]["kernel"], cfg.vision.patch_size)
    sd[ve + "patch_embed.projection.bias"] = _cpu(v["patch_embed"]["bias"])
    sd[ve + "pos_embed"] = _cpu(v["pos_embed"])
    for i, lp in enumerate(v["layers"]):
        p = f"{ve}layers.{i}."
        _put_norm(sd, p + "layer_norm1.", lp["ln1"])
        _put_linear(sd, p + "attn.qkv.", lp["qkv"])
        _put_linear(sd, p + "attn.proj.", lp["proj"])
        sd[p + "attn.rel_pos_h"] = _cpu(lp["rel_pos_h"])
        sd[p + "attn.rel_pos_w"] = _cpu(lp["rel_pos_w"])
        _put_norm(sd, p + "layer_norm2.", lp["ln2"])
        _put_linear(sd, p + "mlp.lin1.", lp["fc1"])
        _put_linear(sd, p + "mlp.lin2.", lp["fc2"])
    neck = v["neck"]
    sd[ve + "neck.conv1.weight"] = _conv_weight(neck["conv1"])
    _put_norm(sd, ve + "neck.layer_norm1.", neck["ln1"])
    sd[ve + "neck.conv2.weight"] = _conv_weight(neck["conv2"])
    _put_norm(sd, ve + "neck.layer_norm2.", neck["ln2"])
    pe = _cpu(params["shared_pe"])
    sd["shared_image_embedding.positional_embedding"] = pe
    sd["prompt_encoder.shared_embedding.positional_embedding"] = pe
    for i in range(4):
        sd[f"prompt_encoder.point_embed.{i}.weight"] = _cpu(
            params["point_embed"][i][None])
    sd["prompt_encoder.no_mask_embed.weight"] = _cpu(params["no_mask_embed"])
    dec, md = params["mask_decoder"], "mask_decoder."
    sd[md + "iou_token.weight"] = _cpu(dec["iou_token"])
    sd[md + "mask_tokens.weight"] = _cpu(dec["mask_tokens"])
    _two_way_state(sd, dec, "layer_norm{}.")
    _put_norm(sd, md + "transformer.layer_norm_final_attn.", dec["ln_final"])
    for name in ("up1", "up2"):
        key = md + f"upscale_conv{name[-1]}."
        sd[key + "weight"] = _cpu(dec[name]["kernel"])
        sd[key + "bias"] = _cpu(dec[name]["bias"])
    _put_norm(sd, md + "upscale_layer_norm.", dec["up_ln"])
    heads = [(f"{md}output_hypernetworks_mlps.{i}.", h)
             for i, h in enumerate(dec["hyper_mlps"])]
    for prefix, h in heads + [(md + "iou_prediction_head.",
                               dec["iou_head"])]:
        _put_linear(sd, prefix + "proj_in.", h["lin0"])
        _put_linear(sd, prefix + "layers.0.", h["lin1"])
        _put_linear(sd, prefix + "proj_out.", h["lin2"])
    return sd


def _conv_bn(sd: StateDict, prefix: str, p: dict, eps: float = 1e-5):
    """A folded conv {'kernel', 'bias'} -> Conv2d_BN keys whose BatchNorm
    folds to exactly that conv: running mean 0, variance 1, weight
    sqrt(1 + eps) (so weight / sqrt(var + eps) is 1), bias the conv's."""
    sd[prefix + "c.weight"] = _conv_weight(p["kernel"])
    c = p["bias"].numel()
    sd[prefix + "bn.weight"] = torch.sqrt(torch.ones(c) + eps)
    sd[prefix + "bn.bias"] = _cpu(p["bias"])
    sd[prefix + "bn.running_mean"] = torch.zeros(c)
    sd[prefix + "bn.running_var"] = torch.ones(c)


def mobile_sam_state(params, tiny_cfg) -> StateDict:
    """A MobileSAM tree (TinyViT under 'vision', SAM's prompt encoder and
    mask decoder) -> the official mobile_sam.pt names
    (tiny_vit.convert_tiny_vit + sam.convert_official_sam_decoder's
    input). Each attention's dense bias goes back to its offset table;
    attention_bias_idxs is not written (the official buffer is not
    persistent)."""
    sd: StateDict = {}
    v, ie = params["vision"], "image_encoder."
    _conv_bn(sd, ie + "patch_embed.seq.0.", v["patch_embed"]["conv1"])
    _conv_bn(sd, ie + "patch_embed.seq.2.", v["patch_embed"]["conv2"])
    for j, blk in enumerate(v["stage0"]):
        for k in (1, 2, 3):
            _conv_bn(sd, f"{ie}layers.0.blocks.{j}.conv{k}.", blk[f"conv{k}"])
    for i, merge in enumerate(v["merges"]):
        for k in (1, 2, 3):
            _conv_bn(sd, f"{ie}layers.{i}.downsample.conv{k}.",
                     merge[f"conv{k}"])
    for si, blocks in enumerate(v["stages"]):
        idx, n_off = attention_bias_index(tiny_cfg.window_sizes[si + 1])
        flat = torch.as_tensor(idx.reshape(-1))
        for j, blk in enumerate(blocks):
            p = f"{ie}layers.{si + 1}.blocks.{j}."
            a = blk["attn"]
            dense_bias = _cpu(a["bias"])
            table = torch.zeros(dense_bias.shape[0], n_off)
            table[:, flat] = dense_bias.reshape(dense_bias.shape[0], -1)
            sd[p + "attn.attention_biases"] = table
            _put_norm(sd, p + "attn.norm.", a["norm"])
            _put_linear(sd, p + "attn.qkv.", a["qkv"])
            _put_linear(sd, p + "attn.proj.", a["proj"])
            _conv_bn(sd, p + "local_conv.", blk["local_conv"])
            _put_norm(sd, p + "mlp.norm.", blk["mlp"]["norm"])
            _put_linear(sd, p + "mlp.fc1.", blk["mlp"]["fc1"])
            _put_linear(sd, p + "mlp.fc2.", blk["mlp"]["fc2"])
    neck = v["neck"]
    sd[ie + "neck.0.weight"] = _conv_weight(neck["conv1"])
    _put_norm(sd, ie + "neck.1.", neck["ln1"])
    sd[ie + "neck.2.weight"] = _conv_weight(neck["conv2"])
    _put_norm(sd, ie + "neck.3.", neck["ln2"])

    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _cpu(
        params["shared_pe"])
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = _cpu(
            params["point_embed"][i][None])
    sd["prompt_encoder.no_mask_embed.weight"] = _cpu(params["no_mask_embed"])
    dec, md = params["mask_decoder"], "mask_decoder."
    sd[md + "iou_token.weight"] = _cpu(dec["iou_token"])
    sd[md + "mask_tokens.weight"] = _cpu(dec["mask_tokens"])
    _two_way_state(sd, dec, "norm{}.")
    _put_norm(sd, md + "transformer.norm_final_attn.", dec["ln_final"])
    sd[md + "output_upscaling.0.weight"] = _cpu(dec["up1"]["kernel"])
    sd[md + "output_upscaling.0.bias"] = _cpu(dec["up1"]["bias"])
    _put_norm(sd, md + "output_upscaling.1.", dec["up_ln"])
    sd[md + "output_upscaling.3.weight"] = _cpu(dec["up2"]["kernel"])
    sd[md + "output_upscaling.3.bias"] = _cpu(dec["up2"]["bias"])
    heads = [(f"{md}output_hypernetworks_mlps.{i}.", h)
             for i, h in enumerate(dec["hyper_mlps"])]
    for prefix, h in heads + [(md + "iou_prediction_head.",
                               dec["iou_head"])]:
        for i in range(3):
            _put_linear(sd, f"{prefix}layers.{i}.", h[f"lin{i}"])
    return sd


# -- RAM -------------------------------------------------------------------------


def ram_state(backbone, ram_params, swin_cfg, wordvec: dict,
              thresholds: np.ndarray) -> StateDict:
    """A Swin backbone and a RAM decoder tree -> the release's names
    (ram.convert_ram_checkpoint's input): ram_params['label_embeddings']
    is written as the raw label_embed beside wordvec_proj ({'kernel',
    'bias'}), so the converter's fold gives relu(label @ kernel + bias),
    and the thresholds as class_threshold."""
    sd = swin_timm_state(backbone, swin_cfg, "visual_encoder.")
    sd["label_embed"] = _cpu(ram_params["label_embeddings"])
    _put_linear(sd, "wordvec_proj.", wordvec)
    _put_linear(sd, "image_proj.", ram_params["image_proj"])
    for i, lp in enumerate(ram_params["layers"]):
        pre = f"tagging_head.encoder.layer.{i}."
        blocks = [("crossattention.", lp["cross"])]
        if "self" in lp:
            blocks.append(("attention.", lp["self"]))
        for name, blk in blocks:
            for ours, theirs in (("q", "self.query."), ("k", "self.key."),
                                 ("v", "self.value."),
                                 ("o", "output.dense.")):
                _put_linear(sd, pre + name + theirs, blk[ours])
            _put_norm(sd, pre + name + "output.LayerNorm.", blk["ln"])
        _put_linear(sd, pre + "intermediate.dense.", lp["fc1"])
        _put_linear(sd, pre + "output.dense.", lp["fc2"])
        _put_norm(sd, pre + "output.LayerNorm.", lp["ffn_ln"])
    _put_linear(sd, "fc.", ram_params["head"])
    sd["class_threshold"] = torch.as_tensor(np.asarray(thresholds,
                                                       np.float32))
    return sd


# -- BERT vocabulary --------------------------------------------------------------

WORDS = (
    "the a an of in on at to and with is are was his her their man woman "
    "person people child boy girl baby adult dog cat horse car bicycle "
    "ball guitar table chair sofa bed door window tree grass sky road "
    "water food phone toy red blue green black white yellow brown old "
    "young small big left right front behind next who what where which "
    "holding riding walking running sitting standing playing watching "
    "points inside outside near above below object"
).split()


def bert_vocab(size: int = 30522) -> List[str]:
    """A BERT-uncased-style vocabulary of `size` tokens: [PAD] 0,
    [unused*], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, then from 999
    the printable ASCII characters without capitals in BERT's order ('.'
    1012, '?' 1029: the detector's SPECIAL_TOKENS), '##' pieces of the
    letters and digits, a few caption words, filler."""
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    toks += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += [f"[unused{i}]" for i in range(99, 99 + 999 - len(toks))]
    toks += [chr(c) for c in range(33, 127) if not 65 <= c <= 90]
    toks += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    toks += [w for w in WORDS if w not in toks]
    toks += [f"tok{i}" for i in range(len(toks), size)]
    return toks[:size]


def write_bert_vocab(directory: str, size: int = 30522) -> str:
    """vocab.txt of bert_vocab(size) in `directory` (created) -> the
    directory, what build_detector takes as tokenizer_name."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(bert_vocab(size)) + "\n")
    return directory


# -- grounding datasets -------------------------------------------------------------

def _box(rng, w: int, h: int) -> List[float]:
    bw, bh = rng.uniform(0.15, 0.4) * w, rng.uniform(0.2, 0.5) * h
    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    return [float(x0), float(y0), float(x0 + bw), float(y0 + bh)]


def write_vidstg_annotations(vidor_dir: str, vidstg_dir: str,
                             n_videos: int = 2, frames: int = 300,
                             fps: float = 30.0, hw: Tuple[int, int] = (360,
                                                                       640),
                             seed: int = 0) -> List[str]:
    """Raw VidOR annotations (training/ and validation/, a JSON a video
    with per-frame trajectories) and VidSTG's train / test annotations
    (a question and a caption per video over a used segment and a
    temporal tube), in the layouts preprocess_grounding_annotations
    reads. -> the validation videos' paths (relative to the video
    folder's video/ directory)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    paths = []
    for split, prefix in (("training", "tr"), ("validation", "va")):
        anns = []
        for k in range(n_videos):
            vid = f"{prefix}{k:04d}"
            sub = f"{1000 + k}"
            os.makedirs(os.path.join(vidor_dir, split, sub), exist_ok=True)
            path = f"{sub}/{vid}.mp4"
            tracks = {tid: (_box(rng, w, h), rng.uniform(-1, 1, 2))
                      for tid in (0, 1)}
            trajectories = []
            for f_ in range(frames):
                row = []
                for tid, (box, vel) in tracks.items():
                    dx, dy = vel * f_ * 0.3
                    row.append({"tid": tid, "generated": 0, "tracker": "none",
                                "bbox": {"xmin": box[0] + dx,
                                         "ymin": box[1] + dy,
                                         "xmax": box[2] + dx,
                                         "ymax": box[3] + dy}})
                trajectories.append(row)
            with open(os.path.join(vidor_dir, split, sub, vid + ".json"),
                      "w") as f:
                json.dump({"video_id": vid, "video_path": path,
                           "frame_count": frames, "fps": fps, "width": w,
                           "height": h,
                           "subject/objects": [
                               {"tid": 0, "category": "adult"},
                               {"tid": 1, "category": "dog"}],
                           "trajectories": trajectories}, f)
            begin, end = int(frames * 0.1), int(frames * 0.9)
            t0 = int(rng.integers(begin, (begin + end) // 2))
            anns.append({
                "vid": vid, "frame_count": frames, "fps": fps, "width": w,
                "height": h,
                "used_segment": {"begin_fid": begin, "end_fid": end},
                "temporal_gt": {"begin_fid": t0,
                                "end_fid": int(rng.integers(t0 + 30, end))},
                "questions": [{"description": "who is next to the dog?",
                               "type": "sub", "target_id": 0}],
                "captions": [{"description": "a dog runs on the grass.",
                              "type": "obj", "target_id": 1}],
            })
            if split == "validation":
                paths.append(path)
        name = ("train_annotations.json" if split == "training"
                else "test_annotations.json")
        os.makedirs(vidstg_dir, exist_ok=True)
        with open(os.path.join(vidstg_dir, name), "w") as f:
            json.dump(anns, f)
    return paths


def write_hcstvg_annotations(video_dir: str, ann_dir: str,
                             n_videos: int = 2, frames: int = 500,
                             hw: Tuple[int, int] = (360, 640),
                             seed: int = 1) -> List[str]:
    """Raw HC-STVG v2 val annotations (val_v2.json: a 20 s video's tube
    of ltwh boxes from st_frame, the English query) and an empty .mp4 a
    video in video_dir (the preprocessing maps names to paths), in the
    layout preprocess_grounding_annotations reads. -> the videos'
    names."""
    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(video_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    anns, names = {}, []
    for k in range(n_videos):
        name = f"hc{k:04d}.mp4"
        open(os.path.join(video_dir, name), "wb").close()
        st = int(rng.integers(1, frames // 3))
        n_box = int(rng.integers(frames // 4, frames // 2))
        x0, y0, x1, y1 = _box(rng, w, h)
        boxes = [[x0 + i * 0.2, y0, x1 - x0, y1 - y0] for i in range(n_box)]
        anns[name] = {"img_num": frames, "img_size": [h, w], "st_frame": st,
                      "bbox": boxes, "st_time": st / 25.0,
                      "ed_time": (st + n_box) / 25.0,
                      "English": "the man in a red shirt walks to the "
                                 "door."}
        names.append(name)
    with open(os.path.join(ann_dir, "val_v2.json"), "w") as f:
        json.dump(anns, f)
    return names


def seeded_frames(video_path: str, frame_ids: Sequence[int],
                  hw: Tuple[int, int] = (360, 640)) -> np.ndarray:
    """Stand-in for grounding_datasets._decode_frames where no decoder or
    no video is at hand: (len(frame_ids), h, w, 3) uint8, a smooth
    background seeded by the path and a square moving with the frame
    id, the same for the same (path, id) in every process."""
    h, w = hw
    rng = np.random.default_rng(zlib.crc32(video_path.encode()))
    corners = rng.uniform(0, 255, (2, 2, 3))
    yy = np.linspace(0, 1, h)[:, None, None]
    xx = np.linspace(0, 1, w)[None, :, None]
    bg = ((1 - yy) * ((1 - xx) * corners[0, 0] + xx * corners[0, 1])
          + yy * ((1 - xx) * corners[1, 0] + xx * corners[1, 1]))
    size = h // 4
    color = rng.integers(0, 256, 3)
    out = np.repeat(bg[None].astype(np.uint8), len(frame_ids), axis=0)
    for i, fid in enumerate(frame_ids):
        y = (int(fid) * 3) % (h - size)
        x = (int(fid) * 5) % (w - size)
        out[i, y:y + size, x:x + size] = color
    return out
