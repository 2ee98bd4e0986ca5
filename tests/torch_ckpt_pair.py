"""Tiny HF-layout checkpoint directories the checkpoint-loading parity
tests share, written with transformers, safetensors and tokenizers (as
tests/test_weight_loading.py writes its LLaMA directory): LLaMA in .bin
or safetensors shards, CLIP towers, a LLaMA-layout tokenizer.json and
the same vocabulary as a SentencePiece tokenizer.model. Not collected:
each tests/test_torch_*.py file that needs them imports this module."""

import json
import os

import numpy as np
import torch
import transformers

VIDEO_TOKENS = ("<vid_patch>", "<vid_start>", "<vid_end>")
SPECIALS = ("<unk>", "<s>", "</s>")

# a LLaMA shaped as LlamaConfig.tiny() (hidden 256, 4 layers, 8 heads of
# 32, intermediate 688) over a vocabulary of BASE_VOCAB pieces
BASE_VOCAB = 400


def hf_llama(vocab_size: int = BASE_VOCAB, seed: int = 0,
             layers: int = 4, kv_heads: int = 8):
    cfg = transformers.LlamaConfig(
        vocab_size=vocab_size, hidden_size=256, intermediate_size=688,
        num_hidden_layers=layers, num_attention_heads=8,
        num_key_value_heads=kv_heads, rms_norm_eps=1e-6,
        tie_word_embeddings=False)
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(cfg).eval()
    with torch.no_grad():  # HF inits norms to 1: give them values
        for name, p in model.named_parameters():
            if "norm" in name:
                p.uniform_(0.5, 1.5)
    return model


def write_shards(d, sd, fmt: str = "safetensors", shards: int = 2,
                 dtype=None) -> None:
    """sd as `shards` files (sorted keys split evenly) + the index, in
    .bin or .safetensors (optionally cast to `dtype`); one file without
    an index when shards == 1."""
    from safetensors.torch import save_file

    os.makedirs(d, exist_ok=True)
    keys = sorted(sd)
    parts = np.array_split(np.arange(len(keys)), shards)
    ext = "safetensors" if fmt == "safetensors" else "bin"
    stem = "model" if fmt == "safetensors" else "pytorch_model"
    weight_map = {}
    for i, idx in enumerate(parts):
        name = (f"{stem}.{ext}" if shards == 1 else
                f"{stem}-{i + 1:05d}-of-{shards:05d}.{ext}")
        part = {keys[j]: sd[keys[j]].detach().contiguous()
                .to(dtype or sd[keys[j]].dtype) for j in idx}
        path = os.path.join(d, name)
        if fmt == "safetensors":
            save_file(part, path)
        else:
            torch.save(part, path)
        weight_map.update({k: name for k in part})
    if shards > 1:
        with open(os.path.join(d, f"{stem}.{ext}.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)


# -- tokenizer ------------------------------------------------------------

CORPUS = ["Hello world, the quick brown fox jumps over the lazy dog.",
          "What is happening in the video? The man is walking.",
          "Describe the scene in detail: a cat sits on the mat.",
          "USER: ASSISTANT: numbers 12345 and symbols !?;: are here"]


def trained_vocab(size: int = BASE_VOCAB):
    """(pieces, merges) of a LLaMA-layout BPE: <unk> <s> </s>, the 256
    byte pieces, then what tokenizers' BpeTrainer learns on CORPUS under
    the legacy normalizer (prepend and escape spaces as ▁)."""
    from tokenizers import Tokenizer, models, normalizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.normalizer = normalizers.Sequence(
        [normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    trainer = trainers.BpeTrainer(
        vocab_size=size - 256, special_tokens=list(SPECIALS),
        show_progress=False)
    tok.train_from_iterator(CORPUS * 10, trainer)
    spec = json.loads(tok.to_str())
    learned = [t for t, _ in sorted(spec["model"]["vocab"].items(),
                                    key=lambda kv: kv[1])
               if t not in SPECIALS]
    pieces = list(SPECIALS) + [f"<0x{b:02X}>" for b in range(256)] + learned
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
              for m in spec["model"]["merges"]]
    return pieces, merges


def write_tokenizer_json(d, legacy: bool = True, size: int = BASE_VOCAB,
                         vocab=None):
    """The fast LLaMA layout: BPE with byte fallback, the legacy
    normalizer (Prepend, Replace) or the Metaspace pre-tokenizer, the
    Replace / ByteFallback / Fuse / Strip decoder, and the configs
    transformers reads; `vocab` (pieces, merges), else trained_vocab's.
    Returns (pieces, merges)."""
    pieces, merges = vocab or trained_vocab(size)
    os.makedirs(d, exist_ok=True)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, t in enumerate(SPECIALS)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]} if legacy else None,
        "pre_tokenizer": None if legacy else {
            "type": "Metaspace", "replacement": "▁",
            "prepend_scheme": "first", "split": False},
        "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": {t: i for i, t in enumerate(pieces)},
                  "merges": [" ".join(m) for m in merges]},
    }
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    write_tokenizer_configs(d, legacy)
    return pieces, merges


def write_tokenizer_configs(d, legacy: bool = True) -> None:
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "LlamaTokenizerFast",
                   "add_bos_token": True, "add_eos_token": False,
                   "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "legacy": legacy,
                   "clean_up_tokenization_spaces": False}, f)
    with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}, f)


def spm_merges(pieces, scores):
    """The merges transformers' LlamaConverter derives from a
    SentencePiece vocabulary (SentencePieceExtractor): every split of a
    piece into two pieces, by the piece's score (best first), then by
    the parts' ids."""
    vocab = {p: i for i, p in enumerate(pieces)}
    merges = []
    for piece, score in scores.items():
        local = [(piece[:i], piece[i:], score) for i in range(1, len(piece))
                 if piece[:i] in vocab and piece[i:] in vocab]
        merges += sorted(local, key=lambda m: (vocab[m[0]], vocab[m[1]]))
    merges.sort(key=lambda m: m[2], reverse=True)
    return [(a, b) for a, b, _ in merges]


def write_sentencepiece_model(d, pieces, merges=(), scores=None) -> dict:
    """The same vocabulary as a SentencePiece BPE tokenizer.model (the
    protobuf through transformers' sentencepiece_model_pb2_new): <unk>
    UNKNOWN, <s> </s> CONTROL, the byte pieces BYTE, the rest NORMAL
    with a score that orders them as the merge that makes each (the
    characters after every merge), or the score `scores` gives the
    piece, LLaMA's normalizer spec. Returns the NORMAL pieces'
    scores."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    made = {a + b: i for i, (a, b) in enumerate(merges)}
    given, scores = scores or {}, {}
    m = pb.ModelProto()
    for i, p in enumerate(pieces):
        sp = m.pieces.add()
        sp.piece = p
        if p == "<unk>":
            sp.type = pb.ModelProto.SentencePiece.UNKNOWN
        elif p in SPECIALS:
            sp.type = pb.ModelProto.SentencePiece.CONTROL
        elif p.startswith("<0x") and len(p) == 6:
            sp.type = pb.ModelProto.SentencePiece.BYTE
        else:
            sp.type = pb.ModelProto.SentencePiece.NORMAL
            sp.score = scores[p] = given.get(
                p, -float(made.get(p, len(merges) + i)))
    m.trainer_spec.model_type = pb.TrainerSpec.BPE
    m.trainer_spec.byte_fallback = True
    m.trainer_spec.unk_id, m.trainer_spec.bos_id = 0, 1
    m.trainer_spec.eos_id, m.trainer_spec.pad_id = 2, -1
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    m.normalizer_spec.escape_whitespaces = True
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.model"), "wb") as f:
        f.write(m.SerializeToString())
    write_tokenizer_configs(d)
    return scores


# -- a whole VideoLLaVA checkpoint ----------------------------------------


def hf_clip_vision(cfg, seed: int = 1):
    """A transformers CLIPVisionModel at a port CLIPVisionConfig's
    shapes (quick_gelu), seeded, with its norms given values."""
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        layer_norm_eps=cfg.layer_norm_eps, hidden_act=cfg.hidden_act)
    torch.manual_seed(seed)
    model = transformers.CLIPVisionModel(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "layrnorm" in name:
                p.uniform_(0.5, 1.5) if name.endswith("weight") else \
                    p.normal_(0.0, 0.1)
    return model


def write_videollava_checkpoint(root, vision_cfg, llm_layers: int = 4):
    """{llm, clip, projector} paths: a LLaMA directory (safetensors
    shards, the tokenizer.json layout), a CLIPVisionModel directory
    (pytorch_model.bin) and an mm_projector.bin of the reference's keys
    (a linear from CLIP's width to the LLM's, and an embed_tokens of the
    vocabulary plus the three video tokens)."""
    llm_dir = os.path.join(root, "llm")
    llm = hf_llama(layers=llm_layers)
    write_shards(llm_dir, llm.state_dict(), "safetensors", shards=2)
    write_tokenizer_json(llm_dir)
    clip_dir = os.path.join(root, "clip")
    hf_clip_vision(vision_cfg).save_pretrained(clip_dir,
                                               safe_serialization=False)
    g = torch.Generator().manual_seed(2)
    d = llm.config.hidden_size
    proj = {
        "model.mm_projector.weight": torch.randn(
            d, vision_cfg.hidden_size, generator=g) * 0.05,
        "model.mm_projector.bias": torch.randn(d, generator=g) * 0.01,
        "model.embed_tokens.weight": torch.randn(
            BASE_VOCAB + 3, d, generator=g) * 0.02,
    }
    proj_path = os.path.join(root, "mm_projector.bin")
    torch.save(proj, proj_path)
    return {"llm": llm_dir, "clip": clip_dir, "projector": proj_path}
