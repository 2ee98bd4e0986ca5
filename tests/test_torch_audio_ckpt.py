"""The audio checkpoint branches (audio/builders.py, the converters in
models/whisper.py and models/wav2vec2.py) against the JAX package's
builders on the same files: a tiny transformers
WhisperForConditionalGeneration directory with Whisper's vocab.json +
merges.txt, the same directory with only a tokenizer.json (the JAX
package's transformers.AutoTokenizer fallback; the port's own byte-level
BPE), a whisper-at TL-TR head .pth and a tiny Wav2Vec2ForCTC with its
vocab.json (the base configuration stood in for by tiny_test in both
packages, to keep the test small). Every parameter equals the JAX
package's tree carried across by engine/convert.py (exact; the
positional conv's folded weight norm within 1e-6, f32 sums in another
order); start tokens, eot, the timestamp layout, the tag filter mode
and decode_text agree."""

import json
import os

import numpy as np
import jax
import torch
import transformers

from video_llava_tpu.audio import builders as jb
from video_llava_tpu.models import wav2vec2 as jw2v
from video_llava_tpu_torch.audio import builders as tb
from video_llava_tpu_torch.audio.tokenizer import _bytes_to_unicode
from video_llava_tpu_torch.engine.convert import (
    flatten_tree,
    tree_from_jax,
    wav2vec2_from_jax,
    whisper_from_jax,
)
from video_llava_tpu_torch.models import wav2vec2 as tw2v
from video_llava_tpu_torch.models import whisper as tw
from video_llava_tpu_torch.models.layers import TreeInit

SPECIAL = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|de|>",
           "<|translate|>", "<|transcribe|>", "<|startoflm|>",
           "<|startofprev|>", "<|nocaptions|>", "<|notimestamps|>"]


def _whisper_assets(d, json_only: bool):
    """A byte-level BPE over the 256 byte symbols and a few merges, the
    special tokens after them."""
    chars = list(_bytes_to_unicode().values())
    merges = [("t", "h"), ("th", "e"), ("Ġ", "the"), ("a", "t")]
    vocab = {c: i for i, c in enumerate(chars)}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    for t in SPECIAL:
        vocab[t] = len(vocab)
    if not json_only:
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                                for a, b in merges))
        return vocab
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    base = {k: v for k, v in vocab.items() if k not in SPECIAL}
    tok = Tokenizer(models.BPE(base, merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(SPECIAL)
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return vocab


def _tltr_sd(atc, g):
    d, sd = atc.att_dim, {}

    def lin(name, o, i):
        sd[f"{name}.weight"] = torch.randn(o, i, generator=g) * i ** -0.5
        sd[f"{name}.bias"] = torch.randn(o, generator=g) * 0.1

    def ln(name, n):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(n, generator=g)
        sd[f"{name}.bias"] = 0.1 * torch.randn(n, generator=g)

    for kind, n in (("time_tr", atc.time_blocks),
                    ("layer_tr", atc.layer_blocks)):
        for i in range(n):
            p = f"{kind}.{i}"
            ln(f"{p}.norm1", d)
            lin(f"{p}.attn.qkv", 3 * d, d)
            lin(f"{p}.attn.proj", d, d)
            ln(f"{p}.norm2", d)
            lin(f"{p}.mlp.fc1", 4 * d, d)
            lin(f"{p}.mlp.fc2", d, 4 * d)
    ln("mlp_head.0", d)
    lin("mlp_head.1", atc.n_class, d)
    lin("mlp_down", d, atc.rep_dim)
    return sd


def _same_tree(port, want, atol=0.0):
    got, ref = flatten_tree(port), flatten_tree(want)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=atol, rtol=0, err_msg=k)


def test_audio_checkpoints_match_jax(tmp_path, monkeypatch):
    hf_cfg = transformers.WhisperConfig(
        vocab_size=256, num_mel_bins=80, d_model=64, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=64, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)
    torch.manual_seed(0)
    whisper = transformers.WhisperForConditionalGeneration(hf_cfg)
    g = torch.Generator().manual_seed(1)
    atc = tw.WhisperATConfig(rep_dim=64, att_dim=32, n_class=16)
    at_path = str(tmp_path / "tltr.pth")
    torch.save({"state_dict": _tltr_sd(atc, g)}, at_path)

    # the aligner: Wav2Vec2ForCTC at tiny_test, the published weight_g /
    # weight_v names for the positional conv
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
             **{chr(ord("A") + i): 5 + i for i in range(7)}}
    small = tw2v.Wav2Vec2Config.tiny_test()
    torch.manual_seed(2)
    w2v = transformers.Wav2Vec2ForCTC(transformers.Wav2Vec2Config(
        vocab_size=len(vocab), hidden_size=small.hidden_size,
        num_hidden_layers=small.num_layers,
        num_attention_heads=small.num_heads,
        intermediate_size=small.intermediate_size,
        conv_dim=small.conv_dim, conv_kernel=small.conv_kernel,
        conv_stride=small.conv_stride,
        num_conv_pos_embeddings=small.pos_conv_kernel,
        num_conv_pos_embedding_groups=small.pos_conv_groups,
        feat_extract_norm="group", do_stable_layer_norm=False))
    w2v_dir = tmp_path / "w2v"
    w2v_dir.mkdir()
    names = {"parametrizations.weight.original0": "weight_g",
             "parametrizations.weight.original1": "weight_v"}
    sd = {}
    for k, v in w2v.state_dict().items():
        for a, b in names.items():
            k = k.replace(a, b)
        sd[k] = v
    torch.save(sd, str(w2v_dir / "pytorch_model.bin"))
    (w2v_dir / "vocab.json").write_text(json.dumps(vocab))
    for mod in (jw2v, tw2v):  # the base configuration, at tiny size
        monkeypatch.setattr(mod.Wav2Vec2Config, "base",
                            classmethod(lambda cls: cls.tiny_test()))

    for json_only in (False, True):
        d = tmp_path / f"whisper{json_only}"
        whisper.save_pretrained(str(d), safe_serialization=json_only)
        vocab_w = _whisper_assets(str(d), json_only)
        kw = dict(checkpoint_dir=str(d), size="tiny-test",
                  at_checkpoint=at_path, at_cfg=atc,
                  align_checkpoint_dir=str(w2v_dir))
        t = tb.build_default_transcriber(device="cpu", **kw)
        j = jb.build_default_transcriber(**kw)
        like = tw.init_params(TreeInit(0, "meta"),
                              tw.WhisperConfig.tiny_test())
        like["at_head"] = tw.init_at_head_tltr(TreeInit(0, "meta"), atc)
        jp = jax.tree.map(np.asarray, j.params)
        _same_tree(t.params, whisper_from_jax(jp, like))
        assert (tuple(t.start_tokens), t.eot_token, t._at_mode,
                t.timestamp_begin) == (tuple(j.start_tokens), j.eot_token,
                                       j._at_mode, j.timestamp_begin)
        ids = [vocab_w["the"], vocab_w["Ġthe"], 65, 66, vocab_w["<|en|>"],
               vocab_w["at"], 200]
        assert t.decode_text(ids) == j.decode_text(ids)
        alike = tw2v.init_params(TreeInit(0, "meta"), tw2v.Wav2Vec2Config(
            **{**tw2v.Wav2Vec2Config.tiny_test().__dict__,
               "vocab_size": len(vocab)}))
        ja = jax.tree.map(np.asarray, j.aligner.params)
        _same_tree(t.aligner.params, wav2vec2_from_jax(ja, alike),
                   atol=1e-6)
        assert t.aligner.vocab == j.aligner.vocab
        assert t.aligner.cfg.__dict__ == j.aligner.cfg.__dict__
    # the head alone, through the converter
    head = tw.convert_whisper_at(torch.load(at_path)["state_dict"], atc)
    _same_tree(head, tree_from_jax(jp["at_head"], like["at_head"]))
