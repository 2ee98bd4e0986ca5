"""LlamaTokenizer (runtime/tokenizer.py), which uses no tokenizer library.
The tokenizer.json branch against the JAX package's HFTokenizer
(transformers.AutoTokenizer plus the three video tokens) on the legacy
LLaMA layout (Prepend/Replace normalizer) and the Metaspace layout: ids
for texts with spaces, newlines, unicode, characters only byte fallback
covers, </s> and the video tokens, with and without bos; decode with and
without the special tokens; bos, eos, pad, the video ids and vocab_size.
An added_tokens.json that already holds the video tokens keeps their
ids. The tokenizer.model branch (SentencePiece BPE, the protobuf read by
hand) equals, id for id, the tokenizer.json branch over the merges
transformers derives from the same vocabulary, which in turn equals
HFTokenizer there. Those merges come from scores the writer set from
the merge ranks, so score order and rank order coincide there; a
hand-made vocabulary whose scores run against its pieces' ids and hold
ties is held against ids worked out by hand from SentencePiece's BPE
rule (the best-scored pair first, the leftmost of equal scores; the
sentencepiece library is not installed to compare with).
load_tokenizer falls back to the byte tokenizer without a directory."""

import json
import os

from torch_ckpt_pair import (
    spm_merges,
    trained_vocab,
    write_sentencepiece_model,
    write_tokenizer_json,
)
from video_llava_tpu.runtime.tokenizer import HFTokenizer
from video_llava_tpu_torch.runtime import tokenizer as tk

TEXTS = [
    "Hello world", " leading space", "What is  happening?\nThe man walks.",
    "über 中文 emoji 😀 naïve café", "tabs\tand\r\nnewlines  ",
    "<vid_start><vid_patch><vid_patch><vid_end> Describe the video.",
    "USER: hi</s>ASSISTANT: the dog</s>", "a<vid_patch>b", "",
    "numbers 12345!?;:", "The quick brown fox jumps over the lazy dog.",
]


def _same(a, b, texts=TEXTS):
    ids = (a.vid_patch_token_id, a.vid_start_token_id, a.vid_end_token_id,
           a.bos_token_id, a.eos_token_id, a.pad_token_id, a.vocab_size)
    assert ids == (b.vid_patch_token_id, b.vid_start_token_id,
                   b.vid_end_token_id, b.bos_token_id, b.eos_token_id,
                   b.pad_token_id, b.vocab_size)
    for t in texts:
        for bos in (True, False):
            assert a.encode(t, bos) == b.encode(t, bos), (t, bos)
        ids = a.encode(t)
        for skip in (True, False):
            assert a.decode(ids, skip) == b.decode(ids, skip), (t, skip)


def test_llama_tokenizer_matches_hf(tmp_path):
    for legacy in (True, False):
        d = str(tmp_path / f"json{legacy}")
        pieces, merges = write_tokenizer_json(d, legacy)
        port, ref = tk.LlamaTokenizer(d), HFTokenizer(d)
        _same(port, ref)
        assert (port.vid_patch_token_id, port.vid_end_token_id) == (
            len(pieces), len(pieces) + 2)
        assert isinstance(tk.load_tokenizer(d), tk.LlamaTokenizer)

    # video tokens already in added_tokens.json keep their ids
    d = str(tmp_path / "added")
    write_tokenizer_json(d, vocab=(pieces, merges))
    with open(os.path.join(d, "added_tokens.json"), "w") as f:
        json.dump({"<vid_end>": len(pieces), "<vid_patch>": len(pieces) + 1,
                   "<vid_start>": len(pieces) + 2}, f)
    port, ref = tk.LlamaTokenizer(d), HFTokenizer(d)
    _same(port, ref)
    assert port.vid_end_token_id == len(pieces)

    # SentencePiece: the same vocabulary both ways
    sp_dir, json_dir = str(tmp_path / "spm"), str(tmp_path / "spm_json")
    scores = write_sentencepiece_model(sp_dir, pieces, merges)
    write_tokenizer_json(json_dir, vocab=(pieces, spm_merges(pieces,
                                                             scores)))
    assert not os.path.exists(os.path.join(sp_dir, "tokenizer.json"))
    slow, fast = tk.LlamaTokenizer(sp_dir), tk.LlamaTokenizer(json_dir)
    assert slow.ranks is None and fast.scores is None
    _same(slow, fast)
    _same(fast, HFTokenizer(json_dir))
    sp = tk.read_sentencepiece_model(os.path.join(sp_dir, "tokenizer.model"))
    assert [p for p, _, _ in sp["pieces"]] == pieces
    assert (sp["model_type"], sp["byte_fallback"], sp["pad_id"]) == (
        2, True, -1)

    # scores against id order, and ties: the expected ids by hand
    _scored_sentencepiece(str(tmp_path / "scored"))

    assert isinstance(tk.load_tokenizer(None), tk.ByteTokenizer)
    assert isinstance(tk.load_tokenizer(str(tmp_path / "missing")),
                      tk.ByteTokenizer)
    assert trained_vocab()[0] == pieces


# ids 259-274 after <unk> <s> </s> and the 256 byte pieces (3-258)
SCORED = {"▁": -1.0, "a": -2.0, "b": -3.0, "c": -4.0, "d": -5.0,
          "ab": -30.0, "bc": -10.0, "cd": -10.0, "▁a": -20.0,
          "abc": -40.0, "bcd": -5.0, "x": -6.0, "y": -7.0, "z": -8.0,
          "xy": -9.0, "yz": -9.0}


def _scored_sentencepiece(d):
    """SentencePiece BPE over SCORED: the pair whose merged piece scores
    highest merges first (not the piece with the lowest id, not the
    first pair), the leftmost of equal scores."""
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    pieces += list(SCORED)
    write_sentencepiece_model(d, pieces, scores=SCORED)
    tok = tk.LlamaTokenizer(d)
    ids = {p: i for i, p in enumerate(pieces)}
    want = {
        # ▁ a b c d: bc and cd tie at -10, bc is left of cd; then bcd (-5)
        # before ▁a (-20); abc (-40) never forms. By id rank: ▁ ab cd.
        "abcd": ["▁a", "bcd"],
        # ▁ a b c: bc (-10), then ▁a (-20) before a+bc = abc (-40)
        "abc": ["▁a", "bc"],
        # ▁ c a b: only ab is a piece
        "cab": ["▁", "c", "ab"],
        # x y z: xy and yz tie at -9, the left pair merges
        "xyz": ["▁", "xy", "z"],
        # a space becomes ▁; é is no piece: its two UTF-8 bytes
        "dab é": ["▁", "d", "ab", "▁", "<0xC3>", "<0xA9>"],
    }
    for text, toks in want.items():
        got = tok.encode(text, add_bos=False)
        assert got == [ids[t] for t in toks], (text, got)
        assert tok.encode(text) == [1] + got
        assert tok.decode(got) == text
