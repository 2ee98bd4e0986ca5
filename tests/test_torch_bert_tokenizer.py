"""runtime/tokenizer.BertTokenizer, GroundingDINO's WordPiece tokenizer
read with no tokenizer library, against transformers.BertTokenizerFast
(what the JAX package's build_detector tokenizes with) on a synthetic
BERT-uncased-style vocabulary ([CLS] 101, [SEP] 102, '.' 1012, '?' 1029):
uncased and cased, from vocab.txt (+ tokenizer_config.json) and from the
fast tokenizer.json, over accents, CJK, punctuation and symbols, control
and odd whitespace, a word past 100 characters, special tokens in the
text and words with no vocabulary piece. The ids are equal."""

import json
import os

from transformers import BertTokenizerFast

from video_llava_tpu_torch.grounding.synthetic import bert_vocab
from video_llava_tpu_torch.models.grounding_dino import SPECIAL_TOKENS
from video_llava_tpu_torch.runtime.tokenizer import BertTokenizer

TEXTS = (
    "The man plays the guitar.",
    "Who is next to the dog?",
    "person . dog . red car .",
    "Résumé of a naïve café?",
    "中国 dog, cat! こんにちは",
    "a" * 101 + " dog " + "b" * 100,
    "unknown zzq Ω words [SEP] x [MASK]y [CLS]",
    "  tabs\tand\nnewlines nbsp  x\x0bz\x85w​q",
    "DOG. Cat? $x+1 <a=b> ^_^ {~|} 3.14",
    "İstanbul ﬁne Ǆ Ångström",
    "ABCdef GHI",
    "",
)


def test_bert_tokenizer_matches_bert_tokenizer_fast(tmp_path):
    vocab = bert_vocab(2048)
    assert [vocab.index(t) for t in ("[CLS]", "[SEP]", ".", "?")] == list(
        SPECIAL_TOKENS)
    for lower in (True, False):
        d = tmp_path / f"lower_{lower}"
        d.mkdir()
        (d / "vocab.txt").write_text("\n".join(vocab) + "\n",
                                     encoding="utf-8")
        (d / "tokenizer_config.json").write_text(
            json.dumps({"do_lower_case": lower}))
        hf = BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                               do_lower_case=lower)
        fast_dir = tmp_path / f"fast_{lower}"
        hf.save_pretrained(str(fast_dir))
        os.remove(fast_dir / "vocab.txt")  # read tokenizer.json alone
        for ours in (BertTokenizer(str(d)), BertTokenizer(str(fast_dir))):
            assert ours.lowercase == lower
            for text in TEXTS:
                want = hf(text).input_ids
                assert ours.encode(text) == want, (lower, text)
                assert ours.encode(text, add_special_tokens=False) == \
                    want[1:-1]
    # the tokenizer marks an unknown word whole, and a long one
    d = tmp_path / "lower_True"
    tok = BertTokenizer(str(d))
    assert tok.encode("zΩq", add_special_tokens=False) == [100]
    assert tok.encode("a" * 101, add_special_tokens=False) == [100]
