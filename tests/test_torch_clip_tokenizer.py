"""The port's CLIP tokenizer (runtime/tokenizer.CLIPTokenizer, no
tokenizer library) against transformers.CLIPTokenizer, id for id: a tiny
byte-level BPE vocabulary (the 256 byte characters, with and without
</w>, 80 merges learned here from the prompts, the two special tokens
last so the EOT is the largest id) written as vocab.json + merges.txt,
then the crop filter's ten templates over class names of mixed case,
punctuation, digits, an accent, a contraction and runs of whitespace.
The same vocabulary read from the tokenizer.json that transformers'
fast tokenizer writes gives the same ids."""

import transformers

from torch_xmem_pair import clip_prompts as texts
from torch_xmem_pair import write_clip_vocab as write_vocab
from video_llava_tpu_torch.runtime.tokenizer import CLIPTokenizer


def test_clip_tokenizer_matches_transformers(tmp_path):
    slow_dir = tmp_path / "slow"
    slow_dir.mkdir()
    n = write_vocab(slow_dir)
    ref = transformers.CLIPTokenizer(str(slow_dir / "vocab.json"),
                                     str(slow_dir / "merges.txt"))
    ours = CLIPTokenizer(str(slow_dir))
    assert ours.vocab_size == n
    assert ours.eos_token_id == n - 1 == max(ref.get_vocab().values())
    merged = 0
    for text in texts():
        want = ref(text).input_ids
        got = ours.encode(text)
        assert got == want, text
        assert got[0] == ours.bos_token_id and got[-1] == ours.eos_token_id
        merged += len(got) < len(text.encode())
    assert merged == len(texts())  # the merges fire

    fast_dir = tmp_path / "fast"
    transformers.CLIPTokenizerFast.from_pretrained(
        str(slow_dir)).save_pretrained(str(fast_dir))
    (fast_dir / "vocab.json").unlink(missing_ok=True)
    (fast_dir / "merges.txt").unlink(missing_ok=True)
    from_json = CLIPTokenizer(str(fast_dir))
    fast = transformers.CLIPTokenizerFast.from_pretrained(str(fast_dir))
    for text in texts():
        assert from_json.encode(text) == ours.encode(text), text
        assert from_json.encode(text) == fast(text).input_ids, text
