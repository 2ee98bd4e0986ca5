"""The byte-level tokenizer of video_llava_tpu/runtime/tokenizer.py: the
same ids for the same text (tests/test_torch_conversation_parity.py)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from video_llava_tpu_torch.constants import (
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
)

class Tokenizer:
    """The interface the port needs."""

    bos_token_id: int
    eos_token_id: int
    pad_token_id: int
    vid_patch_token_id: int
    vid_start_token_id: int
    vid_end_token_id: int

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError


class ByteTokenizer(Tokenizer):
    """Ids 0..255 are bytes, then 256 <pad>, 257 <s>, 258 </s>,
    259 <vid_patch>, 260 <vid_start>, 261 <vid_end>. Special-token
    strings are cut out of the text before byte encoding."""

    PAD, BOS, EOS = 256, 257, 258

    def __init__(self):
        self.pad_token_id = self.PAD
        self.bos_token_id = self.BOS
        self.eos_token_id = self.EOS
        self.vid_patch_token_id = 259
        self.vid_start_token_id = 260
        self.vid_end_token_id = 261
        self._special_strs = {
            DEFAULT_VIDEO_PATCH_TOKEN: self.vid_patch_token_id,
            DEFAULT_VID_START_TOKEN: self.vid_start_token_id,
            DEFAULT_VID_END_TOKEN: self.vid_end_token_id,
            "<s>": self.BOS,
            "</s>": self.EOS,
        }

    @property
    def vocab_size(self) -> int:
        return 262

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.BOS] if add_bos else []
        specials = sorted(self._special_strs, key=len, reverse=True)
        i = 0
        while i < len(text):
            for s in specials:
                if text.startswith(s, i):
                    ids.append(self._special_strs[s])
                    i += len(s)
                    break
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self._special_strs.items()}
        out: List[str] = []
        byte_buf = bytearray()
        for t in map(int, ids):
            if t < 256:
                byte_buf.append(t)
                continue
            out.append(byte_buf.decode("utf-8", errors="replace"))
            byte_buf = bytearray()
            if not skip_special_tokens and t in inv:
                out.append(inv[t])
        out.append(byte_buf.decode("utf-8", errors="replace"))
        return "".join(out)


def load_tokenizer(path: Optional[str] = None) -> Tokenizer:
    """The byte tokenizer. A checkpoint's own tokenizer (`path`) comes
    with checkpoint loading, which the port does not have yet."""
    if path:
        raise NotImplementedError(f"tokenizer files {path!r}: the port "
                                  "has only the byte tokenizer")
    return ByteTokenizer()
