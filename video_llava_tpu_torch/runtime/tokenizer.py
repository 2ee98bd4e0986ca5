"""Tokenizers: the byte-level tokenizer of
video_llava_tpu/runtime/tokenizer.py (the same ids for the same text,
tests/test_torch_conversation_parity.py) and a checkpoint's own LLaMA
tokenizer, read without any tokenizer library (the JAX package's
HFTokenizer is transformers.AutoTokenizer plus the three video tokens).

:class:`LlamaTokenizer` reads a checkpoint directory's ``tokenizer.json``
(the fast layout: BPE over a vocabulary and ranked merges with byte
fallback, its normalizer, pre-tokenizer and decoder) or, without one,
its ``tokenizer.model`` (SentencePiece BPE: the pieces, scores and types
read from the protobuf by a minimal wire-format reader; the best-scored
pair merges first), plus ``added_tokens.json``,
``special_tokens_map.json`` and ``tokenizer_config.json``.

:class:`CLIPTokenizer` is the CLIP text tower's byte-level BPE (the
grounding crop filter's class prompts), read from ``vocab.json`` +
``merges.txt`` or ``tokenizer.json``, as transformers' CLIP tokenizers
give its ids.

:class:`BertTokenizer` is GroundingDINO's BERT WordPiece tokenizer (uncased
or cased), read from ``vocab.txt`` (+ ``tokenizer_config.json``) or a
``tokenizer.json`` with a WordPiece model, as transformers'
BertTokenizerFast gives its ids.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

from video_llava_tpu_torch.constants import (
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
)

VIDEO_SPECIAL_TOKENS = (
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VID_END_TOKEN,
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


# -- the LLaMA tokenizer ------------------------------------------------------

SPIECE_UNDERLINE = "▁"
_BYTE_RE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def _byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


def _read_json(path: str):
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_str(value) -> Optional[str]:
    """A special token in tokenizer_config / special_tokens_map: a string
    or an AddedToken dict."""
    if isinstance(value, dict):
        return value.get("content")
    return value


# -- SentencePiece model protobuf ---------------------------------------------


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """(field number, value) of each field of a protobuf message: an int
    for a varint, bytes for a length-delimited field, the raw 4 or 8
    bytes for fixed32 / fixed64."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        else:
            raise ValueError(f"protobuf wire type {wire} not supported")
        yield field, value


# SentencePiece piece types (sentencepiece_model.proto)
SP_NORMAL, SP_UNKNOWN, SP_CONTROL, SP_USER_DEFINED, SP_UNUSED, SP_BYTE = (
    1, 2, 3, 4, 5, 6)


def read_sentencepiece_model(path: str) -> dict:
    """The parts of a SentencePiece ModelProto the BPE encoder needs:
    pieces [(piece, score, type)], and from the trainer and normalizer
    specs model_type, byte_fallback, unk/bos/eos/pad ids, name,
    add_dummy_prefix, remove_extra_whitespaces and escape_whitespaces
    (with the proto's defaults)."""
    with open(path, "rb") as f:
        buf = f.read()
    out = {"pieces": [], "model_type": 1, "byte_fallback": False,
           "unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": -1,
           "name": "", "add_dummy_prefix": True,
           "remove_extra_whitespaces": True, "escape_whitespaces": True}
    signed = lambda v: v - (1 << 64) if v >= 1 << 63 else v  # noqa: E731
    for field, value in _fields(buf):
        if field == 1:
            piece, score, kind = "", 0.0, SP_NORMAL
            for f, v in _fields(value):
                if f == 1:
                    piece = v.decode("utf-8")
                elif f == 2:
                    (score,) = struct.unpack("<f", v)
                elif f == 3:
                    kind = v
            out["pieces"].append((piece, score, kind))
        elif field == 2:
            names = {3: "model_type", 35: "byte_fallback", 40: "unk_id",
                     41: "bos_id", 42: "eos_id", 43: "pad_id"}
            for f, v in _fields(value):
                if f in names:
                    out[names[f]] = (bool(v) if f == 35 else signed(v))
        elif field == 3:
            names = {3: "add_dummy_prefix", 4: "remove_extra_whitespaces",
                     5: "escape_whitespaces"}
            for f, v in _fields(value):
                if f == 1:
                    out["name"] = v.decode("utf-8")
                elif f in names:
                    out[names[f]] = bool(v)
    return out


# -- tokenizer.json pieces ---------------------------------------------


def _normalize(spec, text: str) -> str:
    """tokenizers' normalizers of the legacy LLaMA layout: Sequence,
    Prepend, Replace (a string pattern)."""
    if spec is None:
        return text
    kind = spec["type"]
    if kind == "Sequence":
        for sub in spec["normalizers"]:
            text = _normalize(sub, text)
        return text
    if kind == "Prepend":
        return spec["prepend"] + text if text else text
    if kind == "Replace":
        return text.replace(spec["pattern"]["String"], spec["content"])
    raise ValueError(f"tokenizer.json normalizer {kind!r} not supported")


def _pre_tokenize(spec, text: str, first: bool) -> List[str]:
    """tokenizers' pre-tokenizers of the LLaMA layouts: none, or Metaspace
    (spaces to the replacement; prepend_scheme always / first (only the
    piece at the text's start) / never; split before each replacement).
    `first`: the piece starts the original text."""
    if spec is None:
        return [text] if text else []
    kind = spec["type"]
    if kind != "Metaspace":
        raise ValueError(f"tokenizer.json pre_tokenizer {kind!r} not "
                         "supported")
    rep = spec.get("replacement", SPIECE_UNDERLINE)
    scheme = spec.get("prepend_scheme",
                      "always" if spec.get("add_prefix_space", True)
                      else "never")
    text = text.replace(" ", rep)
    if text and not text.startswith(rep) and (
            scheme == "always" or (scheme == "first" and first)):
        text = rep + text
    if not spec.get("split", True):
        return [text] if text else []
    pieces, start = [], 0
    for i in range(1, len(text)):
        if text[i] == rep:
            pieces.append(text[start:i])
            start = i
    pieces.append(text[start:])
    return [p for p in pieces if p]


def _decode_chain(spec, tokens: List[str]) -> List[str]:
    """tokenizers' decoders of the LLaMA layouts: Sequence, Replace,
    ByteFallback, Fuse, Strip, Metaspace."""
    if spec is None:
        return tokens
    kind = spec["type"]
    if kind == "Sequence":
        for sub in spec["decoders"]:
            tokens = _decode_chain(sub, tokens)
        return tokens
    if kind == "Replace":
        pat, content = spec["pattern"]["String"], spec["content"]
        return [t.replace(pat, content) for t in tokens]
    if kind == "ByteFallback":
        out, run = [], []

        def flush():
            if run:
                try:
                    out.append(bytes(run).decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in run)
                run.clear()

        for t in tokens:
            m = _BYTE_RE.match(t)
            if m:
                run.append(int(m.group(1), 16))
            else:
                flush()
                out.append(t)
        flush()
        return out
    if kind == "Fuse":
        return ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]
        out = []
        for t in tokens:
            i, j = 0, len(t)
            while i < start and i < j and t[i] == content:
                i += 1
            while len(t) - j < stop and j > i and t[j - 1] == content:
                j -= 1
            out.append(t[i:j])
        return out
    if kind == "Metaspace":
        rep = spec.get("replacement", SPIECE_UNDERLINE)
        scheme = spec.get("prepend_scheme",
                          "always" if spec.get("add_prefix_space", True)
                          else "never")
        return ["".join(("" if i == 0 and scheme != "never" else " ")
                        if c == rep else c for c in t)
                for i, t in enumerate(tokens)]
    raise ValueError(f"tokenizer.json decoder {kind!r} not supported")


# SentencePiece decodes as the legacy LLaMA tokenizer.json decoder does
_SPM_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": SPIECE_UNDERLINE},
     "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}

# transformers' clean_up_tokenization
_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
            (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
            (" 've", "'ve"), (" 're", "'re"))


class LlamaTokenizer(Tokenizer):
    """A LLaMA checkpoint's tokenizer, as the JAX package's HFTokenizer
    (transformers.AutoTokenizer, then add_tokens of <vid_patch>,
    <vid_start> and <vid_end> with special_tokens=True) gives it, with no
    tokenizer library.

    Text is first split at the added tokens (leftmost-longest, on the
    raw text); each other piece is normalized, pre-tokenized and encoded
    by BPE: its characters (a character not in the vocabulary becomes
    its UTF-8 bytes' <0xXX> tokens with byte fallback, else unk), then
    the adjacent pair of best priority merges first, ties to the left:
    the lowest merge rank (tokenizer.json), or the best score of the
    merged piece (tokenizer.model, SentencePiece BPE, where each piece
    takes the dummy prefix as the legacy LLaMA tokenizer gives it).
    add_bos prepends bos (and eos follows with add_eos_token). Decode
    drops special tokens when asked, then runs the decoder (Replace
    "▁", ByteFallback, Fuse, strip one leading space). A token that
    is already in the vocabulary keeps its id when added; a new one
    takes the next id past the vocabulary and the added tokens."""

    def __init__(self, path: str, use_vid_start_end: bool = True):
        cfg = _read_json(os.path.join(path, "tokenizer_config.json")) or {}
        smap = _read_json(os.path.join(path, "special_tokens_map.json")) or {}
        self.vocab: Dict[str, int] = {}
        self.special: set = set()  # ids dropped by skip_special_tokens
        self.added: Dict[str, int] = {}
        self.ranks: Optional[Dict[Tuple[str, str], int]] = None
        self.scores: Optional[Dict[str, float]] = None
        self.normalizer = self.pre_tokenizer = None
        self.legacy_prefix = False  # SentencePiece's dummy prefix
        fast = os.path.join(path, "tokenizer.json")
        slow = os.path.join(path, "tokenizer.model")
        if os.path.exists(fast):
            self._read_fast(fast)
        elif os.path.exists(slow):
            self._read_sentencepiece(slow)
        else:
            raise FileNotFoundError(f"no tokenizer.json or tokenizer.model "
                                    f"under {path}")
        names = {}
        defaults = {"bos_token": "<s>", "eos_token": "</s>",
                    "unk_token": "<unk>", "pad_token": None}
        for key, default in defaults.items():
            names[key] = _token_str(smap.get(key, cfg.get(key, default)))
        extra = (smap.get("additional_special_tokens")
                 or cfg.get("additional_special_tokens") or [])
        added_json = _read_json(os.path.join(path, "added_tokens.json")) or {}
        for tok, idx in sorted(added_json.items(), key=lambda kv: kv[1]):
            self._add(tok, special=tok in {_token_str(t) for t in extra},
                      idx=idx)
        for tok in [names[k] for k in names if names[k]] + [
                _token_str(t) for t in extra]:
            self._add(tok, special=True)
        self._add(DEFAULT_VIDEO_PATCH_TOKEN, special=True)
        if use_vid_start_end:
            self._add(DEFAULT_VID_START_TOKEN, special=True)
            self._add(DEFAULT_VID_END_TOKEN, special=True)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._split_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
        ids = [self.token_to_id(t) for t in VIDEO_SPECIAL_TOKENS]
        self.vid_patch_token_id, self.vid_start_token_id, \
            self.vid_end_token_id = ids
        self.bos_token_id = self.token_to_id(names["bos_token"])
        self.eos_token_id = self.token_to_id(names["eos_token"])
        self.unk_token_id = self.token_to_id(names["unk_token"])
        pad = self.token_to_id(names["pad_token"])
        self.pad_token_id = (pad if pad is not None
                             else self.unk_token_id or 0)
        self.add_bos = cfg.get("add_bos_token", True)
        self.add_eos = cfg.get("add_eos_token", False)
        self.clean_up = cfg.get("clean_up_tokenization_spaces", False)

    # -- reading --

    def _read_fast(self, path: str) -> None:
        spec = _read_json(path)
        model = spec["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"{path}: model {model.get('type')!r}, only "
                             "BPE is supported")
        self.vocab = dict(model["vocab"])
        merges = [m.split(" ", 1) if isinstance(m, str) else m
                  for m in model["merges"]]
        self.ranks = {(a, b): i for i, (a, b) in enumerate(merges)}
        self.byte_fallback = model.get("byte_fallback", False)
        self.fuse_unk = model.get("fuse_unk", False)
        self.ignore_merges = model.get("ignore_merges", False)
        self.unk_piece = model.get("unk_token")
        self.normalizer = spec.get("normalizer")
        self.pre_tokenizer = spec.get("pre_tokenizer")
        self.decoder = spec.get("decoder")
        for tok in sorted(spec.get("added_tokens", []),
                          key=lambda t: t["id"]):
            self._add(tok["content"], special=tok.get("special", False),
                      idx=tok["id"])

    def _read_sentencepiece(self, path: str) -> None:
        sp = read_sentencepiece_model(path)
        if sp["model_type"] != 2:
            raise ValueError(f"{path}: SentencePiece model type "
                             f"{sp['model_type']}, only BPE (2) is supported")
        if sp["name"] not in ("", "identity"):
            raise ValueError(f"{path}: normalizer {sp['name']!r}, only "
                             "'identity' (LLaMA's) is supported")
        self.vocab = {p: i for i, (p, _, _) in enumerate(sp["pieces"])}
        self.scores = {p: s for p, s, kind in sp["pieces"]
                       if kind in (SP_NORMAL, SP_USER_DEFINED)}
        self.byte_fallback = sp["byte_fallback"]
        self.fuse_unk = True
        self.ignore_merges = False
        unk = sp["unk_id"]
        self.unk_piece = sp["pieces"][unk][0] if unk >= 0 else None
        self.sp = sp
        self.legacy_prefix = True
        self.decoder = _SPM_DECODER
        for i, (piece, _, kind) in enumerate(sp["pieces"]):
            if kind in (SP_CONTROL, SP_UNKNOWN, SP_USER_DEFINED):
                self._add(piece, special=kind != SP_USER_DEFINED, idx=i)

    def _add(self, token: str, special: bool,
             idx: Optional[int] = None) -> None:
        """Add `token` as an added token (split out of the text before
        BPE): an existing token keeps its id, a new one takes `idx` or the
        next id past the vocabulary and the added tokens."""
        have = self.token_to_id(token)
        if have is None:
            have = idx if idx is not None else max(
                [len(self.vocab)] + [i + 1 for i in self.added.values()])
        self.added[token] = have
        if special:
            self.special.add(have)

    def token_to_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    @property
    def vocab_size(self) -> int:
        return len(set(self.vocab) | set(self.added))

    # -- encoding --

    def _priority(self, a: str, b: str):
        if self.ranks is not None:
            return self.ranks.get((a, b))
        score = self.scores.get(a + b)
        return None if score is None else -score

    def _bpe(self, word: str) -> List[int]:
        """BPE of one pre-tokenized piece -> ids."""
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: List[str] = []
        flags: List[bool] = []  # a symbol that never merges (bytes, unk)
        for ch in word:
            if ch in self.vocab or self.scores is not None:
                syms.append(ch)
                flags.append(False)
                continue
            bts = [_byte_token(b) for b in ch.encode("utf-8")]
            if self.byte_fallback and all(t in self.vocab for t in bts):
                syms.extend(bts)
                flags.extend(True for _ in bts)
            else:
                syms.append(ch)
                flags.append(True)
        n = len(syms)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []

        def push(i):
            j = nxt[i]
            if j < 0 or flags[i] or flags[j]:
                return
            p = self._priority(syms[i], syms[j])
            if p is not None:
                heapq.heappush(heap, (p, i, syms[i], syms[j]))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, a, b = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j < 0 or syms[i] != a or syms[j] != b:
                continue
            syms[i] = a + b
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                push(prv[i])
            push(i)
        out: List[int] = []
        unk_id = self.vocab.get(self.unk_piece) if self.unk_piece else None
        i = 0 if n else -1
        while i >= 0:
            sym = syms[i]
            if sym in self.vocab:
                out.append(self.vocab[sym])
            else:
                bts = [_byte_token(b) for b in sym.encode("utf-8")]
                if self.byte_fallback and all(t in self.vocab for t in bts):
                    out.extend(self.vocab[t] for t in bts)
                elif unk_id is not None and not (
                        self.fuse_unk and out and out[-1] == unk_id):
                    out.append(unk_id)
            i = nxt[i]
        return out

    def _pieces(self, text: str, first: bool) -> List[str]:
        """A text segment between added tokens -> the pieces BPE takes."""
        if self.legacy_prefix:  # SentencePiece normalization
            sp = self.sp
            if sp["remove_extra_whitespaces"]:
                text = " ".join(text.split())
            if not text:
                return []
            if sp["add_dummy_prefix"]:
                text = " " + text
            if sp["escape_whitespaces"]:
                text = text.replace(" ", SPIECE_UNDERLINE)
            return [text]
        return _pre_tokenize(self.pre_tokenizer,
                             _normalize(self.normalizer, text), first)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in [*self._split_re.finditer(text), None]:
            end = m.start() if m else len(text)
            if end > pos:
                for piece in self._pieces(text[pos:end], pos == 0):
                    ids.extend(self._bpe(piece))
            if m:
                ids.append(self.added[m.group(0)])
                pos = m.end()
        if add_bos and self.add_bos and self.bos_token_id is not None:
            ids.insert(0, self.bos_token_id)
        if add_bos and self.add_eos and self.eos_token_id is not None:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        tokens = [self.id_to_token[i] for i in map(int, ids)
                  if i in self.id_to_token
                  and not (skip_special_tokens and i in self.special)]
        text = "".join(_decode_chain(self.decoder, tokens))
        if self.clean_up:
            for a, b in _CLEANUP:
                text = text.replace(a, b)
        return text


# -- CLIP --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map of byte-level BPE: the
    printable Latin-1 bytes map to themselves, the others to 256 + n."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clip_clean_text(text: str) -> str:
    """transformers' CLIP text clean-up without ftfy (its BasicTokenizer
    with no accent stripping and no punctuation split): control
    characters, NUL and U+FFFD dropped, whitespace to spaces, CJK
    characters spaced apart, NFC, lower case, runs of whitespace to one
    space, stripped."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch)[0] == "C":
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(w.lower() for w in text.split())


_CLIP_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CLIP_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def clip_pre_tokenize(text: str) -> List[str]:
    """CLIP's pre-tokenizer regex, <\\|startoftext\\|>|<\\|endoftext\\|>|
    's|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+ (case
    blind), as a scanner over Unicode categories (no regex package): at
    each position the first alternative that matches, whitespace between
    matches skipped."""
    def letter(c):
        return unicodedata.category(c)[0] == "L"

    def number(c):
        return unicodedata.category(c)[0] == "N"

    pieces, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        low = text[i:i + 15].lower()
        special = next((t for t in _CLIP_SPECIALS if low.startswith(t)),
                       None)
        if special is not None:
            pieces.append(text[i:i + len(special)])
            i += len(special)
            continue
        low = text[i:i + 3].lower()
        short = next((t for t in _CLIP_CONTRACTIONS if low.startswith(t)),
                     None)
        if short is not None:
            pieces.append(text[i:i + len(short)])
            i += len(short)
        elif letter(c):
            j = i + 1
            while j < n and letter(text[j]):
                j += 1
            pieces.append(text[i:j])
            i = j
        elif number(c):
            pieces.append(c)
            i += 1
        elif c.isspace():
            i += 1
        else:
            j = i + 1
            while j < n and not (text[j].isspace() or letter(text[j])
                                 or number(text[j])):
                j += 1
            pieces.append(text[i:j])
            i = j
    return pieces


class CLIPTokenizer:
    """The CLIP text tokenizer of a checkpoint directory, as
    transformers.AutoTokenizer gives it (the JAX package's
    build_clip_filter), with no tokenizer library: the text cleaned
    (clip_clean_text), split by CLIP's pre-tokenizer, each piece's UTF-8
    bytes mapped to byte-level characters, then BPE with the "</w>"
    end-of-word suffix on the last character (the lowest-ranked adjacent
    pair merges first, every occurrence left to right), and
    <|startoftext|> ... <|endoftext|> around the ids. A symbol outside
    the vocabulary takes the unk id (<|endoftext|>). Reads vocab.json +
    merges.txt (at most 49,152 - 258 merges after the version line, as
    transformers reads them) or, without them, tokenizer.json's BPE
    model and added tokens."""

    bos_token = "<|startoftext|>"
    eos_token = "<|endoftext|>"

    def __init__(self, path: str):
        vocab_file = os.path.join(path, "vocab.json")
        merges_file = os.path.join(path, "merges.txt")
        fast = os.path.join(path, "tokenizer.json")
        if os.path.exists(vocab_file) and os.path.exists(merges_file):
            self.vocab: Dict[str, int] = _read_json(vocab_file)
            with open(merges_file, encoding="utf-8") as f:
                lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in lines]
        elif os.path.exists(fast):
            spec = _read_json(fast)
            model = spec["model"]
            if model.get("type") != "BPE":
                raise ValueError(f"{fast}: model {model.get('type')!r}, "
                                 "only BPE is supported")
            self.vocab = dict(model["vocab"])
            merges = [tuple(m.split(" ", 1)) if isinstance(m, str)
                      else tuple(m) for m in model["merges"]]
            for tok in spec.get("added_tokens", []):
                self.vocab.setdefault(tok["content"], tok["id"])
        else:
            raise FileNotFoundError(f"no vocab.json + merges.txt or "
                                    f"tokenizer.json under {path}")
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token_id = self.vocab[self.bos_token]
        self.eos_token_id = self.vocab[self.eos_token]
        self.unk_token_id = self.eos_token_id
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, piece: str) -> List[str]:
        if piece in self._cache:
            return self._cache[piece]
        word = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == best[0]
                        and word[i + 1] == best[1]):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[piece] = word
        return word

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = []
        for piece in clip_pre_tokenize(clip_clean_text(text)):
            if piece in _CLIP_SPECIALS:
                ids.append(self.vocab[piece])
                continue
            chars = "".join(self.byte_encoder[b]
                            for b in piece.encode("utf-8"))
            ids.extend(self.vocab.get(t, self.unk_token_id)
                       for t in self._bpe(chars))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids



# -- BERT WordPiece -----------------------------------------------------------

BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def bert_clean_text(text: str, chinese_chars: bool = True) -> str:
    """BertNormalizer's clean-up: NUL, U+FFFD and other control
    characters (category C*, not tab, newline or return) dropped,
    whitespace to spaces, and (chinese_chars) every CJK character spaced
    apart."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (unicodedata.category(ch)[0] == "C"
                                        and ch not in "\t\n\r"):
            continue
        if ch.isspace():
            out.append(" ")
        elif chinese_chars and _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return "".join(out)


def _is_bert_punct(ch: str) -> bool:
    cp = ord(ch)
    return (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126 or unicodedata.category(ch)[0] == "P")


def bert_pre_tokenize(text: str) -> List[str]:
    """BertPreTokenizer: split on whitespace (dropped) and around every
    punctuation character (each its own piece)."""
    pieces, word = [], []
    for ch in text:
        if ch.isspace():
            if word:
                pieces.append("".join(word))
                word = []
        elif _is_bert_punct(ch):
            if word:
                pieces.append("".join(word))
                word = []
            pieces.append(ch)
        else:
            word.append(ch)
    if word:
        pieces.append("".join(word))
    return pieces


class BertTokenizer:
    """BERT's WordPiece tokenizer, as transformers.BertTokenizerFast gives
    its ids, with no tokenizer library: special tokens in the text kept
    whole; the rest cleaned (bert_clean_text); when uncased, accents
    stripped (NFD, marks of category Mn dropped) and lower-cased; split
    on whitespace and punctuation; each word greedily into the longest
    vocabulary pieces from its start, "##" before every piece after the
    first, the whole word [UNK] when a piece is missing or the word is
    longer than 100 characters; [CLS] ... [SEP] around the ids.

    Reads a directory's ``tokenizer.json`` (a WordPiece model and its
    BertNormalizer's settings) or ``vocab.txt`` (one token a line, the
    line number its id) with ``tokenizer_config.json``'s do_lower_case,
    strip_accents and tokenize_chinese_chars (transformers' defaults:
    True, None = as do_lower_case, True)."""

    def __init__(self, path: str):
        fast = os.path.join(path, "tokenizer.json")
        vocab_file = os.path.join(path, "vocab.txt")
        config = _read_json(os.path.join(path, "tokenizer_config.json")) or {}
        lower = config.get("do_lower_case", True)
        strip = config.get("strip_accents")
        chinese = config.get("tokenize_chinese_chars", True)
        self.max_chars = 100
        self.prefix = "##"
        self.unk_token = "[UNK]"
        if os.path.exists(fast):
            spec = _read_json(fast)
            model = spec["model"]
            if model.get("type") != "WordPiece":
                raise ValueError(f"{fast}: model {model.get('type')!r}, "
                                 "only WordPiece is supported")
            self.vocab: Dict[str, int] = dict(model["vocab"])
            self.unk_token = model.get("unk_token", self.unk_token)
            self.prefix = model.get("continuing_subword_prefix", self.prefix)
            self.max_chars = model.get("max_input_chars_per_word",
                                       self.max_chars)
            norm = spec.get("normalizer") or {}
            if norm.get("type") == "BertNormalizer":
                lower = norm.get("lowercase", lower)
                strip = norm.get("strip_accents", strip)
                chinese = norm.get("handle_chinese_chars", chinese)
            for tok in spec.get("added_tokens", []):
                self.vocab.setdefault(tok["content"], tok["id"])
        elif os.path.exists(vocab_file):
            with open(vocab_file, encoding="utf-8") as f:
                tokens = [line.rstrip("\n") for line in f]
            # a token listed twice takes its last line, as transformers'
            # load_vocab does
            self.vocab = {tok: i for i, tok in enumerate(tokens)}
        else:
            raise FileNotFoundError(f"no tokenizer.json or vocab.txt under "
                                    f"{path}")
        self.lowercase = bool(lower)
        self.strip_accents = self.lowercase if strip is None else bool(strip)
        self.chinese_chars = bool(chinese)
        self.specials = [t for t in BERT_SPECIALS if t in self.vocab]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.unk_token_id = self.vocab[self.unk_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def normalize(self, text: str) -> str:
        text = bert_clean_text(text, self.chinese_chars)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        return text.lower() if self.lowercase else text

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_token_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end]
                if start:
                    piece = self.prefix + piece
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:
                return [self.unk_token_id]
            start = end
        return ids

    def _split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """text -> [(part, is_special)], the special tokens cut out whole
        (leftmost, longest first)."""
        parts, i, last = [], 0, 0
        while i < len(text):
            hit = next((t for t in self.specials if text.startswith(t, i)),
                       None)
            if hit is None:
                i += 1
                continue
            if i > last:
                parts.append((text[last:i], False))
            parts.append((hit, True))
            i = last = i + len(hit)
        if last < len(text):
            parts.append((text[last:], False))
        return parts

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = []
        for part, special in self._split_specials(text):
            if special:
                ids.append(self.vocab[part])
                continue
            for word in bert_pre_tokenize(self.normalize(part)):
                ids.extend(self._wordpiece(word))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    __call__ = encode


def load_tokenizer(path: Optional[str] = None) -> Tokenizer:
    """A checkpoint directory's LLaMA tokenizer (:class:`LlamaTokenizer`),
    else the byte tokenizer."""
    if path and os.path.isdir(path):
        return LlamaTokenizer(path)
    return ByteTokenizer()
