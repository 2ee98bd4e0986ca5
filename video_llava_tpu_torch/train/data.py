"""Supervised training data: conversations and precomputed video
features into padded batches.

The port's own copy of video_llava_tpu/train/data.py (which imports
nothing of JAX at its top): ``preprocess_multimodal`` replaces <video>
with the patch-token block, ``preprocess_v1`` / ``preprocess_default``
template the conversation and mask the labels with IGNORE_INDEX (with
the tokenization-mismatch guard), ``LazySupervisedDataset`` reads
per-sample features (.pkl, .npy, .npz), ``Collator`` pads to a bucket of
128 capped at max_len. ``sharded_data_iterator`` is the multi-rank
iterator: each rank loads its 'data' shard of every global batch
(``host_shard_rows``) and moves it to its device.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from video_llava_tpu_torch.constants import (
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
)
from video_llava_tpu_torch.runtime import conversation as conversation_lib
from video_llava_tpu_torch.runtime.conversation import SeparatorStyle
from video_llava_tpu_torch.runtime.tokenizer import Tokenizer


@dataclass
class MultimodalCfg:
    video_token_len: int
    is_multimodal: bool = True
    sep_video_conv_front: bool = False
    video_folder: Optional[str] = None
    use_vid_start_end: bool = True


def preprocess_multimodal(
    sources: Sequence[List[Dict]], cfg: MultimodalCfg
) -> Sequence[List[Dict]]:
    """Replace <video> in the conversation turns with the patch-token
    block, optionally moving the video to the front of the first turn."""
    if not cfg.is_multimodal:
        return sources
    conv = conversation_lib.default_conversation
    for source in sources:
        if cfg.sep_video_conv_front:
            assert DEFAULT_VIDEO_TOKEN in source[0]["value"]
            source[0]["value"] = (
                source[0]["value"].replace(DEFAULT_VIDEO_TOKEN, "").strip())
            source[0]["value"] = (DEFAULT_VIDEO_TOKEN + conv.sep
                                  + conv.roles[0] + ": "
                                  + source[0]["value"])
        replace_token = DEFAULT_VIDEO_PATCH_TOKEN * cfg.video_token_len
        if cfg.use_vid_start_end:
            replace_token = (DEFAULT_VID_START_TOKEN + replace_token
                             + DEFAULT_VID_END_TOKEN)
        for sentence in source:
            sentence["value"] = sentence["value"].replace(
                DEFAULT_VIDEO_TOKEN, replace_token)
    return sources


def _truncate(ids: List[int], max_len: int) -> List[int]:
    return ids[:max_len]


def preprocess_v1(sources, tokenizer: Tokenizer,
                  max_len: int = 2048) -> Dict[str, List[np.ndarray]]:
    """Vicuna-v1 (TWO separator style): template, tokenize, and mask
    every instruction so that only the answers are targets."""
    conv = conversation_lib.default_conversation.copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations = []
    for source in sources:
        if roles.get(source[0]["from"]) != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    assert conv.sep_style == SeparatorStyle.TWO
    input_ids = [np.asarray(_truncate(tokenizer.encode(c), max_len), np.int32)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]

    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tokenizer.encode(rou))
            instruction_len = len(tokenizer.encode(parts[0])) - 2
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < max_len and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. "
                  f"{total_len}. (ignored)")
    return {"input_ids": input_ids, "labels": targets}


def _add_speaker_and_signal(header: str, source,
                            get_conversation: bool = True) -> str:
    begin_signal, end_signal = "### ", "\n"
    conversation = header
    for sentence in source:
        from_str = sentence["from"]
        if from_str.lower() == "human":
            from_str = conversation_lib.default_conversation.roles[0]
        elif from_str.lower() == "gpt":
            from_str = conversation_lib.default_conversation.roles[1]
        else:
            from_str = "unknown"
        sentence["value"] = (begin_signal + from_str + ": "
                             + sentence["value"] + end_signal)
        if get_conversation:
            conversation += sentence["value"]
    conversation += begin_signal
    return conversation


def preprocess_default(sources, tokenizer: Tokenizer,
                       max_len: int = 2048) -> Dict[str, List[np.ndarray]]:
    """SINGLE separator style: mask the header and every human turn
    (after the 2 tokens of its speaker signal)."""
    conversations, headers = [], []
    for source in sources:
        header = f"{conversation_lib.default_conversation.system}\n\n"
        headers.append(header)
        conversations.append(_add_speaker_and_signal(header, source))
    input_ids = [np.asarray(_truncate(tokenizer.encode(c), max_len), np.int32)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]
    for target, source, header in zip(targets, sources, headers):
        lens = [len(tokenizer.encode(header))] + [
            len(tokenizer.encode(s["value"])) for s in source]
        speakers = [s["from"] for s in source]
        cur_idx = lens[0]
        target[:cur_idx] = IGNORE_INDEX
        for ln, speaker in zip(lens[1:], speakers):
            if speaker == "human":
                target[cur_idx + 2:cur_idx + ln] = IGNORE_INDEX
            cur_idx += ln
    return {"input_ids": input_ids, "labels": targets}


def preprocess(sources, tokenizer: Tokenizer, max_len: int = 2048):
    if conversation_lib.default_conversation.version == "v1":
        return preprocess_v1(sources, tokenizer, max_len)
    return preprocess_default(sources, tokenizer, max_len)


def load_video_features(path: str) -> np.ndarray:
    """Pickled or numpy (.npy, or .npz under 'features') features."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        return np.load(path)["features"]
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f))


class LazySupervisedDataset:
    """JSON instruction data + per-sample precomputed video features,
    read and tokenized when a sample is taken."""

    def __init__(self, data_path: str, tokenizer: Tokenizer,
                 multimodal_cfg: MultimodalCfg, max_len: int = 2048):
        with open(data_path) as f:
            self.list_data_dict = json.load(f)
        self.tokenizer = tokenizer
        self.multimodal_cfg = multimodal_cfg
        self.max_len = max_len

    def __len__(self):
        return len(self.list_data_dict)

    def __getitem__(self, i: int) -> Dict:
        entry = self.list_data_dict[i]
        features = None
        if "video" in entry:
            video_file = entry["video"]
            folder = self.multimodal_cfg.video_folder or "."
            base = os.path.join(folder, video_file)
            for candidate in (base, base + ".pkl", base + ".npy"):
                if os.path.exists(candidate):
                    features = load_video_features(candidate)
                    break
            if features is None:
                raise FileNotFoundError(f"features for {video_file} not found")
            sources = preprocess_multimodal(
                copy.deepcopy([entry["conversations"]]), self.multimodal_cfg)
        else:
            sources = copy.deepcopy([entry["conversations"]])
        data = preprocess(sources, self.tokenizer, self.max_len)
        out = {"input_ids": data["input_ids"][0], "labels": data["labels"][0]}
        if features is not None:
            out["video_features"] = features.astype(np.float32)
        return out


@dataclass
class Collator:
    """Pad to a bucket length (a multiple of `pad_multiple`, capped at
    max_len), so a run meets a handful of shapes."""

    pad_token_id: int
    pad_multiple: int = 128
    max_len: int = 2048

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        longest = max(len(x["input_ids"]) for x in instances)
        bucket = min(-(-longest // self.pad_multiple) * self.pad_multiple,
                     self.max_len)
        b = len(instances)
        input_ids = np.full((b, bucket), self.pad_token_id, np.int32)
        labels = np.full((b, bucket), IGNORE_INDEX, np.int32)
        for r, inst in enumerate(instances):
            n = min(len(inst["input_ids"]), bucket)
            input_ids[r, :n] = inst["input_ids"][:n]
            labels[r, :n] = inst["labels"][:n]
        batch = {"input_ids": input_ids, "labels": labels}
        if "video_features" in instances[0]:
            batch["video_features"] = np.stack(
                [inst["video_features"] for inst in instances]
            ).astype(np.float32)
        return batch


def data_iterator(dataset, collator, batch_size: int,
                  rng: np.random.Generator, drop_last: bool = True,
                  shuffle: bool = True):
    """One epoch of collated numpy batches, rows in the order rng
    shuffles them."""
    idx = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(idx)
    for start in range(0, len(idx) - (batch_size - 1 if drop_last else 0),
                       batch_size):
        rows = idx[start:start + batch_size]
        yield collator([dataset[int(r)] for r in rows])


def host_shard_rows(global_rows: np.ndarray, process_index: int,
                    process_count: int) -> np.ndarray:
    """Contiguous slice `process_index` of `process_count` of a global
    batch's row indices (JAX train/data.py:296-307). Every rank derives
    the same shuffled index stream (an identically seeded rng), so the
    slices partition each global batch with no communication."""
    per_host = len(global_rows) // process_count
    if per_host * process_count != len(global_rows):
        raise ValueError(f"global batch {len(global_rows)} not divisible "
                         f"by {process_count} hosts")
    return global_rows[process_index * per_host:
                       (process_index + 1) * per_host]


def sharded_data_iterator(dataset, collator, global_batch_size: int,
                          rng: np.random.Generator, device, *, mesh=None,
                          drop_last: bool = True, shuffle: bool = True):
    """One epoch of global batches, each rank loading only its shard of
    every one (JAX train/data.py:310-357), moved to `device` as tensors
    (int32 ids and labels, f32 features). The shards are the 'data'
    coordinates of `mesh` (one shard without one): the rank at data
    coordinate d of D loads slice d of each global batch's rows
    (:func:`host_shard_rows`), and the 'model' ranks of one data row load
    the same rows. With drop_last=False the last partial batch is
    wrap-padded with the epoch's first indices to a multiple of D, as
    the JAX iterator pads to its process count."""
    pid, nproc = ((mesh.coords["data"], mesh.shape["data"])
                  if mesh is not None else (0, 1))
    idx = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(idx)
    for start in range(0, len(idx) - (global_batch_size - 1
                                      if drop_last else 0),
                       global_batch_size):
        rows = idx[start:start + global_batch_size]
        if len(rows) % nproc:
            rows = np.concatenate([rows, idx[:-len(rows) % nproc]])
        rows = host_shard_rows(rows, pid, nproc)
        local = collator([dataset[int(r)] for r in rows])
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in local.items()}
