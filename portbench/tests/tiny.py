"""A tiny configuration and mix of the batched-QA cell, for CPU tests:
every width small, every format of the 7B path kept (int4 W4A8
decoder linears, int8 embeddings and head, grouped-query attention)."""

import copy

CFG = {
    "name": "tiny", "source": "tests", "model_type": "mistral",
    "hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
    "vocab_size": 1000, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5, "rope_theta": 1e6, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "pad_token_id": 0, "vocab_size_served": 1006,
    "vid_patch_token_id": 1000, "vid_start_token_id": 1001,
    "vid_end_token_id": 1002, "mm_projector_type": "linear",
    "mm_hidden_size": 64, "mm_vision_select_layer": -2,
    "max_temporal_tokens": 4,
    "vision_config": {
        "image_size": 28, "patch_size": 14, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 3,
        "num_attention_heads": 4, "layer_norm_eps": 1e-5,
        "hidden_act": "quick_gelu", "projection_dim": 32},
    "assumed": {}, "reduced": [],
}

MIX = {
    "kind": "batched_qa", "llm_weights": "int4", "batch": 4, "clips": 4,
    "frames": 4, "frame_size": 28, "template_tokens": [5, 2],
    "question_tokens": [3, 9], "transcript_tokens": [0, 0],
    "answer_tokens": [2, 5],
    "check": {"requests": 6, "widest_gap_limit": 0.3},
}


def cfg():
    return copy.deepcopy(CFG)


def mix(**over):
    m = copy.deepcopy(MIX)
    m.update(over)
    return m

TRAIN = {
    "kind": "train_projector", "llm_weights": "bf16",
    "tune_mode": "projector+embed", "rows": 4, "template_tokens": [5, 2],
    "question_tokens": [3, 9], "conversation_tokens": [12, 40],
    "learning_rate": 0.002, "weight_decay": 0.0, "warmup_steps": 0,
    "total_steps": 9375, "control": {"llm_weights": "int8"},
    "check": {"loss_rel": 1.0, "grad_norm_gap": 1.0, "grad_rel_err": 1.0,
              "change_norm_gap": 1.0},
}


def train(**over):
    m = copy.deepcopy(TRAIN)
    m.update(over)
    return m
