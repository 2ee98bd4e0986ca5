"""Port: random quantized init (runtime/model_init.py) and the chat
CLI's --quant (runtime/chat.py)."""

import numpy as np
import torch

from video_llava_tpu_torch.models.layers import Int4Kernel, Int8Kernel
from video_llava_tpu_torch.ops import quant4
from video_llava_tpu_torch.runtime import chat
from video_llava_tpu_torch.runtime.chat import VideoChatGPTInterface
from video_llava_tpu_torch.runtime.model_init import initialize_model


def test_quantized_init_and_chat_quant_flag(monkeypatch):
    """initialize_model(llm_quant="int4", llm_fuse=True) on the tiny
    config: the JAX package's layout (int4 fused wqkv; gate/up of width
    688 fall back to int8 and fuse as int8), weights drawn per layer and
    quantized -- the same seed gives the same bytes, the dequantized
    wqkv has the init's N(0, 1/256) spread and its output channels
    differ -- and a chat turn answers on the CPU plain path. The CLI
    resolves --quant as the JAX package does (auto -> int8 for random
    weights) and fuses whenever it quantizes."""
    engines = [initialize_model(model_size="tiny", device="cpu", seed=0,
                                dtype=torch.float32, llm_quant="int4",
                                llm_fuse=True) for _ in range(2)]
    llm = engines[0].model.llm
    layer = llm.layers[1]
    assert isinstance(layer.wqkv.kernel, Int4Kernel)
    assert isinstance(layer.gate_up.kernel, Int8Kernel)
    assert isinstance(llm.lm_head.kernel, Int8Kernel)
    assert isinstance(llm.embed_tokens.weight, Int8Kernel)
    for a, b in zip(engines[0].model.state_dict().values(),
                    engines[1].model.state_dict().values()):
        assert torch.equal(a, b)
    w = quant4.dequantize_int4(layer.wqkv.kernel.qvalues_packed,
                               layer.wqkv.kernel.scales, torch.float32)
    assert abs(w.std().item() * 16 - 1) < 0.1
    assert w.std(dim=0).min() > 0 and not torch.equal(w[:, 0], w[:, 1])

    iface = VideoChatGPTInterface(engines[0], temperature=0.0,
                                  max_output_tokens=4)
    iface.upload_frames(np.random.default_rng(0).integers(
        0, 256, size=(4, 64, 64, 3), dtype=np.uint8))
    iface.add_text("What is happening?", None)
    assert isinstance(iface.answer(), str)

    seen = []
    monkeypatch.setattr(chat, "initialize_model",
                        lambda *a, **kw: seen.append(kw) or engines[0])
    monkeypatch.setattr(VideoChatGPTInterface, "interact", lambda self: None)
    for flag, want in (("int4", "int4"), ("auto", "int8"), (None, None)):
        chat.main(["--model_size", "tiny"]
                  + (["--quant", flag] if flag else []))
        assert seen[-1]["llm_quant"] == want
        assert seen[-1]["llm_fuse"] == bool(want)
