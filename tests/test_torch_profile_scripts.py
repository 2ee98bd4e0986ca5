"""The three profilers' mains on the CPU at tiny sizes: profile_xmem
(full-width XMem at 32 x 48, 2 frames, a trace read back through
utils/trace_tools' fallback), profile_gdino (GroundingDINO's tiny config
at 64 px, batch 2, every stage prefix; the deformable dispatch restored
after --impl) and profile_decode (BENCH_MODEL=tiny, int4 W4A8 as bench
builds it, a 4-frame clip and a 160-token prompt, 4 profiled steps),
each printing its JSON keys as the JAX scripts do."""

import json

from torch_xmem_pair import one_torch_thread
from video_llava_tpu_torch.ops import deformable
from video_llava_tpu_torch.scripts import (
    profile_decode,
    profile_gdino,
    profile_xmem,
)


def _json_lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


@one_torch_thread()
def test_profilers_print_their_json(tmp_path, capsys, monkeypatch):
    lines = []
    out = profile_xmem.main(["--device", "cpu", "--height", "32", "--width",
                             "48", "--frames", "2", "--objects", "2",
                             "--trace_dir", str(tmp_path / "xmem")],
                            print_fn=lines.append)
    first = json.loads(lines[0])
    for k in ("frames", "size", "objects", "key_encode_chunk_ms",
              "propagate_chunk_ms", "per_frame_ms"):
        assert k in first, k
    assert first["size"] == "32x48" and out["trace_source"] == "all"
    assert 1 < len(lines) <= 26 and " ms  x" in lines[1]

    out = profile_gdino.main(["--device", "cpu", "--cfg", "tiny",
                              "--batch", "2", "--iters", "1", "--impl",
                              "pallas_full"])
    assert deformable._DEFAULT_IMPL == "auto" and not deformable._TILE2D
    printed = _json_lines(capsys.readouterr().out)
    assert printed[-1] == out and len(printed) == 6
    for st in ("text", "backbone", "encoder", "two_stage", "full"):
        assert f"cum_{st}_ms" in out and f"delta_{st}_ms" in out
    assert out["batch"] == 2 and "per_frame_ms" in out

    monkeypatch.setenv("BENCH_MODEL", "tiny")
    monkeypatch.delenv("BENCH_LLM_DTYPE", raising=False)
    monkeypatch.delenv("BENCH_KV_DTYPE", raising=False)
    out = profile_decode.main(["--device", "cpu", "--steps", "4",
                               "--frames", "4", "--prompt_len", "160",
                               "--top", "5", "--trace_dir",
                               str(tmp_path / "decode")])
    printed = capsys.readouterr().out
    first = _json_lines(printed)[0]
    assert first == {"decode_step_ms": first["decode_step_ms"],
                     "model": "tiny", "llm_dtype": "int4", "kv": "bf16"}
    for k in ("profiled_step_ms", "busy_step_ms", "idle_share", "trace"):
        assert k in out, k
    assert "distinct ops" in printed and out["profiled_steps"] == 4
    assert profile_decode.bench_settings({"BENCH_LLM_DTYPE": "int8"}) == {
        "model": "7b", "llm_dtype": "int8", "kv": "int8", "fuse": True}
