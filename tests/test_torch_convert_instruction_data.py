"""Port parity: scripts/convert_instruction_data writes the JAX
package's JSON, with and without the feature-directory filter."""

import json

from video_llava_tpu.scripts import convert_instruction_data as jconv
from video_llava_tpu_torch.scripts import convert_instruction_data as tconv


def test_convert_instruction_data_same_json(tmp_path, capsys):
    entries = [{"video_id": f"v_{i:03d}", "q": f"What happens {i}?",
                "a": f"Answer {i}."} for i in range(7)]
    src = tmp_path / "in.json"
    src.write_text(json.dumps(entries))
    feats = tmp_path / "feats"
    feats.mkdir()
    for i in (0, 1, 4, 6):
        (feats / f"v_{i:03d}.pkl").write_bytes(b"")
    for extra in ([], ["--clip_feature_path", str(feats)]):
        outs = []
        for mod, name in ((jconv, "jax.json"), (tconv, "port.json")):
            mod.main(["--input_json_file", str(src), "--output_json_file",
                      str(tmp_path / name), *extra])
            outs.append((tmp_path / name).read_bytes())
        assert outs[0] == outs[1]
        got = json.loads(outs[1])
        assert len(got) == (4 if extra else 7)
        # alternating <video> placement by the entry's index
        assert got[0]["conversations"][0]["value"].endswith("\n<video>")
        assert got[1]["conversations"][0]["value"].startswith("<video>\n")
    printed = capsys.readouterr().out.splitlines()
    assert printed == ["Total annotations retained: 7"] * 2 + [
        "Total annotations retained: 4"] * 2
