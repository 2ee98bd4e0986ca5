"""The port's configurations and constants are the JAX package's: the
same fields, defaults, named configurations, derived sizes and token
strings, so one name means one model in both packages."""

import dataclasses

import video_llava_tpu.config as jcfg
import video_llava_tpu.constants as jconst
import video_llava_tpu_torch.config as tcfg
import video_llava_tpu_torch.constants as tconst

CLASSES = ("CLIPVisionConfig", "CLIPTextConfig", "LlamaConfig",
           "ProjectorConfig", "VideoLLaVAConfig", "GenerationConfig")


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_configs_and_constants_match_jax():
    for name in CLASSES:
        jc, tc = getattr(jcfg, name), getattr(tcfg, name)
        assert _fields(tc) == _fields(jc), name
        assert dataclasses.asdict(tc()) == dataclasses.asdict(jc()), name
    for name in ("CLIPVisionConfig", "CLIPTextConfig"):
        assert (dataclasses.asdict(getattr(tcfg, name).b32())
                == dataclasses.asdict(getattr(jcfg, name).b32())), name
    for make in ("vicuna_7b", "vicuna_13b", "tiny"):
        assert (dataclasses.asdict(getattr(tcfg.LlamaConfig, make)())
                == dataclasses.asdict(getattr(jcfg.LlamaConfig, make)()))
    assert (dataclasses.asdict(tcfg.LlamaConfig.tiny(vocab_size=500))
            == dataclasses.asdict(jcfg.LlamaConfig.tiny(vocab_size=500)))
    for jv, tv in ((jcfg.VideoLLaVAConfig(), tcfg.VideoLLaVAConfig()),
                   (jcfg.VideoLLaVAConfig.tiny(),
                    tcfg.VideoLLaVAConfig.tiny()),
                   (jcfg.VideoLLaVAConfig(
                       vision=jcfg.CLIPVisionConfig(image_size=336)),
                    tcfg.VideoLLaVAConfig(
                        vision=tcfg.CLIPVisionConfig(image_size=336)))):
        assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        assert tv.video_token_len == jv.video_token_len
        assert (dataclasses.asdict(tv.projector)
                == dataclasses.asdict(jv.projector))
        for prop in ("grid_size", "num_patches", "num_positions",
                     "head_dim"):
            assert getattr(tv.vision, prop) == getattr(jv.vision, prop)
    names = [n for n in vars(tconst) if n.isupper()]
    assert len(names) == 9
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
