"""The port's conversation templates and byte tokenizer give the JAX
package's prompt strings and token ids: every template, through a
video question, an answer and a second turn, and each prompt's ids and
their decoding."""

from video_llava_tpu.runtime import conversation as jconv
from video_llava_tpu.runtime.tokenizer import load_tokenizer as jload
from video_llava_tpu_torch.runtime import conversation as tconv
from video_llava_tpu_torch.runtime.tokenizer import load_tokenizer as tload

TURNS = (("What is happening in this video?\n<video>", "A dog runs. é"),
         ("And then?", None))


def test_prompts_and_token_ids_match_jax():
    assert tconv.conv_templates.keys() == jconv.conv_templates.keys()
    jtok, ttok = jload(None), tload(None)
    for attr in ("bos_token_id", "eos_token_id", "pad_token_id",
                 "vid_patch_token_id", "vid_start_token_id",
                 "vid_end_token_id", "vocab_size"):
        assert getattr(ttok, attr) == getattr(jtok, attr), attr
    for name in jconv.conv_templates:
        jc = jconv.conv_templates[name].copy()
        tc = tconv.conv_templates[name].copy()
        assert tc.stop_string() == jc.stop_string(), name
        assert tc.version == jc.version, name
        assert tc.get_prompt() == jc.get_prompt(), name
        for question, answer in TURNS:
            for conv in (jc, tc):
                conv.append_message(conv.roles[0], question)
                conv.append_message(conv.roles[1], answer)
            prompt = tc.get_prompt()
            assert prompt == jc.get_prompt(), name
            video = "<vid_start>" + "<vid_patch>" * 3 + "<vid_end>"
            text = prompt.replace("<video>", video)
            ids = ttok.encode(text)
            assert ids == jtok.encode(text), name
            assert ttok.encode(text, add_bos=False) == ids[1:]
            for skip in (True, False):
                assert (ttok.decode(ids, skip_special_tokens=skip)
                        == jtok.decode(ids, skip_special_tokens=skip))
    # a template's copy is independent of the template
    assert tconv.conv_templates["pg-video-llava"].messages == []
    assert tconv.default_conversation.copy().get_prompt() == (
        jconv.default_conversation.copy().get_prompt())
