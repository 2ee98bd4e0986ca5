"""Shared pieces of the tensor-parallel tests (tests/test_torch_tp_*.py,
test_torch_multihost.py, test_torch_driver_latch.py): the tiny configuration of
tests/test_sharding.py, groups of ranks spawned on the CPU over gloo
with a join timeout of their own (a hung rendezvous fails the test
instead of the tier), and the workers those ranks run. The spawned
ranks import this module, so it imports no JAX: numpy trees and plain
values cross into them.

A group's ranks build the port's model from the same numpy tree as the
test's JAX side (engine/convert.params_from_jax), keep their shard
(parallel/sharding.shard_params over make_mesh(1, world)) and run the
same program in lockstep, SPMD: every rank makes the same calls, so
their collectives meet (the driver of the entry points, which makes
rank 0 broadcast its calls, is what tests/test_torch_tp_serving.py,
test_torch_tp_hangup.py and test_torch_driver_latch.py run). Rank 0's
result comes back through a file."""

import dataclasses
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from video_llava_tpu_torch.config import (
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu_torch.parallel import driver

GROUP_TIMEOUT_S = 180.0  # one spawned group, start to join


def tiny_cfg(vocab_size: int = 512) -> VideoLLaVAConfig:
    """tests/test_sharding.py's configuration (vocab 512, hidden 64, 2
    layers, 8 heads of 8), in the port's config classes."""
    return dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig(vocab_size=vocab_size, hidden_size=64,
                        intermediate_size=128, num_layers=2, num_heads=8,
                        num_kv_heads=8, head_dim=8,
                        max_position_embeddings=512),
        vid_patch_token_id=259, vid_start_token_id=260,
        vid_end_token_id=261)


def _entry(worker, rank, world, init, out, args):
    torch.set_num_threads(1)
    from video_llava_tpu_torch.parallel import multihost

    multihost.init_distributed("gloo", init, world, rank)
    try:
        result = worker(rank, world, *args)
        if rank == 0:
            torch.save(result, out)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(worker, world: int, tmp_path, *args,
              timeout: float = GROUP_TIMEOUT_S):
    """worker(rank, world, *args) on `world` spawned gloo ranks (a
    file:// rendezvous under tmp_path) -> rank 0's return value. Raises
    if a rank fails, or if the group has not joined within `timeout`
    seconds (every rank is then terminated)."""
    ctx = torch.multiprocessing.get_context("spawn")
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    init = f"file://{tmp_path}/store_{tag}"
    out = str(tmp_path / f"rank0_{tag}.pt")
    procs = [ctx.Process(target=_entry,
                         args=(worker, r, world, init, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return torch.load(out, weights_only=False)


def port_model(tree, cfg, world: int):
    """The port's VideoLLaVA of a numpy tree, sharded over
    make_mesh(1, world)."""
    from video_llava_tpu_torch.engine.convert import params_from_jax
    from video_llava_tpu_torch.parallel import make_mesh, shard_params

    model = params_from_jax(tree, cfg)
    if world > 1:
        shard_params(model, make_mesh(1, world))
    return model


def greedy_gen(max_new: int, eos: int = 2, pad: int = 0) -> GenerationConfig:
    return GenerationConfig(max_new_tokens=max_new, do_sample=False,
                            temperature=0.0, eos_token_id=eos,
                            pad_token_id=pad)


# -- workers --------------------------------------------------------------


def forward_worker(rank, world, tree, cfg, ids, feats, lens, max_new,
                   pixels):
    """The TP video encode (CLIP and pooling), forward without a cache
    (logits) and greedy generate (tokens) of the tiny model."""
    from video_llava_tpu_torch.engine.generate import generate

    model = port_model(tree, cfg, world)
    with torch.inference_mode():
        enc = model.encode_video(torch.from_numpy(pixels))
        logits, _ = model(torch.from_numpy(ids), torch.from_numpy(feats))
        res = generate(model, greedy_gen(max_new), torch.from_numpy(ids),
                       torch.from_numpy(lens), torch.from_numpy(feats),
                       cache_dtype=torch.float32)
    return {"enc": enc.numpy(), "logits": logits.numpy(),
            "tokens": res.tokens.numpy(),
            "lengths": res.lengths.numpy(),
            "heads": model.llm.cfg.num_heads,
            "vision_heads": model.vision.layers[0].num_heads}


def decode_worker(rank, world, runs, cfg, ids, feats, lens, cache_dtype):
    """For each (tree, teacher) of `runs`: prefill, then teacher-forced
    decode steps (tokens `teacher`, (steps, b)) -> the logits of the
    prefill and of each step."""
    outs = []
    for tree, teacher in runs:
        model = port_model(tree, cfg, world)
        out = []
        with torch.inference_mode():
            pre = model.prefill(torch.from_numpy(ids),
                                torch.from_numpy(lens),
                                torch.from_numpy(feats), ids.shape[1] + 8,
                                getattr(torch, cache_dtype))
            out.append(pre.logits_last.float().numpy())
            cache = pre.cache
            for tok in teacher:
                logits, cache = model.llm.decode_step(torch.from_numpy(tok),
                                                      cache)
                out.append(logits.float().numpy())
        outs.append(out)
    return outs


def continuous_worker(rank, world, tree, cfg, prompts, engine_kw, max_new,
                      eos):
    """Each engine layout of `engine_kw` (a list of ContinuousEngine
    keyword dicts) run to completion over `prompts`, stepped in lockstep
    on every rank -> the tokens of each layout."""
    from video_llava_tpu_torch.engine.continuous import (
        ContinuousEngine,
        SlotRequest,
    )

    model = port_model(tree, cfg, world)
    outs = []
    for kw in engine_kw:
        eng = ContinuousEngine(model, cfg, **kw)
        handles = [eng.submit(SlotRequest(p, max_new_tokens=max_new,
                                          eos_token_id=eos))
                   for p in prompts]
        for _ in range(300):
            if all(h.done for h in handles):
                break
            eng.step_once()
        outs.append([h.tokens for h in handles])
    return outs


def multihost_worker(rank, world):
    """all_gather_objects and reduce_dict across the ranks, and the
    process-group views of the helpers."""
    from video_llava_tpu_torch.parallel import multihost

    return {
        "rank": multihost.get_rank(), "world": multihost.get_world_size(),
        "main": multihost.is_main_process(),
        "gathered": multihost.all_gather_objects(
            {"rank": rank, "name": "r" * (rank + 1),
             "arr": np.arange(rank + 2)}),
        "mean": multihost.reduce_dict({"loss": 1.0 + rank,
                                       "acc": 0.25 * rank}),
        "sum": multihost.reduce_dict({"n": 2.0 + rank}, average=False),
    }



class Counter:
    """A registered object with one replicated method, for the driver's
    own checks."""

    def __init__(self):
        self.n = 0

    @driver.replicated
    def add(self, k):
        self.n += k
        return self.n


class Streamer:
    """A registered object whose replicated method streams: after each
    of `steps` sums over the ranks it calls `on_delta`, as a decode loop
    calls its streaming callback between forwards."""

    def __init__(self):
        from video_llava_tpu_torch.parallel import make_mesh

        self.mesh = make_mesh()
        self.calls = 0

    @driver.replicated
    def run(self, steps, on_delta=None):
        self.calls += 1
        total = 0.0
        for i in range(steps):
            x = torch.full((1,), float(self.mesh.rank + 1))
            total += float(self.mesh.all_sum(x)[0])
            if on_delta is not None:
                on_delta(i)
        # every rank's count of calls, summed: 2 * calls when in step
        n = self.mesh.all_sum(torch.full((1,), float(self.calls)))
        return total, float(n[0])


def follower(argv) -> None:
    """A follower that runs rank 0's calls until it is stopped."""
    driver.start(2, "gloo", None, "cpu")
    try:
        driver.follow()
    finally:
        driver.stop()


def latch_leader(init_method: str) -> None:
    """Rank 0 of the driver's latch check
    (tests/test_torch_driver_latch.py):
    a streaming callback that raises mid-call, then a second call, which
    must find the follower in step. Prints "latched"."""
    driver.start(2, "gloo", init_method, "cpu",
                 entry=("torch_tp_pair", "follower"), argv=[])
    try:
        streamer = driver.new(Streamer)
        seen = []

        def hung_up(i):
            seen.append(i)
            if i == 1:
                raise BrokenPipeError("the client hung up")

        try:
            streamer.run(4, on_delta=hung_up)
            raise AssertionError("the callback's exception was lost")
        except BrokenPipeError:
            pass
        # latched after its first failure; the ranks' sums all ran
        assert seen == [0, 1], seen
        # in step: each sum meets its partner, and both ranks count two
        # calls
        assert streamer.run(3, on_delta=seen.append) == (9.0, 4.0)
        assert seen == [0, 1, 0, 1, 2], seen
    finally:
        driver.stop()
    assert not dist.is_initialized() and not driver.active()
    print("latched", flush=True)


def _text_engine(mesh_model):
    """The tiny f32 engine on the CPU under --mesh_model, answering in
    text to its last token: its random model's draws land past the byte
    ids, which decode to nothing, unless the logits past the bytes,
    <pad> and <s> are masked (Llama.logits masks columns at or past
    cfg.vocab_size), </s> among them."""
    from video_llava_tpu_torch.runtime.model_init import initialize_model

    engine = initialize_model(model_size="tiny", device="cpu",
                              dtype=torch.float32, mesh_model=mesh_model)
    llm = engine.model.llm
    llm.cfg = dataclasses.replace(llm.cfg, vocab_size=258)
    return engine


def hangup_follower(argv) -> None:
    driver.start(2, "gloo", None, "cpu")
    try:
        _text_engine(2)
        driver.follow()
    finally:
        driver.stop()


def _post(port: int, body: dict) -> str:
    import json
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    reply = json.loads(urllib.request.urlopen(req, timeout=60).read())
    return reply["choices"][0]["message"]["content"]


def _hang_up_stream(port: int, body: dict) -> None:
    """Open a stream, read its first chunk, then hang up with a reset
    (the server's next write fails at once)."""
    import json
    import socket
    import struct

    data = json.dumps(dict(body, stream=True)).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\n"
                     b"Host: 127.0.0.1\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: " + str(len(data)).encode()
                     + b"\r\n\r\n" + data)
        got = b""
        while b'"role": "assistant"' not in got:
            piece = sock.recv(4096)
            assert piece, got
            got += piece
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))


def hangup_leader(init_method: str) -> None:
    """Rank 0 of the serving hang-up check
    (tests/test_torch_tp_hangup.py): the plain and the batching server
    under --mesh_model 2 answer a sampled request, a stream of the same
    request whose client hangs up after its first chunk, and the request
    again, which must get the first answer. The answer runs to 160
    tokens, so the stream's first delta (its first write after the
    hang-up) comes after the first 64-token chunk, mid-call. Prints
    "served"."""
    from video_llava_tpu_torch.serving.server import ChatModel, serve

    driver.start(2, "gloo", init_method, "cpu",
                 entry=("torch_tp_pair", "hangup_follower"), argv=[])
    try:
        engine = _text_engine(2)
        model = driver.new(
            ChatModel, model=engine.model, cfg=engine.cfg,
            tokenizer=engine.tokenizer, conv_mode="vicuna_v1_1",
            cache_dtype=torch.float32, speculative=False)
        body = {"messages": [{"role": "user", "content": "Tell a story."}],
                "temperature": 1.0, "seed": 3, "max_tokens": 160}
        for batching in (False, True):
            server = serve(model, host="127.0.0.1", port=0, block=False,
                           batching=batching)
            port = server.server_address[1]
            try:
                first = _post(port, body)
                _hang_up_stream(port, body)
                again = _post(port, body)
            finally:
                server.shutdown()
                server.server_close()
            # more characters than the first chunk's 64 tokens give
            assert len(first) > 64 and again == first, (batching, first,
                                                        again)
    finally:
        driver.stop()
    print("served", flush=True)


def dying_follower(argv) -> None:
    """A follower that joins the ranks, then exits at once with code 3
    instead of following."""
    driver.start(2, "gloo", None, "cpu")
    os._exit(3)
