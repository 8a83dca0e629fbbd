"""The port's three serving examples on the CPU (``--device cpu``: the
plain versions), each held to the JAX package's example on the same
inputs: both engines get the same weights (one JAX init, bridged), and
the reference's example steps run on the JAX engine with the example's
configuration, prompts and knobs (greedy).  The generated tokens, the
stream, each turn's cached prefix length, every HTTP answer, and the
media cache's hits, misses and entries per turn and per clip must be
equal.  Each run is also held to its contract by the example's own
``check`` (the contract ``chip_smoke.py`` holds on the card)."""
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import GenerationRequest as JaxGenerationRequest
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import build_model
from repro.serving.api import OpenAIServer as JaxOpenAIServer
from repro.serving.client import EngineClient as JaxEngineClient
from repro.serving.client import TokenEvent as JaxTokenEvent
from repro.serving.media import encode_b64 as jax_encode_b64
from repro.serving.media import register_url as jax_register_url
from repro.serving.server import ApiServer as JaxApiServer
from repro.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro_torch.configs import get_config
from repro_torch.examples import multimodal_cache, openai_server, quickstart
from repro_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def _weights(name):
    """The JAX engine's own default init (``PRNGKey(0)``) and its bridge."""
    jp = build_model(jax_get_config(name)).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp),
                               get_config(name), "cpu")


def _quickstart_reference(jp) -> dict:
    """``examples/quickstart.py``'s steps on the JAX engine."""
    tok = JaxByteTokenizer()
    engine = JaxEngine(jax_get_config("qwen3-0.6b-toy"), jp, max_batch=4,
                       cache_len=256)
    requests = [JaxRequest(prompt_tokens=tok.encode(p),
                           sampling=JaxSampling(max_tokens=16))
                for p in ["hello there", "the meaning of life is",
                          "once upon a time", "def fibonacci(n):"]]
    engine.generate(requests)
    client = JaxEngineClient(engine)
    try:
        handle = client.submit(JaxGenerationRequest(
            prompt="stream this", sampling=JaxSampling(max_tokens=12)))
        streamed = [ev.token for ev in handle.stream()
                    if isinstance(ev, JaxTokenEvent)]
        finish = handle.result().choices[0].finish_reason
        victim = client.submit(JaxGenerationRequest(
            prompt="never finishes", sampling=JaxSampling(max_tokens=4096)))
        time.sleep(0.05)
        victim.abort()
        shared = tok.encode("You are a helpful assistant. " * 4)
        cached, turns = [], []
        for i in range(2):
            r = JaxRequest(prompt_tokens=shared + tok.encode(
                f"Q{i}", add_bos=False), sampling=JaxSampling(max_tokens=4))
            client.generate(r)
            cached.append(r.cached_prefix_len)
            turns.append(list(r.output_tokens))
    finally:
        client.stop()
    return {"tokens": [list(r.output_tokens) for r in requests],
            "streamed": streamed, "finish": finish,
            "victim": victim.status.value, "cached_prefix": cached,
            "turn_tokens": turns}


def _openai_server_reference(jp) -> dict:
    """``examples/openai_server.py``'s server on the JAX engine, driven by
    the same concurrent clients."""
    cfg = jax_get_config("qwen3-0.6b-toy")
    client = JaxEngineClient(JaxEngine(cfg, jp, max_batch=8, cache_len=256))
    server = JaxApiServer(JaxOpenAIServer(client, cfg.name), port=0)
    server.start()
    try:
        _, results = openai_server.fire(f"http://127.0.0.1:{server.port}")
    finally:
        server.stop()
        client.stop()
    return {"answers": {k: v[1:] for k, v in sorted(results.items())}}


def _multimodal_cache_reference(jp) -> dict:
    """``examples/multimodal_cache.py``'s steps on the JAX engine (the stub
    encoder's busy work cut to one iteration, as on the port's side)."""
    tok = JaxByteTokenizer()
    engine = JaxEngine(jax_get_config("qwen3-vl-toy"), jp, max_batch=2,
                       cache_len=256, vision_work_iters=1)
    img = np.random.default_rng(0).integers(0, 255, (96, 96, 3),
                                            dtype=np.uint8)
    jax_register_url("demo://cat.png", img)
    turns = []
    for payload in (img, jax_encode_b64(img), {"url": "demo://cat.png"}):
        r = JaxRequest(prompt_tokens=tok.encode(
            "what is in this image, described fully?"), images=[payload],
            sampling=JaxSampling(max_tokens=6))
        engine.generate([r])
        turns.append({"hits": r.vision_cache_hits,
                      "misses": r.vision_cache_misses,
                      "entries": len(engine.content_cache),
                      "tokens": list(r.output_tokens)})
    frames = [np.random.default_rng(i).integers(0, 255, (48, 48, 3),
                                                dtype=np.uint8)
              for i in range(4)]
    clip2 = frames[1:] + [np.random.default_rng(9).integers(
        0, 255, (48, 48, 3), dtype=np.uint8)]
    clips = []
    for video in (frames, clip2):
        r = JaxRequest(prompt_tokens=tok.encode(
            "summarize the following video"), video_frames=video,
            sampling=JaxSampling(max_tokens=4))
        engine.generate([r])
        clips.append({"hits": r.vision_cache_hits,
                      "misses": r.vision_cache_misses,
                      "entries": len(engine.content_cache),
                      "tokens": list(r.output_tokens)})
    return {"turns": turns, "clip1": clips[0], "clip2": clips[1]}


def _drop_seconds(res: dict) -> dict:
    """The multimodal readings without their latencies and format names."""
    keep = ("hits", "misses", "entries", "tokens")
    return {"turns": [{k: t[k] for k in keep} for t in res["turns"]],
            "clip1": {k: res["clip1"][k] for k in keep},
            "clip2": {k: res["clip2"][k] for k in keep}}


@pytest.mark.parametrize("example,config,argv,reference,compared", [
    (quickstart, "qwen3-0.6b-toy", [], _quickstart_reference,
     lambda res: {k: res[k] for k in ("tokens", "streamed", "finish",
                                      "victim", "cached_prefix",
                                      "turn_tokens")}),
    (openai_server, "qwen3-0.6b-toy", [], _openai_server_reference,
     lambda res: {"answers": res["answers"]}),
    (multimodal_cache, "qwen3-vl-toy", ["--vision-work-iters", "1"],
     _multimodal_cache_reference, _drop_seconds),
], ids=["quickstart", "openai_server", "multimodal_cache"])
def test_example_contract_on_cpu(example, config, argv, reference,
                                 compared):
    jp, tp = _weights(config)
    res = example.main(["--device", "cpu"] + argv, params=tp)
    assert res["device"] == "cpu"
    example.check(res)
    assert compared(res) == reference(jp)


def test_multimodal_check_refuses_a_miss():
    """The contract fails when a format misses (an encoder rerun)."""
    res = {"turns": [{"hits": 0, "misses": 1, "entries": 2},
                     {"hits": 0, "misses": 1, "entries": 2},
                     {"hits": 1, "misses": 0, "entries": 2}],
           "clip1": {"hits": 0, "misses": 4},
           "clip2": {"hits": 3, "misses": 1}}
    with pytest.raises(AssertionError):
        multimodal_cache.check(res)
