"""Quickstart: build an engine, serve a few concurrent requests through the
EngineClient lifecycle API, stream one, cancel one, and reuse a prefix —
the reference's ``examples/quickstart.py`` on the port.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless ``--device cpu`` asks for the plain versions.
``main`` returns what the run showed; :func:`check` raises unless it keeps
the example's contract (the tests and ``chip_smoke.py`` call it).
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import GenerationRequest, Request, SamplingParams
from repro_torch.device import resolve_device
from repro_torch.serving.client import EngineClient, TokenEvent
from repro_torch.serving.tokenizer import ByteTokenizer


def main(argv=None, params=None) -> dict:
    """Run the example; ``params`` (a params tree on the device) replaces
    the engine's own seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tok = ByteTokenizer()
    cfg = get_config("qwen3-0.6b-toy")
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.family}) on {device}")

    engine = InferenceEngine(cfg, params, max_batch=4, cache_len=256,
                             device=device)

    # --- batch of concurrent requests (continuous batching) --------------- #
    requests = [
        Request(prompt_tokens=tok.encode(p),
                sampling=SamplingParams(max_tokens=16))
        for p in ["hello there", "the meaning of life is",
                  "once upon a time", "def fibonacci(n):"]
    ]
    t0 = time.monotonic()
    engine.generate(requests)
    dt = time.monotonic() - t0
    total = sum(r.num_generated for r in requests)
    print(f"\nserved {len(requests)} requests / {total} tokens "
          f"in {dt:.2f}s ({total/dt:.1f} tok/s aggregate)")
    for r in requests:
        print(f"  [{r.request_id}] ttft={r.ttft*1e3:.0f}ms "
              f"tokens={r.output_tokens[:6]}...")

    # --- the request-lifecycle client: streaming + cancellation ----------- #
    client = EngineClient(engine)
    try:
        print("\nstreaming via EngineClient:")
        handle = client.submit(GenerationRequest(
            prompt="stream this", sampling=SamplingParams(max_tokens=12)))
        streamed = []
        for ev in handle.stream():
            if isinstance(ev, TokenEvent):
                streamed.append(ev.token)
                print(f"  token={ev.token:5d} text={ev.text!r}")
        finish = handle.result().choices[0].finish_reason
        print("done:", finish, f"(status={handle.status.value})")

        # true cancellation: the slot is reclaimed within one decode block
        victim = client.submit(GenerationRequest(
            prompt="never finishes", sampling=SamplingParams(max_tokens=4096)))
        time.sleep(0.05)
        victim.abort()
        print("aborted:", victim.status.value,
              f"after {victim.usage()['completion_tokens']} tokens")

        # --- prefix cache --------------------------------------------------- #
        shared = tok.encode("You are a helpful assistant. " * 4)
        cached, turns = [], []
        for i in range(2):
            r = Request(prompt_tokens=shared + tok.encode(f"Q{i}",
                                                         add_bos=False),
                        sampling=SamplingParams(max_tokens=4))
            client.generate(r)
            cached.append(r.cached_prefix_len)
            turns.append(list(r.output_tokens))
            print(f"turn {i}: ttft={r.ttft*1e3:6.1f}ms "
                  f"cached_prefix={r.cached_prefix_len} tokens")
    finally:
        client.stop()
    return {"device": str(device),
            "generated": [r.num_generated for r in requests],
            "tokens": [list(r.output_tokens) for r in requests],
            "streamed": streamed, "finish": finish,
            "victim": victim.status.value, "cached_prefix": cached,
            "turn_tokens": turns}


def check(res: dict) -> None:
    """Every request generated tokens, the stream delivered tokens and
    finished, the victim was aborted, the second turn reused the cached
    prefix."""
    if not all(res["generated"]) or not res["streamed"]:
        raise AssertionError(f"quickstart generated nothing: {res}")
    if res["finish"] not in ("length", "stop") or res["victim"] != "aborted":
        raise AssertionError(f"quickstart finish / abort: {res}")
    if not res["cached_prefix"][1] > 0:
        raise AssertionError(f"quickstart: the prefix cache missed: {res}")


if __name__ == "__main__":
    check(main())
