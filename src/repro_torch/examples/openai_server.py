"""End-to-end serving example: start the OpenAI-compatible HTTP server over
the continuous-batching engine, fire concurrent clients at it and report
aggregate throughput — the reference's ``examples/openai_server.py`` on the
port.

  PYTHONPATH=src python -m repro_torch.examples.openai_server [--device cpu]

Runs on the card unless ``--device cpu`` asks for the plain versions.
``main`` returns each answer (text, completion tokens, finish) and the
readings;
:func:`check` raises unless every request was answered.
"""
import argparse
import json
import threading
import time
import urllib.request

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.device import resolve_device
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.client import EngineClient
from repro_torch.serving.server import ApiServer

N_CLIENTS, N_REQ = 8, 3


def _chat(base: str, body: dict) -> dict:
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.load(r)


def fire(base: str) -> tuple:
    """One warm-up request, then ``N_CLIENTS`` threads that each send
    ``N_REQ`` chat requests to the server at ``base``.  Returns the wall
    seconds and, per request id ``"client/question"``, its latency and the
    answer's text, completion tokens and finish reason."""
    results, errors = {}, []
    lock = threading.Lock()

    def one_client(cid: int) -> None:
        try:
            for i in range(N_REQ):
                body = {"messages": [{"role": "user",
                                      "content": f"client {cid} question {i}"}],
                        "max_tokens": 12}
                t0 = time.monotonic()
                resp = _chat(base, body)
                choice = resp["choices"][0]
                with lock:
                    results[f"{cid}/{i}"] = (
                        time.monotonic() - t0, choice["message"]["content"],
                        resp["usage"]["completion_tokens"],
                        choice["finish_reason"])
        except Exception as e:                                  # noqa: BLE001
            with lock:
                errors.append(repr(e))

    _chat(base, {"messages": [{"role": "user", "content": "warm"}],
                 "max_tokens": 2})
    t0 = time.monotonic()
    threads = [threading.Thread(target=one_client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"client errors: {errors}")
    return wall, results


def main(argv=None, params=None) -> dict:
    """Run the example; ``params`` (a params tree on the device) replaces
    the engine's own seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("qwen3-0.6b-toy")
    engine = InferenceEngine(cfg, params, max_batch=8, cache_len=256,
                             device=device)
    client = EngineClient(engine)
    server = ApiServer(OpenAIServer(client, cfg.name), port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    print(f"serving {cfg.name} on {device} at {base}/v1/chat/completions")
    try:
        wall, results = fire(base)
    finally:
        server.stop()
        client.stop()

    toks = sum(n for _, _, n, _ in results.values())
    lats = sorted(dt for dt, _, _, _ in results.values())
    print(f"\n{len(results)} requests from {N_CLIENTS} concurrent clients "
          f"in {wall:.2f}s")
    print(f"  aggregate: {toks/wall:.1f} tok/s, {len(results)/wall:.2f} req/s")
    print(f"  latency p50={lats[len(lats)//2]*1e3:.0f}ms "
          f"p95={lats[int(len(lats)*0.95)]*1e3:.0f}ms")
    print(f"  peak batch occupancy: {engine.scheduler.stats.peak_batch}")
    return {"device": str(device),
            "answers": {k: v[1:] for k, v in sorted(results.items())},
            "completion_tokens": [n for _, _, n, _ in results.values()],
            "finish": [f for _, _, _, f in results.values()], "wall_s": wall,
            "tokens_per_s": toks / wall,
            "peak_batch": engine.scheduler.stats.peak_batch}


def check(res: dict) -> None:
    """All ``N_CLIENTS x N_REQ`` requests answered with tokens and a stop
    or length finish."""
    n = N_CLIENTS * N_REQ
    if (len(res["completion_tokens"]) != n or not all(res["completion_tokens"])
            or set(res["finish"]) - {"length", "stop"}):
        raise AssertionError(f"openai_server: {res}")


if __name__ == "__main__":
    check(main())
