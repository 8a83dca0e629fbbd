"""The closed-loop streaming load generator.  It runs in a child process of
the run (started with spawn), so its client threads never hold the
server's interpreter lock, and it imports neither torch nor the program.

Each of ``clients`` threads takes the next request of the mix, sends it as
a streaming ``POST /v1/completions`` (token ids, greedy, ``logprobs: 1`` so
that every token is one chunk, the request's index in ``user``), stamps
every chunk on the shared monotonic clock, and sends its next request once
the stream has ended.  Client ``j`` starts at ``t_go + j * ramp_s /
clients`` (users do not all arrive in one instant) and sends no request at
or after ``t_end``; what is in flight then is read to its end, up to
``grace_s`` more.  With ``poll_s`` one more thread reads ``GET /stats``
that often between ``poll_from`` and ``poll_to`` and keeps the arena's
occupancy."""
from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Dict, List


def _stream(port: int, body: bytes, timeout: float) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"times": [], "logprobs": [], "finish": None,
                           "error": None}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            rec["error"] = f"http {resp.status}: {resp.read()[:200]!r}"
            return rec
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            t = time.monotonic()
            data = line[6:].strip()
            if data == b"[DONE]":
                break
            choice = json.loads(data)["choices"][0]
            if choice["logprobs"] is not None:
                rec["times"].append(t)
                rec["logprobs"].append(choice["logprobs"]["token_logprobs"][0])
            if choice["finish_reason"] is not None:
                rec["finish"] = choice["finish_reason"]
    except (OSError, http.client.HTTPException, ValueError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        conn.close()
    return rec


def run_clients(conn, port: int, traffic: Dict[str, Any], seed: int,
                vocab: int, t_go: float, t_end: float, grace_s: float,
                poll_s: float = 0.0, poll_from: float = 0.0,
                poll_to: float = 0.0) -> None:
    """Drive the closed loop and send ``{"requests": [...], "polls":
    [...]}`` back through ``conn``."""
    from bench.traffic import request

    lock = threading.Lock()
    nxt = [0]
    records: List[Dict[str, Any]] = []
    polls: List[Dict[str, Any]] = []
    stop_polls = threading.Event()

    def client(j):
        start = t_go + j * traffic["ramp_s"] / traffic["clients"]
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            req = request(traffic, seed, i, vocab)
            body = json.dumps({
                "prompt": req["prompt"], "max_tokens": req["max_tokens"],
                "temperature": 0, "stream": True, "logprobs": 1,
                "user": f"bench-{i}"}).encode()
            now = time.monotonic()
            if now < start:
                time.sleep(start - now)
            t_send = time.monotonic()
            if t_send >= t_end:
                return
            rec = _stream(port, body, timeout=t_end - t_send + grace_s)
            rec.update(index=i, t_send=t_send, t_done=time.monotonic(),
                       max_tokens=req["max_tokens"],
                       prompt_len=len(req["prompt"]),
                       context=req["context"])
            with lock:
                records.append(rec)

    def poller():
        while not stop_polls.wait(poll_s):
            t = time.monotonic()
            if t < poll_from or t > poll_to:
                continue
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            try:
                c.request("GET", "/stats")
                pages = json.loads(c.getresponse().read()).get("kv_pages")
                if pages:
                    polls.append({"t": t, **pages})
            except (OSError, http.client.HTTPException, ValueError):
                pass
            finally:
                c.close()

    threads = [threading.Thread(target=client, args=(j,), daemon=True)
               for j in range(traffic["clients"])]
    pt = threading.Thread(target=poller, daemon=True) if poll_s else None
    for t in threads:
        t.start()
    if pt is not None:
        pt.start()
    for t in threads:
        t.join(max(1.0, t_end + grace_s + 30 - time.monotonic()))
    stop_polls.set()
    if pt is not None:
        pt.join(15)
    with lock:
        out = {"requests": list(records), "polls": list(polls),
               "alive": sum(t.is_alive() for t in threads)}
    conn.send(out)
    conn.close()


def child_main(conn, go, port: int, traffic: Dict[str, Any], seed: int,
               vocab: int, grace_s: float) -> None:
    """The child's entry: say it is ready on ``go``, take the times of the
    run from it, then drive the loop."""
    go.send("ready")
    plan = go.recv()
    run_clients(conn, port, traffic, seed, vocab, plan["t_go"],
                plan["t_end"], grace_s, plan["poll_s"], plan["poll_from"],
                plan["poll_to"])
