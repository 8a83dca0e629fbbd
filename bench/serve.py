"""A serving cell: the port's threaded HTTP server in front of its engine,
driven by the closed-loop load generator (:mod:`bench.loadgen`) in a child
process.

Layers, in the order a request crosses them: ``serving/server.py
ApiServer`` -> ``serving/api.py OpenAIServer`` -> ``serving/client.py
EngineClient`` -> ``core/engine.py InferenceEngine`` -> the model and its
kernels.  The server listens on 127.0.0.1, port 0.

Set-up: weights from the seed, the engine with the configuration's knobs,
the server; for a mix of shared contexts each context sent once (a
deployment's cache is warm), for others one prompt of the context's length
(every kernel is built before the load starts); then the load generator's
clients run ``warm_s`` seconds before the window opens, so the window
starts in steady state with every shape of the mix already run.  The window is
``seconds`` long; its end-to-end metrics come from the client's stamps.

After the window: the card's peak memory is read, the server and engine
stop and their memory is freed, and the plain reference recomputes a
sample of the finished requests drawn from the seed, the longest among
them, over their prompts and served tokens (:mod:`bench.correct`).

With ``--trace 1`` the profiler records the last ``trace_s`` seconds of the
window but one, and the benchmark's spans around the engine's calls record
which slots each decode block and prefill wave served and at which
positions.  The profiler's start and stop stall the host, so the host-paced
tails of a traced run are read over the requests sent before the trace."""
from __future__ import annotations

import gc
import math
import multiprocessing as mp
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from bench import correct, traffic as gen
from bench.common import nearest_rank
from bench.loadgen import child_main
from bench.roofline.peaks import peaks_of
from bench.trace import Profile, breakdown, busy_s
from bench.weights import make_params, program_config


def _engine_modules():
    from repro_torch.core.request import GenerationRequest, SamplingParams
    from repro_torch.serving.api import OpenAIServer
    from repro_torch.serving.client import EngineClient
    from repro_torch.serving.server import ApiServer
    from repro_torch.core.engine import InferenceEngine
    return (GenerationRequest, SamplingParams, OpenAIServer, EngineClient,
            ApiServer, InferenceEngine)


def _recording_client(EngineClient):
    class RecordingClient(EngineClient):
        """Keeps each benchmark request's handle and engine request by its
        index (the ``user`` field the load generator sets), so that the
        served tokens can be checked, and the cached prefix each admission
        found read, once the window has closed."""

        def __init__(self, engine):
            super().__init__(engine)
            self.records: Dict[int, Tuple[Any, Any]] = {}

        def submit(self, request):
            tenant = getattr(request, "tenant", "")
            if not tenant.startswith("bench-") or request.n != 1:
                return super().submit(request)
            req = request.to_requests(self.engine.tokenizer)[0]
            handle = super().submit(req)
            self.records[int(tenant[6:])] = (handle, req)
            return handle

    return RecordingClient


class Spans:
    """The benchmark's spans around the engine's calls, recording only while
    ``on``: each call's host start and end (``time.time_ns``), and for the
    decode blocks and prefill waves the work they were asked for, read from
    host state that the engine already holds (no device sync)."""

    #: engine methods wrapped, with the name their idle gaps are given
    NAMES = {"step": "engine step outside the spans below (sync, emit)",
             "_plan_admissions": "admission planning",
             "_decode_block": "decode block dispatch",
             "_run_wave_group": "prefill wave",
             "_commit_jobs": "prefill commit"}

    def __init__(self, engine, plan_of):
        self.on = False
        self.blocks: List[Tuple[int, int, int, list]] = []
        self.waves: List[Tuple[int, int, list]] = []
        self.calls: List[Tuple[str, int, int]] = []

        def context(req):
            t = getattr(req, "tenant", "")
            if not t.startswith("bench-"):
                return -1, 0
            return plan_of(int(t[6:]))

        def decode_work(num_steps, *a, **kw):
            slots = []
            for s, r in list(engine.scheduler.active.items()):
                if s in engine._live_slots and not r.is_finished:
                    ctx, ctx_len = context(r)
                    g = len(r.output_tokens)
                    slots.append((ctx, ctx_len, len(r.prompt_tokens) + g,
                                  r.sampling.max_tokens - g))
            return lambda t0, t1: self.blocks.append(
                (t0, t1, num_steps, slots))

        def wave_work(bucket, cross_cached, rows):
            work = []
            for job, take in rows:
                ctx, ctx_len = context(job.req)
                work.append((ctx, ctx_len, job.consumed, take,
                             job.consumed + take >= len(job.tokens)))
            return lambda t0, t1: self.waves.append((t0, t1, work))

        work = {"_decode_block": decode_work, "_run_wave_group": wave_work}
        for name, label in self.NAMES.items():
            setattr(engine, name, self._wrap(getattr(engine, name), label,
                                             work.get(name)))
        # the profiler starts and stops only between engine steps: CUPTI
        # enabled while the engine thread launches kernels crashed a run
        self.lock = threading.Lock()
        step = engine.step

        def locked_step(*a, **kw):
            with self.lock:
                return step(*a, **kw)

        engine.step = locked_step

    def _wrap(self, fn, label, work):
        def wrapped(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            done = work(*a, **kw) if work is not None else None
            t0 = time.time_ns()
            out = fn(*a, **kw)
            t1 = time.time_ns()
            self.calls.append((label, t0, t1))
            if done is not None:
                done(t0, t1)
            return out
        return wrapped


def _counters(engine) -> Dict[str, int]:
    st = engine.scheduler.stats
    out = {"steps": st.steps, "device_steps": st.device_steps,
           "tokens_generated": st.tokens_generated,
           "prefill_waves": st.prefill_waves, "retired": st.retired}
    if engine.prefix_cache is not None:
        out["prefix_hits"] = engine.prefix_cache.stats.hits
        out["prefix_misses"] = engine.prefix_cache.stats.misses
    return out


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


def end_to_end(reqs: List[Dict[str, Any]], t0: float, t1: float
               ) -> Dict[str, Any]:
    """The window's end-to-end metrics from the client's stamps: tokens
    streamed inside ``[t0, t1)`` over the window; the 95th percentile of
    time to first token over every request sent in the window (a request
    that failed or never streamed a token counts as missing, ``inf``); the
    95th percentile over the requests completed in the window of (last
    token - first token) / (tokens - 1)."""
    seconds = t1 - t0
    toks = sum(1 for r in reqs for t in r["times"] if t0 <= t < t1)
    sent = [r for r in reqs if t0 <= r["t_send"] < t1]
    ttft = [(r["times"][0] - r["t_send"]) * 1e3
            if r["times"] and r["error"] is None else math.inf for r in sent]
    done = [r for r in reqs if r["error"] is None and len(r["times"]) > 1
            and t0 <= r["times"][-1] < t1]
    tpot = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3
            for r in done]
    failed = sum(1 for r in sent if r["error"] is not None or not r["times"])
    return {"output_tokens_per_s": toks / seconds,
            "ttft_p95_ms": nearest_rank(ttft, 95),
            "tpot_p95_ms": nearest_rank(tpot, 95),
            "attempted": len(sent), "failed": failed,
            "completed": len(done), "window_tokens": toks}


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, port_cfg=None,
        keep: Optional[Dict[str, Any]] = None
        ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, Any]]]:
    """One run; ``keep``, where given, receives the weights, the checked
    sample and its served choices (for the control's readings)."""
    (GenerationRequest, SamplingParams, OpenAIServer, EngineClient,
     ApiServer, InferenceEngine) = _engine_modules()
    cfg, mix = cell["config"], cell["traffic"]
    if port_cfg is None:
        port_cfg = program_config(cfg)
    vocab = cfg["vocab_size"]
    marks = [("start", t_start), ("imports", time.monotonic())]
    params = make_params(cfg, seed, device)
    marks.append(("weights", time.monotonic()))
    engine = InferenceEngine(port_cfg, params, device=device,
                             seed=int(seed) % (1 << 31), **cfg["serve"])
    client = _recording_client(EngineClient)(engine)
    server = ApiServer(OpenAIServer(client, model_name=cfg["name"]),
                       host="127.0.0.1", port=0)
    server.start()
    marks.append(("engine and server", time.monotonic()))
    plans: Dict[int, Tuple[int, int]] = {}
    ctx_len = mix["context"]["tokens"]

    def plan_of(i):
        if i not in plans:
            c = gen.request_plan(mix, seed, i)["context"]
            plans[i] = (c, ctx_len)
        return plans[i]

    spans = Spans(engine, plan_of) if trace else None
    proc = None
    try:
        # every kernel is built before the load starts: the shared
        # contexts, each sent once, or one prompt of the mix's context
        # length; the first run in a checkout compiles here
        ctx_ids = (range(mix["context"]["count"])
                   if mix["context"]["shared"] else [0])
        warm = [client.submit(GenerationRequest(
            prompt=gen.context_tokens(mix, seed, c, vocab),
            sampling=SamplingParams(max_tokens=2))) for c in ctx_ids]
        for h in warm:
            h.result(timeout=900)
        if trace:
            with spans.lock:
                Profile.warm_up(device)
        ctx = mp.get_context("spawn")
        here, there = ctx.Pipe()
        ready, go = ctx.Pipe()
        proc = ctx.Process(target=child_main, args=(
            there, go, server.port, mix, seed, vocab, mix["grace_s"]),
            daemon=True)
        marks.append(("warm prompts", time.monotonic()))
        proc.start()
        if not ready.poll(120):
            raise RuntimeError("the load generator did not start")
        ready.recv()
        marks.append(("load generator started", time.monotonic()))
        t_go = time.monotonic() + 0.05
        t0 = t_go + mix["warm_s"]
        t1 = t0 + seconds
        te = t1 - min(1.0, seconds / 4)
        ts = max(t0, te - mix["trace_s"])
        ready.send({"t_go": t_go, "t_end": t1,
                    "poll_s": 1.0 if trace else 0.0,
                    "poll_from": ts, "poll_to": te})
        _sleep_until(t0)
        setup_s = t0 - t_start
        marks.append(("warm-up", t0))
        print("set-up: " + ", ".join(
            f"{name} {b - a:.2f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), file=sys.stderr, flush=True)
        c0 = _counters(engine)
        prof = None
        if trace:
            _sleep_until(ts)
            cs = _counters(engine)
            spans.on = True
            prof = Profile()
            with spans.lock:
                prof.start()
            _sleep_until(te)
            with spans.lock:
                prof.stop()
            spans.on = False
            ce = _counters(engine)
        _sleep_until(t1)
        c1 = _counters(engine)
        if not here.poll(seconds + mix["grace_s"] + 120):
            raise RuntimeError("the load generator sent no records")
        got = here.recv()
        proc.join(30)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        reqs = got["requests"]
        e2e = end_to_end(reqs, t0, t1)
        if trace:
            prof.collect()
        print(f"serve: sent {e2e['attempted']} completed {e2e['completed']} "
              f"failed {e2e['failed']} window tokens {e2e['window_tokens']} "
              f"counters {c0} -> {c1} peak {peak / 2**30:.2f} GiB "
              f"set-up {setup_s:.2f} s", file=sys.stderr, flush=True)
        sample = correct.serve_sample(reqs, t0, seed,
                                      cfg["checks"]["sample_tokens"],
                                      cfg["checks"]["sample_max"])
        served = {}
        for r in sample:
            res = client.records[r["index"]][0].result(timeout=60)
            served[r["index"]] = res.choices[0]
        cached = [client.records[r["index"]][1].cached_prefix_len
                  for r in reqs if t0 <= r["t_send"] < t1
                  and r["index"] in client.records]
        print(f"serve: window requests with a cached prefix "
              f"{sum(1 for c in cached if c > 0)} of {len(cached)}",
              file=sys.stderr, flush=True)
    finally:
        client.stop()
        server.stop()
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(10)
    del engine, client, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = correct.check_serve(params, cfg, mix, seed, sample, served,
                                 e2e["failed"])
    if keep is not None:
        keep.update(params=params, sample=sample, served=served)
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": e2e["attempted"], "failed": e2e["failed"],
              "peak": peak, "setup_s": setup_s}
    if not trace:
        result["metrics"] = {"output_tokens_per_s":
                             e2e["output_tokens_per_s"]}
        return result, checks
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    rec = {"kind": "serve", "cfg": cfg, "traffic": mix,
           "peaks": peaks_of(kind),
           "window_s": prof.window_s, "t0_ns": prof.t0_ns,
           "t1_ns": prof.t1_ns, "counters": (cs, ce),
           "blocks": spans.blocks, "waves": spans.waves,
           "kernels": prof.kernels, "launches": prof.launches,
           "busy_s": busy_s(prof.kernels), "polls": got["polls"],
           "cached": cached, "e2e": end_to_end(reqs, t0, ts)}
    result["per_layer_rec"] = rec
    result["busy_s"] = rec["busy_s"]
    result["window_s"] = rec["window_s"]
    result["breakdown"] = breakdown(prof.kernels, spans.calls,
                                    prof.t0_ns, prof.t1_ns)
    return result, checks
