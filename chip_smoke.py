#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases (any failure exits non-zero and prints no result line):

1. environment — torch/CUDA versions, the card's name and power limit, the
   hand-written kernels built from ``src/repro_torch/csrc`` with nvcc for
   ``sm_90a`` (TF32 off for every float32 product);
2. kernels — each CUDA kernel against its plain PyTorch version at the
   serving path's shapes, in bf16 (atol 2e-2) and float32 (atol 1e-4);
3. full-width model — ``qwen2-0.5b`` in float32 with seeded random weights:
   a resume-prefill and 8 decode steps through the kernels against the same
   model through the plain versions (max |Δlogit| <= 1e-3, argmax agreement);
4. serving — ``qwen2-0.5b`` in bf16 behind EngineClient + OpenAIServer +
   ApiServer on 127.0.0.1: 12 concurrent chat / completion requests (one
   streamed, one chunked over 512 prompt tokens, one with logprobs); every
   finish_reason and usage is checked, and both kernels' launch counters
   must rise during this phase (they are zeroed just before it);
5. times — each kernel, its plain version and one PyTorch library call
   (SDPA with an explicit mask) at the phase-2 serving shapes, with CUDA
   events over rotating input copies larger than the L2 cache, beside the
   least time the card could take (``bound_ms``).

The last lines are one ``{"kernels": [...]}`` JSON line, one ``serve`` JSON
line, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
PEAK_BF16_FLOPS = 989e12          # dense tensor-core bf16, data sheet
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:61",
    "flash_attention": "src/repro/kernels/flash_attention.py:84",
}
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# shapes of the serving path (qwen2-0.5b: H=14, Hkv=2, D=64; B=8, S=2048)
# --------------------------------------------------------------------------- #
def decode_case(torch, dtype, *, b=8, s=2048, h=14, hkv=2, d=64, seed=0):
    """Ragged per-row lengths and one wrapped (all-valid) row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lengths[0] = s
    valid = torch.arange(s, device="cuda")[None] < lengths[:, None]
    return (q, k, v, valid), {}


def flash_case(torch, dtype, form, *, seed=0):
    """``engine``: a 512-token bucket over a 2048 cache, per-row
    q_positions and kv_valid; ``causal_offset`` / ``window``: the Pallas
    kernel's own modes; ``ragged``: Skv = 1000."""
    b, sq, skv, h, hkv, d = {"engine": (8, 512, 2048, 14, 2, 64),
                             "causal_offset": (2, 512, 2048, 14, 2, 64),
                             "window": (2, 512, 512, 14, 2, 64),
                             "ragged": (3, 200, 1000, 14, 2, 64)}[form]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    kw = {"causal": True}
    if form == "engine":
        start = torch.randint(0, skv - sq + 1, (b,), generator=g,
                              device="cuda")
        kw["q_positions"] = (start[:, None] + torch.arange(
            sq, device="cuda")[None]).to(torch.int32)
        kw["kv_valid"] = torch.arange(skv, device="cuda")[None] < \
            (start + sq)[:, None]
    elif form in ("causal_offset", "ragged"):
        kw["q_offset"] = skv - sq
    elif form == "window":
        kw["window"] = 256
    return (q, k, v), kw


def max_err(torch, a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_kernels(torch, dec, fla):
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        cases = [("decode_attention", "B8 S2048 G7", dec,
                  decode_case(torch, dtype)),
                 ("decode_attention", "B3 S1000 G7", dec,
                  decode_case(torch, dtype, b=3, s=1000))]
        cases += [("flash_attention", form, fla, flash_case(torch, dtype, form))
                  for form in ("engine", "causal_offset", "window", "ragged")]
        for name, what, mod, (args, kw) in cases:
            kern = getattr(mod, f"{name}_cuda")
            plain = getattr(mod, f"{name}_plain")
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            err = max_err(torch, got, plain(*args, **kw))
            ok = err <= TOL[dname] and bool(torch.isfinite(got).all())
            log(f"  {name:17s} {dname:8s} {what:14s} max|kernel-plain| "
                f"{err:.3e} (tol {TOL[dname]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {dname} {what}: error {err}")
            if dname == "bfloat16":
                errs[name] = max(errs.get(name, 0.0), err)
    return errs


# --------------------------------------------------------------------------- #
# phase 3: the full-width model through the kernels vs the plain versions
# --------------------------------------------------------------------------- #
@contextmanager
def plain_attention(ops):
    """Route the layers' attention calls to the plain versions (the
    comparison's reference side), whatever the tensors' device."""
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention = ops._flash_plain
    ops.decode_attention = ops._decode_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def check_model(torch, ops, get_config, Model, init_cache):
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, s, cache_len = 2, 300, 512
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device="cuda")
    lengths = torch.tensor([s, 257], device="cuda")
    seq_valid = torch.arange(s, device="cuda")[None] < lengths[:, None]
    positions = torch.arange(s, device="cuda")[None].expand(b, s)

    def run(feed):
        """Prefill, then 8 decode steps fed ``feed`` (or, with None, the
        path's own greedy tokens, which are returned)."""
        cache = init_cache(cfg, b, cache_len, device="cuda")
        out = model.apply(params, tokens, mode="prefill", positions=positions,
                          cache=cache, resume=True, seq_valid=seq_valid)
        logits = [out.logits[torch.arange(b, device="cuda"), lengths - 1]]
        toks, pos = [], lengths.clone()
        for step in range(8):
            tok = logits[-1].argmax(-1) if feed is None else feed[step]
            toks.append(tok)
            out = model.apply(params, tok[:, None], mode="decode",
                              positions=pos[:, None], cache=cache)
            logits.append(out.logits[:, 0])
            pos = pos + 1
        return torch.stack(logits), toks

    with torch.no_grad():
        kern, fed = run(None)
        with plain_attention(ops):
            plain, _ = run(fed)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError("non-finite logits through the kernels")
    err = max_err(torch, kern, plain)
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"  qwen2-0.5b float32, {cfg.num_layers} layers: prefill {b}x{s} + "
        f"8 decode steps, "
        f"max|Δlogit| {err:.3e} (tol 1e-3), argmax agreement {agree:.3f}, "
        f"logit scale {kern.abs().max().item():.3e}")
    if err > 1e-3 or agree < 1.0:
        raise AssertionError(f"model through kernels disagrees: {err}, {agree}")
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 4: serving
# --------------------------------------------------------------------------- #
def post(port: int, path: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read().decode()
        if body.get("stream"):
            events = [line[len("data: "):] for line in raw.split("\n\n")
                      if line.startswith("data: ")]
            if not events or events[-1] != "[DONE]":
                raise AssertionError(f"bad SSE framing: {raw[:200]!r}")
            return [json.loads(e) for e in events[:-1]]
        return json.loads(raw)


def serve_requests():
    """12 bodies: chat and completions mixed, one streamed over SSE, one
    prompt over 512 tokens (chunked prefill), one with logprobs, a few
    sampled."""
    long_text = " ".join(f"token{i:03d}" for i in range(80))      # 639 chars
    out = [("chat", {"messages": [{"role": "user", "content": long_text}],
                     "max_tokens": 24}),
           ("chat", {"messages": [{"role": "system", "content": "be brief"},
                                  {"role": "user", "content": "stream me"}],
                     "max_tokens": 20, "stream": True,
                     "stream_options": {"include_usage": True}}),
           ("completion", {"prompt": "logprobs please", "max_tokens": 16,
                           "logprobs": 3})]
    for i in range(9):
        extra = ({"temperature": 0.8, "top_p": 0.9, "seed": i}
                 if i % 3 == 0 else {})
        if i % 2:
            out.append(("chat", {"messages": [{"role": "user",
                                               "content": f"question {i}"}],
                                 "max_tokens": 8 + 4 * i, **extra}))
        else:
            out.append(("completion", {"prompt": f"complete this {i}",
                                       "max_tokens": 8 + 4 * i, **extra}))
    return out


def check_response(kind, body, resp, tok) -> int:
    """Check finish_reason and usage of one response; returns its
    completion tokens."""
    if kind == "chat":
        prompt = "".join(f"<|{m['role']}|>{m['content']}"
                         for m in body["messages"]) + "<|assistant|>"
    else:
        prompt = body["prompt"]
    want_prompt = len(tok.encode(prompt))
    if body.get("stream"):
        finishes = [c["choices"][0]["finish_reason"] for c in resp
                    if c["choices"] and c["choices"][0]["finish_reason"]]
        usage = resp[-1]["usage"]
        text = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in resp if c["choices"])
        reason = finishes[-1] if len(finishes) == 1 else None
    else:
        usage = resp["usage"]
        choice = resp["choices"][0]
        reason = choice["finish_reason"]
        text = choice["message"]["content"] if kind == "chat" else choice["text"]
        if body.get("logprobs"):
            lps = choice["logprobs"]["token_logprobs"]
            if len(lps) != usage["completion_tokens"] or \
                    not all(math.isfinite(x) and x <= 0 for x in lps):
                raise AssertionError(f"bad logprobs {lps}")
    n = usage["completion_tokens"]
    ok = (reason in ("stop", "length") and usage["prompt_tokens"] == want_prompt
          and usage["total_tokens"] == want_prompt + n
          and 1 <= n <= body["max_tokens"]
          and (reason != "length" or n == body["max_tokens"])
          and isinstance(text, str))
    if not ok:
        raise AssertionError(f"bad response for {body}: reason {reason}, "
                             f"usage {usage}, want prompt {want_prompt}")
    return n


def check_serving(torch, get_config, InferenceEngine, EngineClient,
                  OpenAIServer, ApiServer, wrappers):
    """``wrappers`` maps each kernel's name to its CUDA wrapper, whose
    ``launches`` count is zeroed before the counted round and read after."""
    engine = InferenceEngine(get_config("qwen2-0.5b"), device="cuda",
                             max_batch=8, cache_len=2048, prefill_chunk=512,
                             seed=0)
    client = EngineClient(engine)
    server = ApiServer(OpenAIServer(client, "qwen2-0.5b"), host="127.0.0.1",
                       port=0)
    server.start()
    bodies = serve_requests()
    tok = engine.tokenizer

    def send_all():
        """All bodies at once, one client thread each; every response is
        checked.  Returns (completion tokens, wall s)."""
        results = [None] * len(bodies)

        def one(i):
            kind, body = bodies[i]
            path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
            try:
                results[i] = post(server.port, path, body)
            except Exception as e:            # reported below, per request
                results[i] = e

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = 0
        for (kind, body), resp in zip(bodies, results):
            if resp is None or isinstance(resp, Exception):
                raise AssertionError(f"request {body} failed: {resp!r}")
            done += check_response(kind, body, resp, tok)
        return done, wall

    try:
        # a first round of the same mix takes the first-call costs (kernel
        # loading, GEMM heuristics per shape); the second is the one counted
        _, cold_wall = send_all()
        torch.cuda.reset_peak_memory_stats()
        before = server.api.stats()
        for w in wrappers.values():
            w.launches = 0
        done, wall = send_all()
        launches = {name: w.launches for name, w in wrappers.items()}
        after = server.api.stats()
        profile = profile_round(torch, send_all)
    finally:
        server.stop()
        client.stop()
    stats = {k: after[k] - before[k] for k in
             ("retired", "aborted", "prefill_waves", "device_steps")}
    if stats["retired"] != len(bodies) or stats["aborted"]:
        raise AssertionError(f"engine counters disagree: {stats}")
    layers = engine.cfg.num_layers
    log(f"  12 requests finished with correct usage: {done} completion "
        f"tokens in {wall:.3f} s (first round {cold_wall:.3f} s), "
        f"{stats['prefill_waves']} prefill waves, "
        f"{stats['device_steps']} decode steps, launches {launches} "
        f"({layers} per decode step / prefill wave)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched while serving")
    if launches["decode_attention"] != layers * stats["device_steps"] or \
            launches["flash_attention"] != layers * stats["prefill_waves"]:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{stats['device_steps']} decode steps / "
                             f"{stats['prefill_waves']} prefill waves")
    serve = {"requests": len(bodies), "completion_tokens": done,
             "wall_s": wall, "tokens_per_s": done / wall,
             "first_round_wall_s": cold_wall,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "prefill_waves": stats["prefill_waves"],
             "decode_steps": stats["device_steps"],
             "max_batch": 8, "cache_len": 2048, "dtype": "bfloat16",
             "profiled_round": profile}
    del engine
    torch.cuda.empty_cache()
    return launches, serve


def profile_round(torch, send_all):
    """One more round of the same mix under ``torch.profiler`` (device
    activity only), its responses checked like the other rounds': device
    time by kind over the round's wall time, i.e. where the serving time
    goes and how long the card sits idle.  The profiled round is slower
    than the counted one; only shares are read."""
    from torch.profiler import ProfilerActivity, profile
    kinds = {"decode_attention": ("decode_attention_kernel",),
             "flash_attention": ("flash_attention_kernel",),
             "gemm": ("gemm", "xmma", "cutlass", "nvjet"),
             "memcpy_memset": ("Memcpy", "Memset")}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = send_all()
    device_us = {k: 0.0 for k in (*kinds, "other")}
    for ev in prof.key_averages():
        kind = next((k for k, words in kinds.items()
                     if any(w in ev.key for w in words)), "other")
        device_us[kind] += ev.self_device_time_total
    busy = sum(device_us.values()) / 1e6
    if busy <= 0:
        log("  profiled round: not measured (no device time recorded)")
        return None
    out = {"wall_s": wall, "device_busy_share": busy / wall,
           **{f"{k}_share": v / 1e6 / wall for k, v in device_us.items()}}
    log("  profiled round: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


# --------------------------------------------------------------------------- #
# phase 5: times
# --------------------------------------------------------------------------- #
def time_ms(torch, fn, n_sets: int, cycles: int = 2) -> float:
    """Mean ms per call over ``cycles`` passes through all ``n_sets`` input
    copies (together larger than L2), after warm-up.  Every set is timed
    equally often, so the mean bound over the sets is the bound of the
    timed work."""
    for i in range(3):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(cycles * n_sets):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (cycles * n_sets)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(byts: float, flops: float) -> dict:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_kernels(torch, dec, fla):
    """Each kernel, its plain version and SDPA on the same rotating input
    sets; ``bound_ms`` is the mean over those sets of what each one's data
    needs: decode reads only the live K/V rows, flash only the keys below
    each row's ``kv_valid`` length, and both do 4·D FLOPs per head for each
    live (query, key) pair.  Q, the output and the masks count whole."""
    import torch.nn.functional as F
    dtype = torch.bfloat16
    out = {}

    # decode: q [8,14,64], K/V [8,2048,2,64], ragged lengths
    (q, k, v, _), _ = decode_case(torch, dtype)
    n_sets = max(2, 2 * L2_BYTES // nbytes(k, v) + 1)
    sets = [decode_case(torch, dtype, seed=i)[0] for i in range(n_sets)]
    b, h, d = q.shape
    hkv = k.shape[2]
    byts = flops = 0
    sdpa = []
    for sq, sk, sv, sval in sets:
        live = int(sval.sum())
        byts += nbytes(sq, sval, sq) + 2 * live * hkv * d * sk.element_size()
        flops += 4 * h * d * live
        sdpa.append((sq[:, :, None], sk.transpose(1, 2).contiguous(),
                     sv.transpose(1, 2).contiguous(), sval[:, None, None]))
    out["decode_attention"] = {
        "ms": time_ms(torch, lambda i: dec.decode_attention_cuda(*sets[i]),
                      n_sets),
        "plain_ms": time_ms(torch, lambda i: dec.decode_attention_plain(
            *sets[i]), n_sets, cycles=1),
        "library_ms": time_ms(torch, lambda i: F.scaled_dot_product_attention(
            sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
            enable_gqa=True), n_sets),
        **bound(byts / n_sets, flops / n_sets),
        "shape": f"B{b} S{k.shape[1]} H{h} Hkv{hkv} D{d} bf16, {n_sets} sets",
    }

    # flash, engine form: 8 rows x 512-token bucket over a 2048 cache
    (q, k, v), _ = flash_case(torch, dtype, "engine")
    n_sets = max(2, 2 * L2_BYTES // nbytes(q, k, v) + 1)
    sets = [flash_case(torch, dtype, "engine", seed=i) for i in range(n_sets)]
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    byts = flops = 0
    sdpa = []
    for (sq_, sk, sv), skw in sets:
        m = fla.live_mask(skw["q_positions"], skv, causal=True, window=0,
                          kv_valid=skw["kv_valid"])
        live_keys = int(skw["kv_valid"].sum())
        byts += (nbytes(sq_, sq_, skw["q_positions"], skw["kv_valid"])
                 + 2 * live_keys * hkv * d * sk.element_size())
        flops += 4 * h * d * int(m.sum())
        sdpa.append((sq_.transpose(1, 2).contiguous(),
                     sk.transpose(1, 2).contiguous(),
                     sv.transpose(1, 2).contiguous(), m[:, None]))
    out["flash_attention"] = {
        "ms": time_ms(torch, lambda i: fla.flash_attention_cuda(
            *sets[i][0], **sets[i][1]), n_sets),
        "plain_ms": time_ms(torch, lambda i: fla.flash_attention_plain(
            *sets[i][0], **sets[i][1]), n_sets, cycles=1),
        "library_ms": time_ms(torch, lambda i: F.scaled_dot_product_attention(
            sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
            enable_gqa=True), n_sets),
        **bound(byts / n_sets, flops / n_sets),
        "shape": (f"B{b} Sq{sq} Skv{skv} H{h} Hkv{hkv} D{d} bf16 (engine "
                  f"form), {n_sets} sets"),
    }
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.models.model import Model, init_cache
    from repro_torch.serving.api import OpenAIServer
    from repro_torch.serving.client import EngineClient
    from repro_torch.serving.server import ApiServer
    t_start = time.perf_counter()

    log("== 1. environment")
    card = smi()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"  nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    took = build.build()
    for name in build.KERNELS:
        build.load(name)
    log(f"  built {', '.join(f'{n} ({s:.1f} s)' for n, s in took.items())} "
        f"with nvcc {' '.join(build.NVCC_FLAGS[:2])} from "
        f"{build.CSRC.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")

    log("== 2. kernels against their plain versions")
    errs = check_kernels(torch, dec, fla)

    log("== 3. full-width model, float32, kernels vs plain versions")
    check_model(torch, ops, get_config, Model, init_cache)

    log("== 4. serving qwen2-0.5b (bf16) over HTTP")
    launches, serve = check_serving(
        torch, get_config, InferenceEngine, EngineClient, OpenAIServer,
        ApiServer, {"decode_attention": dec.decode_attention_cuda,
                    "flash_attention": fla.flash_attention_cuda})

    log("== 5. times at the serving shapes (CUDA events)")
    times = time_kernels(torch, dec, fla)
    kernels = []
    for name in ("decode_attention", "flash_attention"):
        t = times[name]
        log(f"  {name:17s} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) on {card}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    serve["card"] = card
    serve["smoke_s"] = time.perf_counter() - t_start
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"serve": serve}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
