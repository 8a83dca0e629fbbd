#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases (any failure exits non-zero and prints no result line):

1. environment — torch/CUDA versions, the card's name and power limit, the
   hand-written kernels built from ``src/repro_torch/csrc`` with nvcc for
   ``sm_90a`` (TF32 off for every float32 product);
2. kernels — each CUDA kernel against its plain PyTorch version at the
   serving path's shapes, in bf16 (atol 2e-2) and float32 (atol 1e-4); the
   paged kernel also over int8 pages with q in either dtype;
3. full-width model — ``qwen2-0.5b`` in float32 with seeded random weights:
   a resume-prefill and 8 decode steps through the kernels against the same
   model through the plain versions (max |Δlogit| <= 1e-3, argmax
   agreement), over the dense ring and over a paged arena, and the paged
   run against the dense one through the kernels;
4. serving — ``qwen2-0.5b`` in bf16 behind EngineClient + OpenAIServer +
   ApiServer on 127.0.0.1, with the prefix cache on: 12 concurrent chat /
   completion requests (one streamed, one chunked over 512 prompt tokens,
   one with logprobs) on the dense layout; the same 12 plus 6 chats sharing
   a ~600-token system prompt on the paged layout (fp pages), which must hit
   the prefix cache, share pages copy-on-write with zero full copies, leave
   no page pinned, and launch the paged kernel 24 times per decode step and
   the flash kernel 24 times per prefill wave (the dense decode kernel
   never); a short round on int8 pages.  Every finish_reason and usage is
   checked, and each round's launch counters are zeroed just before it and
   read just after;
5. times — each kernel, its plain version and one PyTorch library call
   where one computes the same function (SDPA with an explicit mask; none
   takes a page table, so the paged kernel's SDPA time is over a dense copy
   gathered beforehand, labelled as such) at the phase-2 serving shapes,
   with CUDA events over rotating input copies larger than the L2 cache,
   beside the least time the card could take (``bound_ms``).

The last lines are one ``{"kernels": [...]}`` JSON line, one ``serve`` JSON
line, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
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
    "paged_attention": "src/repro/kernels/paged_attention.py:86",
}
KERNEL_NAMES = tuple(REPLACES)
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


def paged_case(torch, dtype, *, int8=False, b=8, ps=16, p=128, h=14, hkv=2,
               d=64, seed=0):
    """The serving arena: ``reserved + b * p`` pages (reserved as the pool
    reserves them), ragged positions, rows 0 and 1 sharing their first four
    pages, row 2 wrapped, every entry past a row's pages at page 0."""
    from repro_torch.core.paged_kv import PagedKVPool
    from repro_torch.kernels.quant_matmul import quantize_kv_int8
    n = PagedKVPool.full_capacity(b, ps * p, ps)
    reserved = n - b * p
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    kw, kv = {}, []
    for name in ("k", "v"):
        x = torch.randn((n, ps, hkv, d), generator=g, device="cuda")
        if int8:
            x, kw[f"{name}_scale"] = quantize_kv_int8(x)
        kv.append(x if int8 else x.to(dtype))
    pos = torch.randint(4 * ps, p * ps, (b,), generator=g, device="cuda")
    pos[2] = p * ps + 37
    table = torch.zeros((b, p), dtype=torch.int32, device="cuda")
    perm = torch.randperm(b * p, generator=g, device="cuda") + reserved
    for row in range(b):
        live = p if row == 2 else int(pos[row]) // ps + 1
        table[row, :live] = perm[row * p:row * p + live].int()
    table[1, :4] = table[0, :4]
    return (q, kv[0], kv[1], table, pos.int()), kw


def max_err(torch, a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_kernels(torch, dec, fla, pag):
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        cases = [("decode_attention", "B8 S2048 G7", dec,
                  decode_case(torch, dtype)),
                 ("decode_attention", "B3 S1000 G7", dec,
                  decode_case(torch, dtype, b=3, s=1000))]
        cases += [("flash_attention", form, fla, flash_case(torch, dtype, form))
                  for form in ("engine", "causal_offset", "window", "ragged")]
        cases += [("paged_attention", "B8 ps16 P128", pag,
                   paged_case(torch, dtype)),
                  ("paged_attention", "int8 pages", pag,
                   paged_case(torch, dtype, int8=True, seed=1))]
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
    saved = ops.flash_attention, ops.decode_attention, ops.paged_attention
    ops.flash_attention = ops._flash_plain
    ops.decode_attention = ops._decode_plain
    ops.paged_attention = ops._paged_plain
    try:
        yield
    finally:
        (ops.flash_attention, ops.decode_attention,
         ops.paged_attention) = saved


def check_model(torch, ops, get_config, Model, init_cache, PagedKVPool,
                slice_cache_row):
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

    def run(feed, paged):
        """Prefill, then 8 decode steps fed ``feed`` (or, with None, the
        path's own greedy tokens, which are returned): over the dense ring,
        or (``paged``) with the prefilled rows committed to a 16-token-page
        arena and every decode step read through its page table."""
        cache = init_cache(cfg, b, cache_len, device="cuda")
        out = model.apply(params, tokens, mode="prefill", positions=positions,
                          cache=cache, resume=True, seq_valid=seq_valid)
        logits = [out.logits[torch.arange(b, device="cuda"), lengths - 1]]
        kw = {}
        if paged:
            pool = PagedKVPool(cfg, b, cache_len, page_size=16,
                               dtype=torch.float32, device="cuda")
            slots = [pool.allocate() for _ in range(b)]
            pool.insert_many(slots, [slice_cache_row(cache, i)
                                     for i in range(b)],
                             consumed=lengths.tolist())
            cache = pool.cache
            kw = dict(page_table=cache["page_table"],
                      slot_active=torch.ones(b, dtype=torch.bool,
                                             device="cuda"))
        toks, pos = [], lengths.clone()
        for step in range(8):
            tok = logits[-1].argmax(-1) if feed is None else feed[step]
            toks.append(tok)
            if paged:
                assert pool.ensure_decode_capacity(
                    dict(zip(slots, pos.tolist())), 1)
            out = model.apply(params, tok[:, None], mode="decode",
                              positions=pos[:, None], cache=cache, **kw)
            logits.append(out.logits[:, 0])
            pos = pos + 1
        return torch.stack(logits), toks

    def compare(what, got, want, tol=1e-3):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite logits")
        err = max_err(torch, got, want)
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"  {what}: max|Δlogit| {err:.3e} (tol {tol:g}), argmax "
            f"agreement {agree:.3f}, logit scale "
            f"{got.abs().max().item():.3e}")
        if err > tol or agree < 1.0:
            raise AssertionError(f"{what} disagrees: {err}, {agree}")

    log(f"  qwen2-0.5b float32, {cfg.num_layers} layers: prefill {b}x{s} + "
        f"8 decode steps")
    with torch.no_grad():
        kern, fed = run(None, paged=False)
        paged, _ = run(fed, paged=True)
        with plain_attention(ops):
            plain, _ = run(fed, paged=False)
            paged_plain, _ = run(fed, paged=True)
    torch.cuda.synchronize()
    compare("dense, kernels vs plain", kern, plain)
    compare("paged, kernels vs plain", paged, paged_plain)
    compare("paged vs dense, both through the kernels", paged, kern)
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


def shared_prompt_chats():
    """6 chats behind one ~600-token system prompt (the prefix cache's and
    the copy-on-write pages' case)."""
    system = "You are a careful assistant for a parts catalogue. " * 12
    return [("chat", {"messages": [{"role": "system", "content": system},
                                   {"role": "user",
                                    "content": f"part number {i}?"}],
                      "max_tokens": 10 + 2 * i}) for i in range(6)]


def check_serving(torch, get_config, InferenceEngine, EngineClient,
                  OpenAIServer, ApiServer, wrappers, *, bodies, rounds=2,
                  profile=True, **engine_kw):
    """Serve ``bodies`` ``rounds`` times (the first takes the first-call
    costs; the last is the counted one) and once more under the profiler.
    ``wrappers`` maps each kernel's name to its CUDA wrapper, whose
    ``launches`` count is zeroed just before the counted round and read
    just after.  Returns (launches, serve record, /stats after the counted
    round, engine layers)."""
    engine = InferenceEngine(get_config("qwen2-0.5b"), device="cuda",
                             max_batch=8, cache_len=2048, prefill_chunk=512,
                             seed=0, **engine_kw)
    client = EngineClient(engine)
    server = ApiServer(OpenAIServer(client, "qwen2-0.5b"), host="127.0.0.1",
                       port=0)
    server.start()
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
        # earlier rounds of the same mix take the first-call costs (kernel
        # loading, GEMM heuristics per shape); the last is the one counted
        cold_wall = None
        for _ in range(rounds - 1):
            _, cold_wall = send_all()
        torch.cuda.reset_peak_memory_stats()
        before = server.api.stats()
        for w in wrappers.values():
            w.launches = 0
        done, wall = send_all()
        launches = {name: w.launches for name, w in wrappers.items()}
        after = server.api.stats()
        prof = profile_round(torch, send_all) if profile else None
    finally:
        server.stop()
        client.stop()
    stats = {k: after[k] - before[k] for k in
             ("retired", "aborted", "prefill_waves", "device_steps")}
    if stats["retired"] != len(bodies) or stats["aborted"]:
        raise AssertionError(f"engine counters disagree: {stats}")
    layers = engine.cfg.num_layers
    log(f"  {len(bodies)} requests finished with correct usage: {done} "
        f"completion tokens in {wall:.3f} s (first round {cold_wall} s), "
        f"{stats['prefill_waves']} prefill waves, "
        f"{stats['device_steps']} decode steps, launches {launches} "
        f"({layers} per decode step / prefill wave)")
    serve = {"requests": len(bodies), "completion_tokens": done,
             "wall_s": wall, "tokens_per_s": done / wall,
             "first_round_wall_s": cold_wall,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "prefill_waves": stats["prefill_waves"],
             "decode_steps": stats["device_steps"], "launches": launches,
             "max_batch": 8, "cache_len": 2048, "dtype": "bfloat16",
             **engine_kw, "profiled_round": prof}
    # the engine and the client refer to each other: collect the cycle so
    # the next round's peak memory holds its own engine only
    del engine, client, server
    gc.collect()
    torch.cuda.empty_cache()
    return launches, serve, after, layers


def require_launches(launches, serve, layers, *, decode_kernel, unused):
    """The counted round's launches: ``decode_kernel`` once per layer per
    decode step, ``flash_attention`` once per layer per prefill wave, and
    ``unused`` never."""
    want = {decode_kernel: layers * serve["decode_steps"],
            "flash_attention": layers * serve["prefill_waves"], unused: 0}
    if any(launches[name] != n for name, n in want.items()) or \
            not launches[decode_kernel] or not launches["flash_attention"]:
        raise AssertionError(f"launch counts {launches}, want {want}")


def check_paged_serving(stats):
    """/stats after a paged round: prefix-cache hits, pages shared
    copy-on-write, no full copy, and no page pinned once every request
    retired."""
    pages, cache = stats["kv_pages"], stats["prefix_cache"]
    log(f"  prefix cache {cache}; kv pages {pages}")
    if cache["hits"] <= 0 or pages["shares"] <= 0 or pages["full_copies"] \
            or pages["pinned"] or \
            pages["free"] + pages["reclaimable"] != pages["total"]:
        raise AssertionError(f"paged round: prefix cache {cache}, pages "
                             f"{pages}")


def profile_round(torch, send_all):
    """One more round of the same mix under ``torch.profiler`` (device
    activity only), its responses checked like the other rounds': device
    time by kind over the round's wall time, i.e. where the serving time
    goes and how long the card sits idle.  The profiled round is slower
    than the counted one; only shares are read."""
    from torch.profiler import ProfilerActivity, profile
    kinds = {"decode_attention": ("decode_attention_kernel",),
             "flash_attention": ("flash_attention_kernel",),
             "paged_attention": ("paged_attention_kernel",),
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
        raise RuntimeError("the profiled round recorded no device time")
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


def time_kernels(torch, dec, fla, pag):
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
    out["paged_attention"] = time_paged(torch, pag, F)
    return out


def time_paged(torch, pag, F):
    """The paged kernel at the serving arena (bf16 pages; int8 pages as an
    extra column).  ``bound_ms`` counts each row's live cells only (K and V
    rows, plus their 4-byte scales for int8), the live page-table entries,
    positions, q and the output.  No PyTorch call takes a page table, so
    ``library_ms`` is null; SDPA over a dense copy gathered beforehand (the
    gather untimed) is recorded beside it, labelled as such."""
    def live_cells(table, pos, ps):
        total = table.shape[1] * ps
        return [total if int(x) >= total else int(x) + 1 for x in pos]

    def sets_of(int8):
        args, kw = paged_case(torch, torch.bfloat16, int8=int8)
        per = nbytes(args[1], args[2], *kw.values())
        n_sets = max(2, 2 * L2_BYTES // per + 1)
        return [paged_case(torch, torch.bfloat16, int8=int8, seed=i)
                for i in range(n_sets)]

    def bound_of(sets):
        byts = flops = 0
        for (q, k, v, table, pos), kw in sets:
            ps, hkv, d = k.shape[1:]
            cells = live_cells(table, pos, ps)
            per_cell = 2 * hkv * (d * k.element_size()
                                  + (4 if kw else 0))
            byts += (2 * nbytes(q) + nbytes(pos)
                     + 4 * sum(-(-c // ps) for c in cells)
                     + per_cell * sum(cells))
            flops += 4 * q.shape[1] * d * sum(cells)
        return bound(byts / len(sets), flops / len(sets))

    sets = sets_of(False)
    n_sets = len(sets)
    sdpa = []
    for (q, k, v, table, pos), _ in sets:
        s = table.shape[1] * k.shape[1]
        valid = torch.arange(s, device="cuda")[None] <= pos.long()[:, None]
        valid |= pos.long()[:, None] >= s
        gk = k[table.long()].reshape(q.shape[0], s, *k.shape[2:])
        gv = v[table.long()].reshape(q.shape[0], s, *v.shape[2:])
        sdpa.append((q[:, :, None], gk.transpose(1, 2).contiguous(),
                     gv.transpose(1, 2).contiguous(), valid[:, None, None]))
    out = {
        "ms": time_ms(torch, lambda i: pag.paged_attention_cuda(
            *sets[i][0], **sets[i][1]), n_sets),
        "plain_ms": time_ms(torch, lambda i: pag.paged_attention_plain(
            *sets[i][0], **sets[i][1]), n_sets, cycles=1),
        "library_ms": None,
        "sdpa_on_gathered_dense_copy_ms": time_ms(
            torch, lambda i: F.scaled_dot_product_attention(
                sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
                enable_gqa=True), n_sets),
        **bound_of(sets),
    }
    del sdpa
    int8_sets = sets_of(True)
    out["int8_pages_ms"] = time_ms(torch, lambda i: pag.paged_attention_cuda(
        *int8_sets[i][0], **int8_sets[i][1]), len(int8_sets))
    out["int8_pages_bound_ms"] = bound_of(int8_sets)["bound_ms"]
    q, k = sets[0][0][0], sets[0][0][1]
    out["shape"] = (f"B{q.shape[0]} ps{k.shape[1]} P{sets[0][0][3].shape[1]} "
                    f"N{k.shape[0]} H{q.shape[1]} Hkv{k.shape[2]} "
                    f"D{k.shape[3]} bf16 pages, {n_sets} sets")
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
    from repro_torch.kernels import paged_attention as pag
    from repro_torch.core.kv_cache import slice_cache_row
    from repro_torch.core.paged_kv import PagedKVPool
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
    errs = check_kernels(torch, dec, fla, pag)

    log("== 3. full-width model, float32, kernels vs plain versions")
    check_model(torch, ops, get_config, Model, init_cache, PagedKVPool,
                slice_cache_row)

    wrappers = {"decode_attention": dec.decode_attention_cuda,
                "flash_attention": fla.flash_attention_cuda,
                "paged_attention": pag.paged_attention_cuda}
    serving = (torch, get_config, InferenceEngine, EngineClient, OpenAIServer,
               ApiServer, wrappers)
    log("== 4a. serving qwen2-0.5b (bf16) over HTTP, dense KV")
    dense_launches, dense, _, layers = check_serving(
        *serving, bodies=serve_requests())
    require_launches(dense_launches, dense, layers,
                     decode_kernel="decode_attention",
                     unused="paged_attention")
    log("== 4b. serving over HTTP, paged KV (fp pages, 16-token pages)")
    paged_launches, paged, stats, _ = check_serving(
        *serving, bodies=serve_requests() + shared_prompt_chats(),
        kv_layout="paged", kv_page_size=16)
    require_launches(paged_launches, paged, layers,
                     decode_kernel="paged_attention",
                     unused="decode_attention")
    check_paged_serving(stats)
    paged["kv_pages"], paged["prefix_cache"] = (stats["kv_pages"],
                                                stats["prefix_cache"])
    log("== 4c. serving over HTTP, paged KV (int8 pages), one round")
    int8_launches, int8_round, _, _ = check_serving(
        *serving, bodies=serve_requests()[:6], rounds=1, profile=False,
        kv_layout="paged", kv_dtype="int8")
    require_launches(int8_launches, int8_round, layers,
                     decode_kernel="paged_attention",
                     unused="decode_attention")
    # each kernel's launches in the counted round of its own path
    launches = {"decode_attention": dense_launches["decode_attention"],
                "flash_attention": paged_launches["flash_attention"],
                "paged_attention": paged_launches["paged_attention"]}

    log("== 5. times at the serving shapes (CUDA events)")
    times = time_kernels(torch, dec, fla, pag)
    kernels = []
    for name in KERNEL_NAMES:
        t = times[name]
        lib = ("none (SDPA on a gathered dense copy "
               f"{t['sdpa_on_gathered_dense_copy_ms']:.4f} ms)"
               if t["library_ms"] is None else f"{t['library_ms']:.4f} ms")
        log(f"  {name:17s} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, SDPA {lib}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) on {card}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: v for k, v in t.items()
               if k.startswith(("sdpa_on", "int8_pages"))}})
    serve = {"dense": dense, "paged": paged, "paged_int8": int8_round,
             "card": card, "smoke_s": time.perf_counter() - t_start}
    print(json.dumps({"serve": serve}))
    print(json.dumps({"kernels": kernels, "card": card}))
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
