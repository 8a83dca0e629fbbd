#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases (any failure exits non-zero and prints no result line):

1. environment — torch/CUDA versions, the card's name and power limit, the
   hand-written kernels built from ``src/repro_torch/csrc`` with nvcc for
   ``sm_90a`` (TF32 off for every float32 product);
2. kernels — each CUDA kernel against its plain PyTorch version at the
   serving paths' shapes, in bf16 (atol 2e-2) and float32 (atol 1e-4); the
   paged kernel also over int8 pages with q in either dtype; flash
   non-causal and decode at the cross-attention shape of
   ``llama-3.2-vision-90b`` (D 128, G 8, a 2304-slot context);
   ``quant_matmul`` at that model's MLP shapes (M 8 and 512) and a ragged
   one, relative to the largest output (bf16 1e-2, float32 1e-4);
3. full-width model — ``qwen2-0.5b`` in float32 with seeded random weights:
   a resume-prefill and 8 decode steps through the kernels against the same
   model through the plain versions (max |Δlogit| <= 1e-3, argmax
   agreement), over the dense ring and over a paged arena, and the paged
   run against the dense one through the kernels; then
   ``llama-3.2-vision-90b`` at published widths and 5 layers (4 self-attn +
   1 gated cross-attn, gates set to 0.5) in float32 with images: prefill,
   the same prefill with the cross KV injected (content-cache hit), 8
   decode steps, kernels against plain (the same limits), fresh against
   cross-cached logits, and a different image moving the logits;
4. serving — ``qwen2-0.5b`` in bf16 behind EngineClient + OpenAIServer +
   ApiServer on 127.0.0.1, with the prefix cache on: 12 concurrent chat /
   completion requests (one streamed, one chunked over 512 prompt tokens,
   one with logprobs) on the dense layout; the same 12 plus 6 chats sharing
   a ~600-token system prompt on the paged layout (fp pages), which must hit
   the prefix cache, share pages copy-on-write with zero full copies, leave
   no page pinned, and launch the paged kernel 24 times per decode step and
   the flash kernel 24 times per prefill wave (the dense decode kernel
   never); a short round on int8 pages;
   4d/4e — ``llama-3.2-vision-90b`` at 10 layers (2 x (4 self-attn + 1
   cross-attn)), bf16, gates 0.5, over HTTP with image parts (data URLs and
   registered synthetic URLs): 8 concurrent requests with one new image
   cost exactly one encoder invocation; a cold request and its warm repeat
   (embedding and cross-KV hit) give identical tokens; a new image misses;
   on the dense ring (4d) and on the paged arena (4e, cross-KV page leases,
   tokens equal to 4d's); 4f — ``ops.quant_matmul``, the int8 kernel's
   entry point (no model calls it), as a SwiGLU MLP of that model's widths
   on int8 weights at decode and prefill rows.  Every finish_reason and
   usage is checked, and each round's launch counters are zeroed just
   before it and read just after;
5. times — each kernel, its plain version and one PyTorch library call
   where one computes the same function (SDPA with an explicit mask; none
   takes a page table, so the paged kernel's SDPA time is over a dense copy
   gathered beforehand, labelled as such) at the phase-2 serving shapes,
   with CUDA events over rotating input copies larger than the L2 cache,
   beside the least time the card could take (``bound_ms``).

Phase 1 also prints ``ptxas``'s registers and spills for every compiled
kernel instantiation.  The last lines are one ``serve`` JSON line, one
``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
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
import types
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
    "quant_matmul": "src/repro/kernels/quant_matmul.py:42",
}
# quant_matmul outputs grow with K: held relative to the largest output
QMM_REL = {"bfloat16": 1e-2, "float32": 1e-4}
VISION = "llama-3.2-vision-90b"
CROSS = dict(b=8, ctx=2304, h=64, hkv=8, d=128)      # 576 tokens x 4 images
MLP_SHAPES = ((8192, 28672), (28672, 8192))           # (K, N) of up / down
GATE = 0.5
KERNEL_NAMES = tuple(REPLACES)
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(build) -> list:
    """(kernel<template args>, registers, spill store bytes, spill load
    bytes) of every compiled instantiation, from the ``-Xptxas -v`` output
    the build keeps in ``build/<name>.log``."""
    import re
    names = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "i8", "h": "u8"}
    out = []
    for name in build.KERNELS:
        text = (build.BUILD / f"{name}.log").read_text()
        entries = re.split(r"Compiling entry function '", text)[1:]
        for entry in entries:
            m = re.search(r"\d+([a-z_]+_kernel)I(\w+?)EEvP", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            if not (m and regs and spill):
                continue
            tokens = re.finditer(r"13__nv_bfloat16|Li(\d+)E|[fah]",
                                 m.group(2))
            targs = [t.group(1) or names[t.group(0)] for t in tokens]
            out.append((f"{m.group(1)}<{','.join(targs)}>",
                        int(regs.group(1)), int(spill.group(1)),
                        int(spill.group(2))))
    return out


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
    kernel's own modes; ``ragged``: Skv = 1000; ``cross``: the vision
    model's cross-attention prefill, non-causal, 8 rows x 64-token bucket
    over the 2304-slot context, each row's first 1-4 images live."""
    b, sq, skv, h, hkv, d = {"engine": (8, 512, 2048, 14, 2, 64),
                             "causal_offset": (2, 512, 2048, 14, 2, 64),
                             "window": (2, 512, 512, 14, 2, 64),
                             "ragged": (3, 200, 1000, 14, 2, 64),
                             "cross": (CROSS["b"], 64, CROSS["ctx"],
                                       CROSS["h"], CROSS["hkv"],
                                       CROSS["d"])}[form]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    kw = {"causal": form != "cross"}
    if form == "cross":
        kw["kv_valid"] = cross_valid(torch, g, b, skv)
    elif form == "engine":
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


def cross_valid(torch, g, b, ctx):
    """[b, ctx] context liveness: each row's first 1-4 images (576 slots
    each) live, as the engine packs them."""
    n = torch.randint(1, 5, (b,), generator=g, device="cuda")
    n[0] = 4
    return torch.arange(ctx, device="cuda")[None] < (n * (ctx // 4))[:, None]


def cross_decode_case(torch, dtype, *, seed=0):
    """Cross-attention decode: q [8, 64, 128] over xk/xv [8, 2304, 8, 128]
    with the rows' context liveness."""
    c = CROSS
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((c["b"], c["h"], c["d"]), generator=g,
                    device="cuda").to(dtype)
    k, v = (torch.randn((c["b"], c["ctx"], c["hkv"], c["d"]), generator=g,
                        device="cuda").to(dtype) for _ in range(2))
    return (q, k, v, cross_valid(torch, g, c["b"], c["ctx"])), {}


def qmm_case(torch, qm, dtype, m, k, n, *, seed=0):
    """x [m, k] against int8 weights [k, n] with per-column scales, the
    weights quantised from N(0, 0.02) as a checkpoint's would be."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w_q, scales = qm.quantize_int8(
        torch.randn((k, n), generator=g, device="cuda") * 0.02)
    return (x, w_q, scales), {}


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
def check_kernels(torch, dec, fla, pag, qm):
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        cases = [("decode_attention", "B8 S2048 G7", dec,
                  decode_case(torch, dtype)),
                 ("decode_attention", "B3 S1000 G7", dec,
                  decode_case(torch, dtype, b=3, s=1000)),
                 ("decode_attention", "cross D128 G8", dec,
                  cross_decode_case(torch, dtype))]
        cases += [("flash_attention", form, fla, flash_case(torch, dtype, form))
                  for form in ("engine", "causal_offset", "window", "ragged",
                               "cross")]
        cases += [("paged_attention", "B8 ps16 P128", pag,
                   paged_case(torch, dtype)),
                  ("paged_attention", "int8 pages", pag,
                   paged_case(torch, dtype, int8=True, seed=1))]
        cases += [("quant_matmul", f"{m}x{k}x{n}", qm,
                   qmm_case(torch, qm, dtype, m, k, n))
                  for m in (8, 512) for k, n in MLP_SHAPES]
        cases += [("quant_matmul", "77x1000x1000", qm,
                   qmm_case(torch, qm, dtype, 77, 1000, 1000))]
        for name, what, mod, (args, kw) in cases:
            kern = getattr(mod, f"{name}_cuda")
            plain = getattr(mod, f"{name}_plain")
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            err = max_err(torch, got, want)
            if name == "quant_matmul":
                rel = err / want.float().abs().max().item()
                ok, tol, shown = rel <= QMM_REL[dname], QMM_REL[dname], rel
                label = "max|kernel-plain|/max|plain|"
            else:
                ok, tol, shown = err <= TOL[dname], TOL[dname], err
                label = "max|kernel-plain|"
            ok = ok and bool(torch.isfinite(got).all())
            log(f"  {name:17s} {dname:8s} {what:16s} {label} {shown:.3e} "
                f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {dname} {what}: error {shown}")
            if dname == "bfloat16":
                errs[name] = max(errs.get(name, 0.0), err)
            del got, want
        del cases
        torch.cuda.empty_cache()
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

    log(f"  qwen2-0.5b float32, {cfg.num_layers} layers: prefill {b}x{s} + "
        f"8 decode steps")
    with torch.no_grad():
        kern, fed = run(None, paged=False)
        paged, _ = run(fed, paged=True)
        with plain_attention(ops):
            plain, _ = run(fed, paged=False)
            paged_plain, _ = run(fed, paged=True)
    torch.cuda.synchronize()
    compare(torch, "dense, kernels vs plain", kern, plain)
    compare(torch, "paged, kernels vs plain", paged, paged_plain)
    compare(torch, "paged vs dense, both through the kernels", paged, kern)
    del params
    torch.cuda.empty_cache()


def vision_config(get_config, layers, dtype):
    """``llama-3.2-vision-90b`` at published widths, depth cut to ``layers``
    (one gated cross-attention layer per 5)."""
    return dataclasses.replace(get_config(VISION), num_layers=layers,
                               dtype=dtype)


def open_gates(torch, params):
    """Set every cross-attention gate to GATE (the reference initialises
    them to 0, which makes an ``xattn`` layer an identity and the image
    invisible to the logits)."""
    subs = list(params["prefix_layers"]) + list(params["block"].values())
    gated = [sub for sub in subs if "cross" in sub]
    for sub in gated:
        sub["xgate_ffn"].fill_(GATE)
        sub["cross"]["xgate_attn"].fill_(GATE)
    if not gated:
        raise AssertionError("no cross-attention layer to gate")


def image_moves_logits(torch, model, params, init_cache, ctx_len, what):
    """Two prefills of the same tokens with different image embeddings must
    give different logits (the gates let the image through)."""
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=g,
                         device="cuda")
    valid = torch.ones((1, ctx_len), dtype=torch.bool, device="cuda")
    outs = []
    for _ in range(2):
        emb = torch.rand((1, ctx_len, cfg.vision.embed_dim), generator=g,
                         device="cuda") * 2 - 1
        cache = init_cache(cfg, 1, 16, ctx_len=ctx_len, device="cuda")
        outs.append(model.apply(params, toks, mode="prefill", cache=cache,
                                image_embeds=emb, ctx_valid=valid,
                                logits_mode="last").logits.float())
    moved = (outs[0] - outs[1]).abs().max().item()
    log(f"  {what}: another image moves the last logits by {moved:.3e}")
    if not moved > 1e-3:
        raise AssertionError(f"{what}: the image does not reach the logits")


def check_vision_model(torch, ops, get_config, Model, init_cache):
    """5 layers of llama-3.2-vision-90b (4 self-attn + 1 cross-attn) in
    float32 with images: prefill, the same prefill with the cross KV
    injected (``cross_cached``), 8 decode steps; kernels vs plain."""
    cfg = vision_config(get_config, 5, "float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    open_gates(torch, params)
    b, s, cache_len, ctx = 2, 300, 512, CROSS["ctx"]
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device="cuda")
    lengths = torch.tensor([s, 257], device="cuda")
    seq_valid = torch.arange(s, device="cuda")[None] < lengths[:, None]
    positions = torch.arange(s, device="cuda")[None].expand(b, s)
    embeds = torch.rand((b, ctx, cfg.vision.embed_dim), generator=g,
                        device="cuda") * 2 - 1
    ctx_valid = torch.arange(ctx, device="cuda")[None] < torch.tensor(
        [[ctx], [ctx // 4]], device="cuda")
    rows = torch.arange(b, device="cuda")

    def prefill(cache, **kw):
        out = model.apply(params, tokens, mode="prefill", positions=positions,
                          cache=cache, resume=True, seq_valid=seq_valid,
                          ctx_valid=ctx_valid, **kw)
        return out.logits[rows, lengths - 1]

    def run(feed):
        """Fresh prefill, cross-cached prefill, then 8 decode steps fed
        ``feed`` (or the path's own greedy tokens)."""
        fresh = init_cache(cfg, b, cache_len, ctx_len=ctx, device="cuda")
        logits = [prefill(fresh, image_embeds=embeds)]
        hit = init_cache(cfg, b, cache_len, ctx_len=ctx, device="cuda")
        for dst, src in zip(
                hit["prefix"] + list((hit["block"] or {}).values()),
                fresh["prefix"] + list((fresh["block"] or {}).values())):
            for name in ("xk", "xv"):
                if name in dst:
                    dst[name].copy_(src[name])
        cached = prefill(hit, cross_cached=True)
        toks, pos = [], lengths.clone()
        for step in range(8):
            tok = logits[-1].argmax(-1) if feed is None else feed[step]
            toks.append(tok)
            out = model.apply(params, tok[:, None], mode="decode",
                              positions=pos[:, None], cache=fresh,
                              ctx_valid=ctx_valid)
            logits.append(out.logits[:, 0])
            pos = pos + 1
        return torch.stack(logits), cached, toks

    log(f"  {VISION} float32, {cfg.num_layers} layers "
        f"{''.join('x' if k == 'xattn' else 'a' for k in cfg.layer_kinds())}"
        f" (published widths, depth cut), gates {GATE}: prefill {b}x{s} "
        f"over a {ctx}-slot context, cross-cached prefill, 8 decode steps")
    with torch.no_grad():
        kern, kern_cached, fed = run(None)
        with plain_attention(ops):
            plain, plain_cached, _ = run(fed)
        image_moves_logits(torch, model, params, init_cache, ctx,
                           "5-layer float32")
    torch.cuda.synchronize()
    compare(torch, "vision, kernels vs plain", kern, plain)
    compare(torch, "vision cross-cached prefill, kernels vs plain",
            kern_cached, plain_cached)
    same = max_err(torch, kern_cached, kern[0])
    log(f"  fresh vs cross-cached prefill logits through the kernels: "
        f"max|Δ| {same:.3e}")
    if same > 1e-6:
        raise AssertionError(f"cross-cached prefill differs: {same}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def compare(torch, what, got, want, tol=1e-3):
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite logits")
    err = max_err(torch, got, want)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"  {what}: max|Δlogit| {err:.3e} (tol {tol:g}), argmax "
        f"agreement {agree:.3f}, logit scale "
        f"{got.abs().max().item():.3e}")
    if err > tol or agree < 1.0:
        raise AssertionError(f"{what} disagrees: {err}, {agree}")


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


# --------------------------------------------------------------------------- #
# phase 4d/4e: vision serving with the content cache
# --------------------------------------------------------------------------- #
def image_urls(media, seed, side=32):
    """One seeded 32x32 RGB image as (data URL, registered synthetic URL):
    two transports of the same pixels, so one content hash."""
    import numpy as np
    pixels = np.random.default_rng(seed).integers(0, 256, (side, side, 3),
                                                  dtype=np.uint8)
    url = f"synthetic://chip-smoke-{seed}"
    media.register_url(url, pixels)
    return ("data:application/octet-stream;base64,"
            + media.encode_b64(pixels)["base64"], url)


def media_body(text, urls, max_tokens=12, **extra):
    return {"messages": [{"role": "user", "content": (
        [{"type": "text", "text": text}]
        + [{"type": "image_url", "image_url": {"url": u}} for u in urls])}],
        "max_tokens": max_tokens, **extra}


def check_media_response(body, resp, tok) -> int:
    """finish_reason and usage of one blocking media chat response."""
    text = "".join(p["text"] for p in body["messages"][0]["content"]
                   if p["type"] == "text")
    want_prompt = len(tok.encode(f"<|user|>{text}<|assistant|>"))
    usage, choice = resp["usage"], resp["choices"][0]
    n = usage["completion_tokens"]
    if not (choice["finish_reason"] in ("stop", "length")
            and usage["prompt_tokens"] == want_prompt
            and usage["total_tokens"] == want_prompt + n
            and 1 <= n <= body["max_tokens"]
            and isinstance(choice["message"]["content"], str)):
        raise AssertionError(f"bad media response: {resp}")
    return n


def stream_chat(port, body):
    """One streamed chat with logprobs: (seconds to the first token chunk,
    each token's bytes, text, usage)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", body=json.dumps(
        {**body, "stream": True, "logprobs": True,
         "stream_options": {"include_usage": True}}).encode(),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    ttft, toks, text, usage = None, [], "", None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.decode().strip()
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = json.loads(line[len("data: "):])
        if chunk.get("usage"):
            usage = chunk["usage"]
        for c in chunk["choices"]:
            lp = c.get("logprobs")
            if lp and lp["content"]:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.extend(e["bytes"] for e in lp["content"])
            text += c["delta"].get("content", "")
    conn.close()
    if ttft is None or usage is None or \
            usage["completion_tokens"] != len(toks):
        raise AssertionError(f"bad stream: {len(toks)} tokens, {usage}")
    return ttft, toks, text, usage


def check_media_serving(torch, ns, wrappers, *, layout, want_tokens=None,
                        profile=False):
    """Serve the 10-layer vision model over HTTP (``layout`` dense or
    paged): 8 concurrent requests with one new image beside a long
    request, a cold request and its warm repeat streamed one at a time,
    and a new image.  Returns (launches, record, the cold request's
    tokens)."""
    cfg = vision_config(ns.get_config, 10, "bfloat16")
    engine = ns.InferenceEngine(cfg, device="cuda", max_batch=8,
                                cache_len=2048, prefill_chunk=512, seed=0,
                                kv_layout=layout)
    open_gates(torch, engine.params)
    with torch.no_grad():
        image_moves_logits(torch, engine.model, engine.params, ns.init_cache,
                           engine.ctx_len, f"10-layer bf16 ({layout})")
    client = ns.EngineClient(engine)
    server = ns.ApiServer(ns.OpenAIServer(client, VISION), host="127.0.0.1",
                          port=0)
    server.start()
    tok = engine.tokenizer
    media = ns.media

    def send(bodies):
        results = [None] * len(bodies)

        def one(i):
            try:
                results[i] = post(server.port, "/v1/chat/completions",
                                  bodies[i])
            except Exception as e:            # reported below, per request
                results[i] = e

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        done = 0
        for body, resp in zip(bodies, results):
            if resp is None or isinstance(resp, Exception):
                raise AssertionError(f"media request failed: {resp!r}")
            done += check_media_response(body, resp, tok)
        return done

    def cc():
        return server.api.stats()["content_cache"]

    def delta(before, after, *keys):
        return {k: after[k] - before[k] for k in keys}

    try:
        # first-call costs (kernel loading, GEMM heuristics) on a throwaway
        # image; counters are zeroed after it
        send([media_body("warm up", [image_urls(media, 100)[1]])])
        torch.cuda.reset_peak_memory_stats()
        before_all = server.api.stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        # (a) 8 concurrent requests, one image never seen, two transports,
        # sent while a long request keeps the engine loop inside its steps,
        # so that most of them arrive within one step and join the first
        # one's encode in flight (singleflight) rather than hit its cached
        # embedding a step later
        busy_body = media_body("keep decoding", [image_urls(media, 100)[1]],
                               max_tokens=64)
        busy = {}
        busy_thread = threading.Thread(target=lambda: busy.update(
            resp=post(server.port, "/v1/chat/completions", busy_body)))
        busy_thread.start()
        time.sleep(0.5)
        data_url, syn_url = image_urls(media, 101)
        c0 = cc()
        tokens = send([media_body(f"viral picture {i}",
                                  [data_url if i % 2 else syn_url])
                       for i in range(8)])
        d = delta(c0, cc(), "encoder_invocations", "dedup_joins",
                  "embed_hits")
        busy_thread.join(timeout=600)
        if "resp" not in busy:
            raise AssertionError("the long request did not finish")
        tokens += check_media_response(busy_body, busy["resp"], tok)
        log(f"  8 concurrent requests with one new image: {d}")
        if d["encoder_invocations"] != 1 or \
                d["dedup_joins"] + d["embed_hits"] != 7:
            raise AssertionError(f"singleflight/dedup broken: {d}")
        # (b) a cold request, then the same image again (embedding hit +
        # cross-KV hit), one at a time so both run in waves of one shape
        cold_body = media_body("describe the picture",
                               [image_urls(media, 102)[0]], max_tokens=16)
        c1 = cc()
        cold_ttft, cold_toks, cold_text, _ = stream_chat(server.port,
                                                         cold_body)
        c2 = cc()
        warm_ttft, warm_toks, warm_text, _ = stream_chat(server.port,
                                                         cold_body)
        c3 = cc()
        cold_d = delta(c1, c2, "embed_misses", "xkv_misses")
        warm_d = delta(c2, c3, "embed_hits", "xkv_hits",
                       "encoder_invocations")
        log(f"  cold request {cold_d}, TTFT {cold_ttft:.4f} s; warm repeat "
            f"{warm_d}, TTFT {warm_ttft:.4f} s; {len(cold_toks)} tokens, "
            f"identical: {warm_toks == cold_toks}")
        if warm_toks != cold_toks or warm_text != cold_text or \
                warm_d != {"embed_hits": 1, "xkv_hits": 1,
                           "encoder_invocations": 0} or \
                cold_d != {"embed_misses": 1, "xkv_misses": 1}:
            raise AssertionError(f"warm repeat: {warm_d}, cold {cold_d}, "
                                 f"tokens equal {warm_toks == cold_toks}")
        if want_tokens is not None and cold_toks != want_tokens:
            raise AssertionError("the paged round's tokens differ from the "
                                 "dense round's")
        tokens += 2 * len(cold_toks)
        # (c) a distinct image is a miss
        c4 = cc()
        tokens += send([media_body("another picture",
                                   [image_urls(media, 103)[1]])])
        miss = delta(c4, cc(), "encoder_invocations", "embed_misses",
                     "xkv_misses")
        if miss != {"encoder_invocations": 1, "embed_misses": 1,
                    "xkv_misses": 1}:
            raise AssertionError(f"a new image did not miss: {miss}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        after = server.api.stats()

        def profiled():
            """8 more requests with one more new image (encoder included),
            for the device-time breakdown of a media round."""
            url = image_urls(media, 104)[0]
            t = time.perf_counter()
            done = send([media_body(f"profiled {i}", [url])
                         for i in range(8)])
            torch.cuda.synchronize()
            return done, time.perf_counter() - t

        prof = profile_round(torch, profiled) if profile else None
    finally:
        server.stop()
        client.stop()
    steps = after["device_steps"] - before_all["device_steps"]
    waves = after["prefill_waves"] - before_all["prefill_waves"]
    kinds = cfg.layer_kinds()
    n_self, n_cross = kinds.count("attn"), kinds.count("xattn")
    want = {"flash_attention": (n_self + n_cross) * waves,
            "quant_matmul": 0}
    if layout == "paged":
        want.update(paged_attention=n_self * steps,
                    decode_attention=n_cross * steps)
    else:
        want.update(paged_attention=0,
                    decode_attention=(n_self + n_cross) * steps)
    log(f"  {layout}: 12 media requests, {tokens} completion tokens in "
        f"{wall:.3f} s, {waves} prefill waves, {steps} decode steps, "
        f"launches {launches} (flash: {n_self} causal + {n_cross} "
        f"non-causal D128 per wave; decode: {n_cross} cross-attention per "
        f"step{'' if layout == 'paged' else f' + {n_self} self'})")
    if launches != want or not steps or not waves:
        raise AssertionError(f"launch counts {launches}, want {want}")
    stats = after["content_cache"]
    log(f"  content cache {stats}")
    if layout == "paged":
        pages = after["kv_pages"]
        log(f"  kv pages {pages}")
        if stats["xkv_lease_pages"] <= 0 or pages["pinned"] or \
                pages["full_copies"]:
            raise AssertionError(f"paged media round: {stats}, {pages}")
    record = {"layout": layout, "layers": cfg.num_layers,
              "requests": 12, "completion_tokens": tokens, "wall_s": wall,
              "tokens_per_s": tokens / wall, "prefill_waves": waves,
              "decode_steps": steps, "launches": launches,
              "ttft_cold_s": cold_ttft, "ttft_warm_s": warm_ttft,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "content_cache": stats, "max_batch": 8, "cache_len": 2048,
              "ctx_len": engine.ctx_len, "dtype": "bfloat16",
              "profiled_round": prof}
    del engine, client, server
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record, cold_toks


# --------------------------------------------------------------------------- #
# phase 4f: the int8 matmul's entry point
# --------------------------------------------------------------------------- #
def check_quant_entry(torch, ops, qm, get_config):
    """``ops.quant_matmul`` (no model calls it) as a SwiGLU MLP of the
    vision model's widths (8192 -> 28672 -> 8192) on int8 weights, at
    decode (8) and prefill (512) rows in bf16, against the same MLP through
    the plain version.  Returns the kernel's launches in this run."""
    import torch.nn.functional as F
    cfg = get_config(VISION)
    g = torch.Generator(device="cuda").manual_seed(21)
    ws = [ops.quantize_int8(torch.randn(shape, generator=g, device="cuda")
                            / math.sqrt(shape[0]))
          for shape in ((cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff),
                        (cfg.d_ff, cfg.d_model))]

    def mlp(x, mm):
        (gq, gs), (uq, us), (dq, ds) = ws
        return mm(F.silu(mm(x, gq, gs)) * mm(x, uq, us), dq, ds)

    qm.quant_matmul_cuda.launches = 0
    outs = []
    for m in (8, 512):
        x = torch.randn((m, cfg.d_model), generator=g,
                        device="cuda").to(torch.bfloat16)
        outs.append((mlp(x, ops.quant_matmul), x))
    torch.cuda.synchronize()
    launches = qm.quant_matmul_cuda.launches
    for got, x in outs:
        want = mlp(x, qm.quant_matmul_plain)
        rel = max_err(torch, got, want) / want.float().abs().max().item()
        log(f"  int8 SwiGLU MLP {tuple(x.shape)} through ops.quant_matmul: "
            f"max|Δ|/max|plain| {rel:.3e} (tol {2 * QMM_REL['bfloat16']:g})")
        if not bool(torch.isfinite(got).all()) or \
                rel > 2 * QMM_REL["bfloat16"]:
            raise AssertionError(f"int8 MLP disagrees: {rel}")
    if launches != 6:
        raise AssertionError(f"quant_matmul launches {launches}, want 6")
    del ws, outs
    torch.cuda.empty_cache()
    return launches


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


def time_kernels(torch, dec, fla, pag, qm):
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
    for name, extra in time_cross(torch, dec, fla, F).items():
        out[name].update(extra)
    out["quant_matmul"] = time_qmm(torch, qm)
    return out


def time_cross(torch, dec, fla, F):
    """Flash (non-causal prefill) and decode at the vision model's
    cross-attention shape, as ``cross_*`` columns: only live context slots
    count toward the bound."""
    out = {}
    for name, case, kern, plain in (
            ("flash_attention",
             lambda i: flash_case(torch, torch.bfloat16, "cross", seed=i),
             fla.flash_attention_cuda, fla.flash_attention_plain),
            ("decode_attention",
             lambda i: cross_decode_case(torch, torch.bfloat16, seed=i),
             dec.decode_attention_cuda, dec.decode_attention_plain)):
        first = case(0)[0]
        n_sets = max(2, 2 * L2_BYTES // nbytes(*first[:3]) + 1)
        sets = [case(i) for i in range(n_sets)]
        byts = flops = 0
        sdpa = []
        for args, kw in sets:
            q, k, v = args[:3]
            valid = kw["kv_valid"] if name == "flash_attention" else args[3]
            live = int(valid.sum())
            sq = q.shape[1] if q.dim() == 4 else 1
            hq, d = q.shape[-2], q.shape[-1]
            byts += (2 * nbytes(q) + nbytes(valid)
                     + 2 * live * k.shape[2] * d * k.element_size())
            flops += 4 * hq * d * sq * live
            qq = q if q.dim() == 4 else q[:, None]
            sdpa.append((qq.transpose(1, 2).contiguous(),
                         k.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous(),
                         valid[:, None, None]))
        b = bound(byts / n_sets, flops / n_sets)
        out[name] = {
            "cross_ms": time_ms(torch, lambda i: kern(*sets[i][0],
                                                      **sets[i][1]), n_sets),
            "cross_plain_ms": time_ms(torch, lambda i: plain(
                *sets[i][0], **sets[i][1]), n_sets, cycles=1),
            "cross_library_ms": time_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
                    enable_gqa=True), n_sets),
            "cross_bound_ms": b["bound_ms"], "cross_bound_by": b["bound_by"],
            "cross_shape": (f"q {tuple(first[0].shape)} over "
                            f"{tuple(first[1].shape)} bf16, "
                            f"{'non-causal, ' if name == 'flash_attention' else ''}"
                            f"{n_sets} sets"),
        }
        del sets, sdpa
        torch.cuda.empty_cache()
    return out


def time_qmm(torch, qm):
    """The int8 kernel at the vision model's MLP shapes (bf16 x), its plain
    version, and one PyTorch call computing the same product
    (``torch._weight_int8pack_mm``, weights [N, K] and bf16 scales; where
    the card's PyTorch lacks it, dequantise + ``torch.matmul``, two calls,
    labelled).  The kernels line carries the decode shape (8 rows, the
    MLP's up projection); every shape is a column of its own."""
    shapes = {}
    for m in (8, 512):
        for k, n in MLP_SHAPES:
            first = qmm_case(torch, qm, torch.bfloat16, m, k, n)[0]
            n_sets = max(2, 2 * L2_BYTES // nbytes(*first) + 1)
            del first
            sets = [qmm_case(torch, qm, torch.bfloat16, m, k, n, seed=i)[0]
                    for i in range(n_sets)]
            x, w_q, sc = sets[0]
            try:
                lib_sets = [(x_, w_.t().contiguous(), s_.to(torch.bfloat16))
                            for x_, w_, s_ in sets]
                torch._weight_int8pack_mm(*lib_sets[0])
                library, lib_name = (lambda i: torch._weight_int8pack_mm(
                    *lib_sets[i])), "torch._weight_int8pack_mm"
            except (AttributeError, RuntimeError, NotImplementedError):
                lib_sets = None
                library, lib_name = (lambda i: sets[i][0] @ (
                    sets[i][1].to(torch.bfloat16) * sets[i][2].to(
                        torch.bfloat16))), "dequantise + torch.matmul (2 calls)"
            row = {
                "ms": time_ms(torch, lambda i: qm.quant_matmul_cuda(*sets[i]),
                              n_sets),
                "plain_ms": time_ms(torch, lambda i: qm.quant_matmul_plain(
                    *sets[i]), n_sets, cycles=1),
                "library_ms": time_ms(torch, library, n_sets),
                "library": lib_name,
                **bound(nbytes(x, w_q, sc) + m * n * x.element_size(),
                        2 * m * k * n),
            }
            shapes[f"{m}x{k}x{n}"] = row
            log(f"  quant_matmul {m}x{k}x{n} bf16: kernel {row['ms']:.4f} "
                f"ms, plain {row['plain_ms']:.4f} ms, {lib_name} "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']})")
            del sets, lib_sets
            torch.cuda.empty_cache()
    main = dict(shapes[f"8x{MLP_SHAPES[0][0]}x{MLP_SHAPES[0][1]}"])
    main["shape"] = (f"x [8, {MLP_SHAPES[0][0]}] bf16 @ int8 "
                     f"[{MLP_SHAPES[0][0]}, {MLP_SHAPES[0][1]}], 2 sets")
    main["shapes"] = shapes
    return main


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
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.core.kv_cache import slice_cache_row
    from repro_torch.core.paged_kv import PagedKVPool
    from repro_torch.models.model import Model, init_cache
    from repro_torch.serving.api import OpenAIServer
    from repro_torch.serving.client import EngineClient
    from repro_torch.serving import media
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
    for kern, regs, st, ld in ptxas_report(build):
        log(f"  ptxas {kern}: {regs} registers, spill {st}/{ld} bytes "
            "(stores/loads)")

    log("== 2. kernels against their plain versions")
    errs = check_kernels(torch, dec, fla, pag, qm)

    log("== 3. full-width models, float32, kernels vs plain versions")
    check_model(torch, ops, get_config, Model, init_cache, PagedKVPool,
                slice_cache_row)
    check_vision_model(torch, ops, get_config, Model, init_cache)

    wrappers = {"decode_attention": dec.decode_attention_cuda,
                "flash_attention": fla.flash_attention_cuda,
                "paged_attention": pag.paged_attention_cuda,
                "quant_matmul": qm.quant_matmul_cuda}
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
    ns = types.SimpleNamespace(
        get_config=get_config, InferenceEngine=InferenceEngine,
        EngineClient=EngineClient, OpenAIServer=OpenAIServer,
        ApiServer=ApiServer, media=media, init_cache=init_cache)
    log(f"== 4d. serving {VISION} (10 layers, bf16) over HTTP with images, "
        "dense KV, content cache")
    media_launches, media_dense, cold_tokens = check_media_serving(
        torch, ns, wrappers, layout="dense", profile=True)
    log(f"== 4e. serving {VISION} over HTTP with images, paged KV (fp)")
    media_paged_launches, media_paged, _ = check_media_serving(
        torch, ns, wrappers, layout="paged", want_tokens=cold_tokens)
    log("== 4f. ops.quant_matmul (the int8 kernel's entry point)")
    qmm_launches = check_quant_entry(torch, ops, qm, get_config)
    # each kernel's launches in the counted round of its own path
    launches = {"decode_attention": dense_launches["decode_attention"],
                "flash_attention": paged_launches["flash_attention"],
                "paged_attention": paged_launches["paged_attention"],
                "quant_matmul": qmm_launches}

    log("== 5. times at the serving shapes (CUDA events)")
    times = time_kernels(torch, dec, fla, pag, qm)
    kernels = []
    for name in KERNEL_NAMES:
        t = times[name]
        lib = ("none (SDPA on a gathered dense copy "
               f"{t['sdpa_on_gathered_dense_copy_ms']:.4f} ms)"
               if t["library_ms"] is None else f"{t['library_ms']:.4f} ms")
        log(f"  {name:17s} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, {t.get('library', 'SDPA')} {lib}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) on {card}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: v for k, v in t.items()
               if k.startswith(("sdpa_on", "int8_pages", "cross_", "shapes",
                                "library"))},
            **({"media_round_launches": {"dense": media_launches[name],
                                         "paged": media_paged_launches[name]}}
               if name != "quant_matmul" else {})})
        if "cross_ms" in t:
            log(f"  {name:17s} cross {t['cross_shape']}: kernel "
                f"{t['cross_ms']:.4f} ms, plain {t['cross_plain_ms']:.4f} "
                f"ms, SDPA {t['cross_library_ms']:.4f} ms, bound "
                f"{t['cross_bound_ms']:.4f} ms ({t['cross_bound_by']})")
    serve = {"dense": dense, "paged": paged, "paged_int8": int8_round,
             "media_dense": media_dense, "media_paged": media_paged,
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
