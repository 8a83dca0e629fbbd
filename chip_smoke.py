#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases (any failure exits non-zero and prints no result line):

1. environment — torch/CUDA versions, the card's name and power limit, the
   hand-written kernels built from ``src/repro_torch/csrc`` with nvcc for
   ``sm_90a`` (TF32 off for every float32 product); ``ptxas`` registers and
   spills of every ``__global__`` function, and the tensor-core proof: the
   ``HGMMA`` / ``HMMA`` instructions ``cuobjdump -sass`` finds in each bf16
   instantiation of flash, the flash backward's dK/dV and dQ kernels,
   decode, paged and ``quant_matmul`` (none fails the run);
2. kernels — each CUDA kernel against its plain PyTorch version at the
   serving paths' shapes, in bf16 (atol 2e-2) and float32 (atol 1e-4); the
   paged kernel over fp and int8 pages with q in either dtype, also a row
   with one live cell, a row with all splits but one empty, G 1 and 16 at
   D 32, 64 and 128, pages of 4 and 32, a stacked arena and the vision
   model's self-attention shape, and with 1, 3 and the planned number of
   splits; flash
   non-causal and decode at the cross-attention shape of
   ``llama-3.2-vision-90b`` (D 128, G 8, a 2304-slot context); forms that
   stress the redesigned kernels (flash: G 7 with Sq not a multiple of the
   18 tokens a packed tile holds, a window with q_positions, D 32 and 128,
   rows live only in the last KV tile; decode: all-masked rows and splits,
   a ring with holes, S 1, S 777, G 1 and 16);
   ``quant_matmul`` at that model's MLP shapes (M 8 and 512), M 12 and
   ragged ones, and with 1, 3 and the planned splits of K, relative to the
   largest output (bf16 1e-2, float32 1e-4); the attention shapes of
   ``deepseek-moe-16b`` (H 16, Hkv 16: G 1), ``glm4-9b`` (G 16) and
   ``yi-34b`` (G 7), all at D 128, for all three attention kernels (flash
   in the engine form over a 2048 ring, decode at S 2048, paged at 16-token
   pages, 128 a row, fp and int8), and flash with a 256 window over a
   256-slot ring with rows past the window's reach (no live key); the
   ``rmsnorm`` kernel (the port's own) at 8, 40 and 512 rows of D 896,
   2048, 3072 and 16384 (the last two the Mamba gated norm's widths of
   ``mamba2-780m`` and jamba) against its plain version (bf16 2e-2, float32 1e-5) and against
   itself, rows 0-7 of every call bit for bit equal to the 8 rows alone;
   the threefry streams (bits, uniforms, folded step keys, categorical
   draws) on the card bit for bit equal to the same functions on the CPU
   at [8, 151936], Gumbel noise within 4 ulp; the ``categorical`` kernel
   (the port's own: threefry Gumbel noise + argmax in one pass) against
   its plain version at B 8 over V 151936, 1000, 102400, 128256, 50280,
   65536 and 256206,
   unsalted and on the three salted streams, with a masked row, a row of
   one live entry and an all -inf row: draws equal, rows 0-7 equal inside
   40 rows and row 0 alone, the same draws at 256- and 8192-element
   chunks; its noise (``gumbel_noise``) against ``sampling.gumbel`` bit
   for bit or within 4 ulp (the gap recorded); the flash backward kernel
   (``csrc/flash_attention_bwd.cu``: dQ, dK, dV of the training form)
   against ``flash_attention_bwd_plain`` at the families' training shapes
   (qwen2-0.5b G 7 D 64 causal at S 512 and 2048, glm4-9b G 16 D 128 with
   a 256 window, deepseek-moe-16b G 1 D 128, the vision cross shape,
   seamless's causal encoder and non-causal cross over 512 frames, Sq 333)
   in bf16 (1e-2) and float32 (1e-5), each gradient relative to its
   largest plain entry, given the forward's log-sum-exp, two calls and a
   call that gets the LSE itself bit for bit equal; at the same shapes the
   forward's LSE (``return_lse``) against the plain LSE (atol 1e-4) and
   its output bit for bit the output without it (also at every flash
   serving form above); ``RmsnormFn``'s dx and dw against autograd
   through ``rmsnorm_plain``;
3. full-width models — ``qwen2-0.5b`` in float32 with seeded random weights:
   a resume-prefill and 8 decode steps through the kernels against the same
   model through the plain versions (attention and rmsnorm; max |Δlogit|
   <= 1e-3, argmax
   agreement), over the dense ring and over a paged arena, and the paged
   run against the dense one through the kernels; the prompt + the 8
   decoded tokens prefilled as one sequence (how a preempted request whose
   snapshot was lost resumes) against the 8th decode step, dense and
   paged (the same limits); a speculative verify round over ``[last, d_0
   .. d_3]`` (``d`` the model's own next greedy tokens) against 5
   sequential decode steps, dense and paged (the same limits, every draft
   accepted, the kept cells equal to the sequential run's), and a round
   with a wrong draft per row that must restore every cell past the
   accepted prefix bit for bit; then
   ``llama-3.2-vision-90b`` at published widths and 5 layers (4 self-attn +
   1 gated cross-attn, gates set to 0.5) in float32 with images: prefill,
   the same prefill with the cross KV injected (content-cache hit), 8
   decode steps, kernels against plain (the same limits), fresh against
   cross-cached logits, a different image moving the logits, and the
   verify check through the cross-attention S > 1 branch; then, each
   in float32 at published widths and freed before the next, like
   ``qwen2-0.5b`` (dense and paged, kernels vs plain): ``deepseek-moe-16b``
   at 3 layers (the dense layer 0 and 2 stacked MoE layers, capacity
   factor 1.25, one row a repeated phrase), printing the (token, expert)
   pairs capacity dropped in prefill (counted here beside the model call;
   a prefill that drops none fails the run); ``codeqwen1.5-7b``,
   ``glm4-9b`` and ``yi-34b`` at 2 layers; ``glm4-9b`` again with a 256
   window over a 256-slot ring, a 600-token prompt in 256-token resume
   chunks; ``mamba2-780m`` cut to 2 layers and at full depth (48 layers)
   in 256-token resume chunks and a ragged tail: kernels vs plain (only
   ``rmsnorm`` differs), dense vs paged, re-prefill vs decode step 8, and,
   through the kernels, the chunked prefill vs one call, each decode step
   vs a prefill of the prompt + the tokens fed so far, as ported and
   with the SSD's decay matrix in float64 (``MAMBA_STEP_TOL`` at full
   depth, ``MAMBA_STEP_TOL_2`` cut to 2 layers), the right-padded row vs
   itself alone (1e-3 each but those); ``seamless-m4t-medium`` at full depth (12
   encoder + 12 decoder layers, 512 frames): kernels vs plain, fresh vs
   cross-cached prefill (no encoder call) within 1e-6; 3j (run beside
   4m-c) jamba at published widths cut to 5 layers (ssm, ssm_moe, ssm,
   ssm_moe, attn) in bf16 (float32 needs ~96 GB), dense and paged:
   kernels vs plain within ``JAMBA_TOL`` of the largest plain logit, the
   argmax equal wherever the plain top-2 gap exceeds that (near ties
   counted), capacity drops counted (> 0), and deliberately wrong plain
   paths read against the same limit (a 2 % and a 25 % softmax scale
   error; the attention layer's input norm skipped, which must exceed
   it);
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
   tokens equal to 4d's), and on each layout an image request preempted
   by an urgent text request (``max_batch`` 1, EDF, the served weights)
   resumes from its snapshot with its un-preempted tokens and one encoder
   call; 4f — ``ops.quant_matmul``, the int8 kernel's
   entry point (no model calls it), as a SwiGLU MLP of that model's widths
   on int8 weights at decode and prefill rows; 4g — ``deepseek-moe-16b`` at
   full depth (28 layers) in bf16, the text mix on the dense ring and the
   text mix plus the shared-prompt chats on paged fp pages (prefix-cache
   hits, copy-on-write, no full copy, no page pinned), the decode kernel
   (dense) or the paged kernel (paged) 28 times per decode step and flash
   28 times per prefill wave, the other decode kernel never; tokens/s,
   peak memory, the device busy share of a profiled dense round (reading
   a profile of ~100k kernels takes about a minute, so the paged round is
   not profiled), and, from the engine alone serving 6 of the prompts with
   the host's operators traced, the shares of device time of the expert
   products and of the dispatch's index, sort and scatter kernels;
   4h — overload serving on ``qwen2-0.5b`` (bf16, 24 layers): (a) the
   reference's preemption scenario (``max_batch`` 1, EDF) on the dense
   ring and on 16-token pages, the prefix cache on and off: the urgent
   request finishes first, the evictee resumes from its snapshot with
   tokens identical to FIFO, on pages with the evicted page ids and no
   copy; (b) the text mix with ``max_tokens`` 128 on an arena holding 45 %
   of its live set's peak pages, beside a full-capacity arena: rung-2
   preemptions resumed by re-prefill, nothing failed, no page pinned,
   tokens/s, peak memory and the share of identical texts; (c) admission
   on servers built by ``launch/serve.py``: 429s past a tenant's
   requests/s, 503s at SHED_BULK (batch class) and at a full queue,
   ``/readyz`` 503 at SHED_ALL, a ``timeout`` finish.  Every
   finish_reason and usage is checked, and each round's launch counters
   are zeroed just before it and read just after (4h-b: 24 paged
   launches per decode step, 24 flash per prefill wave, dense decode
   never); 4i — speculative decoding on ``qwen2-0.5b`` (bf16, 24 layers,
   ``max_batch`` 8, ``cache_len`` 2048, ``spec_k`` 4): (a) n-gram on the
   dense ring serving the 4a mix plus 6 repetition-heavy requests, beside
   the same rounds with spec off; (b) the same on 16-token fp pages with
   the prefix cache on (no page pinned or copied, every page free or a
   cache lease); (c) a draft model with the target's own weights, the
   engine alone on 8 greedy requests (acceptance > 0.3, draft pool > 0
   bytes) and a seeded stochastic request replayed twice through the
   categorical kernel (its salted draft and correction draws) and once
   with ``ops.categorical`` routed to the plain version, all identical;
   (d) a server built
   by ``launch/serve.py --spec-mode ngram`` over HTTP (one request
   streamed) with the ``/stats`` ``speculation`` block.  Each requires
   rounds > 0, accepted > 0 and drafted = accepted + rejected, and counts
   launches per round: 24 x (block decode steps + 5 x verify rounds) on
   the layout's kernel, + 24 x 4 x draft rounds on decode in (c), flash
   24 x (prefill waves + the draft's prime prefills); it reads the share
   of texts equal to spec off, tokens/s of both, accepted tokens a round,
   and forwards against emitted tokens, and ``tools/spec_row_drift.py``'s
   reading 2 through ``layers.rmsnorm`` (1600 rows normalised alone and
   inside 5x as many: none may differ); 4j — the rest of single-engine
   serving on ``qwen2-0.5b`` (bf16, 24 layers, the served weights, the
   engine alone unless named): (a) 24 prompts of 300–1500 tokens on 8
   slots with speculative wave filling on and off, dense ring and fp
   pages: the same tokens, speculative jobs opened and admitted, flash
   24 x prefill waves either way; waves, the queued requests' TTFT and
   tokens/s read; (b) ``n`` = 4 behind a ~650-token system prompt: the
   prompt prefills once, 3 shared admits, no copy and no pinned page on
   pages, every choice equal to an ``n`` = 1 request; 4d also serves an
   ``n`` = 2 image request (admitted independently, one encoder call);
   (c) the echo pass (phase 3's float32 model, TF32 off) through the
   kernels against the plain versions and against prefills of the
   prefix at 3 cut points (1e-3), and over HTTP one logprob per prompt
   token, ``error_echo_stream``'s 400; (d) a ``FaultInjector`` at the
   prefill, decode, codec and pool sites, 16 requests on each layout:
   survivors equal a fault-free run, each failure one ``error`` naming an
   injected fault, nothing pinned; then a decode block that raises with 8
   live and 4 pending requests: the live fail, the pending finish, and
   the peak of allocated memory across the rebuild stays less than one
   arena above what was allocated before; (e) on launcher-built servers
   a ``slow_step`` fault flips ``/readyz`` to 503 and back (the
   watchdog), ``POST /admin/drain`` finishes 4 in-flight requests while a
   new one gets the 503 ``draining`` envelope, and on pages a drain past
   ``--drain-timeout`` publishes the 8 live slots' exact sequences and
   aborts all 10 requests, no page pinned; (f) export mid-decode from one
   engine and import into another, dense, fp and int8 pages: tokens equal
   an undrained run, the 8 snapshots resume with no flash launch, their
   cells (int8 values and scales) equal the exporter's bit for bit; 4k —
   multi-replica serving, servers built as ``launch/serve.py --replicas 2
   --router-policy affinity --transport asgi`` builds them (``qwen2-0.5b``,
   bf16, 24 layers, 8 slots each): (a) on fp pages, 16 chats in 8
   ``x-session``s and 4b's 6 shared-prompt chats, twice: each session on
   one replica, the shared-prompt chats on one replica by digest placement
   with prefix-cache hits there, greedy texts equal to a one-replica
   server's, usage right, no page pinned, the paged kernel 24 x and flash
   24 x the replicas' decode steps and prefill waves, rmsnorm 49 x both;
   read: tokens/s against one replica, the prefix-hit share against
   ``--router-policy random``; (c) 32 concurrent SSE streams, a client
   that disconnects mid-stream aborted within 2 s, ``batch`` of 8 equal to
   8 single calls, the ASGI lifespan, and after ``POST /admin/drain`` a
   stream's structured 503 ``draining`` with ``Retry-After``; (b)
   ``Router.drain_replica(0)`` with 8 live and 4 queued requests, dense
   and fp pages: outputs equal to an undrained engine, the live slots
   resume with no flash launch, gapless streams, session pins moved; (d) a
   seeded stochastic request (temperature 0.8, top-p 0.9, seed 1234) on
   each replica and after the drain: the same tokens; 4l — 4a's 12 prompts
   as sampled requests (temperature 0.8, top-p 0.95 on half, a seed each)
   on ``qwen2-0.5b`` (bf16, 24 layers, dense ring, the engine alone,
   prefix cache off), three runs through the categorical kernel (the
   counted one and two seeded replays) in turns with three with
   ``ops.categorical`` routed to the plain version — tokens identical, the
   kernel launched between once per decode step and once per decode step
   and wave, never on the plain route; tokens/s of both; 4m — the
   recurrent families in bf16 (``max_batch`` 8, ``cache_len`` 2048,
   ``prefill_chunk`` 512, prefix cache on): (a) ``mamba2-780m`` at full
   depth serving 4a's 12 bodies over HTTP twice, dense ring then fp
   pages, each round queued in the bodies' order before the engine's
   loop runs (so both layouts run the same waves): no attention kernel
   launched, ``rmsnorm`` 97 a forward, no page pinned or copied, tokens
   dense = paged for every request with no prefix hit in either run
   (those with a hit listed with their hit lengths), tokens/s, peak
   memory, and the engine alone under the profiler with the SSD scan,
   decode step, conv, GEMM and ``rmsnorm`` shares of device time; (b) the preemption scenario on it with the
   prefix cache off, dense and pages: the victim equal to FIFO; (c) the
   5-layer jamba served the same way (flash 1 a wave, the layout's
   decode kernel 1 a step, ``rmsnorm`` 15 a forward; texts dense vs
   paged read); 4n — ``seamless-m4t-medium`` at full depth in bf16 on
   the engine, dense ring then fp pages: 8 concurrent requests with one
   new waveform, 1 encoder invocation and 7 dedup joins + embedding
   hits, flash 24 a wave + 12 in a wave encoding fresh audio, a warm
   repeat with identical tokens, 1 embedding and 1 cross-KV hit and no
   encoder call, tokens equal across the layouts, TTFT cold vs warm.
   An ``error`` finish that names no injected fault fails the run in every
   phase;
5. times — each kernel, its plain version and one PyTorch library call
   where one computes the same function (SDPA with an explicit mask; none
   takes a page table, so the paged kernel's SDPA time is over a dense copy
   gathered beforehand, labelled as such) at the phase-2 serving shapes,
   with CUDA events over rotating input copies larger than the L2 cache,
   beside the least time the card could take (``bound_ms``) and the
   kernel/SDPA ratio from the same call, each also device alone (the host's
   launch work hidden), and again at ``deepseek-moe-16b``'s shapes (the
   ``moe_*`` columns); decode's and paged's time against their number of
   splits; ``rmsnorm`` at the decode step's 8 x 896 and a 512-row chunk
   beside ``F.rms_norm`` and its byte bound; the ``categorical`` kernel at
   [8, 151936] (a call, device alone, its plain version, ``torch.argmax``
   as a draw's floor, the integer-operation bound); one
   ``masked_sample_inner`` step on [8, 151936] greedy, stochastic, and
   stochastic with top-p, each through the kernel and with the plain
   draw; the flash backward at 6a's bf16 step shape (B 8 x S 512, causal),
   given the forward's LSE, beside its plain version and SDPA's backward,
   bound by five products of the forward's size halved under causal;
6. training — (a) ``qwen2-0.5b`` at full depth: in float32 at B 4 x S 512
   one loss and every gradient leaf through the kernels (flash forward and
   backward, rmsnorm) against the plain versions (1e-3 of each leaf's
   largest entry), remat on against off bit for bit, a step with
   microbatches 2 against 1; in bf16 at B 8 x S 512, one loss and its
   gradients with remat on against off bit for bit, 30 AdamW steps on
   the bigram data (ids cut to 512): the loss falls, 24 flash and 24
   backward launches a step, tokens/s and peak memory read; the state's
   checkpoint restored bit for bit; one more steady step under
   ``torch.profiler``: device time by kind (flash forward, the flash
   backward, GEMMs, rmsnorm forward and backward, AdamW, the rest) and
   the device's busy share of the step; ``launch/train.py`` for 3 steps; (b)
   ``deepseek-moe-16b`` at published widths cut to 3 layers, float32:
   kernels vs plain with remat on, aux loss > 0, capacity drops > 0; (c)
   ``mamba2-780m`` in float32: kernels vs plain (only rmsnorm differs;
   the differentiable SSD runs) cut to 2 layers (1e-3) and at full depth
   (48 layers; within twice the plain path's own change when the SSD's
   decay matrix runs in float64).  Phase 6 runs after phase 4; phase 5
   last.

The last lines are one ``serve`` JSON line (4k under ``k4``, 4m under
``m4``, 4n under ``n4``, phase 6 under ``train``), one ``spec``
JSON line, one ``{"kernels": [...]}`` JSON line (seven kernels), the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
import urllib.error
import urllib.request
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
PEAK_BF16_FLOPS = 989e12          # dense tensor-core bf16, data sheet
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:61",
    "flash_attention": "src/repro/kernels/flash_attention.py:84",
    # no TPU kernel: pallas_call has no transpose rule, so the reference's
    # gradient through attention is XLA's autodiff of _flash_jnp
    "flash_attention_bwd": "src/repro/kernels/ops.py:63",
    "paged_attention": "src/repro/kernels/paged_attention.py:86",
    "quant_matmul": "src/repro/kernels/quant_matmul.py:42",
    # no TPU kernel: the reference computes rmsnorm in plain jnp; the port's
    # kernel exists to make a row's result independent of the call's rows
    "rmsnorm": "src/repro/models/layers.py:41",
    # no TPU kernel: the reference draws with vmap(jax.random.categorical)
    # inside its jitted sampler, which XLA fuses
    "categorical": "src/repro/core/sampling.py:168",
}
REPLACES_NOTE = {
    "flash_attention_bwd": "no TPU kernel: jax's pallas_call has a JVP rule "
                           "and no transpose rule, so the reference trains "
                           "through XLA's autodiff of _flash_jnp (the line "
                           "named); the backward of the port's "
                           "FlashAttentionFn around the forward kernel",
    "rmsnorm": "no TPU kernel: the reference's rmsnorm is plain jnp; a "
               "kernel of the port's own, row-invariant",
    "categorical": "no TPU kernel: the reference's draw is "
                   "vmap(jax.random.categorical) fused by XLA; a kernel of "
                   "the port's own: threefry Gumbel noise + argmax in one "
                   "pass",
}
PEAK_F32_FLOPS = 67e12            # float32 outside the tensor cores
# int32 operations: 132 SMs x 64 a clock at the 1980 MHz boost clock (data
# sheet); the categorical kernel's threefry rounds run on this pipe
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# the categorical kernel's work an element (csrc/categorical.cu): integer
# operations (20 rounds, key injections, the uniform's bits, the running
# maximum) and float operations (two logf, the uniform, the add)
CATEGORICAL_INT_OPS = 88
CATEGORICAL_F32_OPS = 40
# the categorical checks' vocabularies: qwen2-0.5b's, a 1000-entry one,
# 102400 / 128256 (deepseek-moe-16b, llama-3.2-vision-90b) and 50280 /
# 65536 / 256206 (mamba2-780m, jamba-1.5-large-398b, seamless-m4t-medium)
CAT_WIDTHS = (151936, 1000, 102400, 128256, 50280, 65536, 256206)
CAT_SEEDS = (0, 1, 42, 1234, 2**31 + 7, 2**32 + 9, 2**40 + 3, 2**63 - 1)
GUMBEL_ULP = 4                    # the noise's limit if not bit for bit
RMS_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# qwen2-0.5b, deepseek-moe-16b; the Mamba gated norm's d_inner of
# mamba2-780m and jamba-1.5-large-398b
RMS_WIDTHS = (896, 2048, 3072, 16384)
# quant_matmul outputs grow with K: held relative to the largest output
QMM_REL = {"bfloat16": 1e-2, "float32": 1e-4}
VISION = "llama-3.2-vision-90b"
MOE = "deepseek-moe-16b"
DENSE_FAMILY = ("codeqwen1.5-7b", "glm4-9b", "yi-34b")
CROSS = dict(b=8, ctx=2304, h=64, hkv=8, d=128)      # 576 tokens x 4 images
MLP_SHAPES = ((8192, 28672), (28672, 8192))           # (K, N) of up / down
GATE = 0.5
KERNEL_NAMES = tuple(REPLACES)
MAMBA = "mamba2-780m"
JAMBA = "jamba-1.5-large-398b"
JAMBA_LAYERS = 5
# jamba's bf16 kernels-vs-plain limit, relative to the largest plain logit:
# bf16 keeps 8 mantissa bits (a relative step of 2**-8 = 3.9e-3 an
# element); the attention and rmsnorm kernels round each output once where
# the plain versions round in another order, and the 5 layers' products
# carry such one-ulp differences into the logits, so a few ulp of the logit
# scale, 2e-2, bounds them.  On the H100 the kernels read 3.1e-2 of 5.7,
# one bf16 ulp of the logits: 2 ulp is already 1.1 % of the scale, and a
# 2 % softmax scale error reads the same one ulp, so no tighter limit
# tells it apart; a skipped norm reads 51 %
JAMBA_TOL = 2e-2
SKIPPED_NORM = "attention layer's input rmsnorm skipped"
# mamba2-780m's decode step n against a prefill of prompt + n (float32),
# as ported and with the SSD's decay matrix in float64: the reference's
# decay matrix is exp(cs_i - cs_j) of float32 cumulative sums, whose
# cancellation the prefill's chunk pays and the decode step's recurrence
# does not, and 48 layers of random weights grow it (on the H100 9.6e-4
# as ported, 8.2e-5 in float64; 3.8e-6 and 3.6e-6 cut to 2 layers, where
# a state handed over wrong would show at once): limits ~2x, ~4x and ~5x
# those readings
MAMBA_STEP_TOL = (2e-3, 3e-4)
MAMBA_STEP_TOL_2 = (2e-5, 2e-5)
AUDIO = "seamless-m4t-medium"
L2_BYTES = 50 * 2**20


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase header (``== ...``) also gets the seconds
    since the script started."""
    if msg.startswith("== "):
        msg += f" [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def demangle(build, syms: list) -> list:
    """``name<template args>`` of each mangled ``__global__`` symbol, by the
    toolkit's ``cu++filt`` (found beside nvcc), parameters left out."""
    if not syms:
        return []
    filt = Path(build.nvcc_path()).with_name("cu++filt")
    res = subprocess.run([str(filt), "-p", *syms], capture_output=True,
                         text=True, timeout=60)
    names = res.stdout.splitlines()
    if res.returncode != 0 or len(names) != len(syms):
        raise RuntimeError(f"cu++filt failed: {res.stderr.strip()[-2000:]}")
    return [n.strip() for n in names]


def ptxas_report(build) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    compiled ``__global__`` function, templated or not, from the
    ``-Xptxas -v`` output the build keeps in ``build/<name>.log``."""
    import re
    syms, out = [], []
    for name in build.KERNELS:
        text = (build.BUILD / f"{name}.log").read_text()
        for entry in re.split(r"Compiling entry function '", text)[1:]:
            sym = entry.split("'", 1)[0]
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            if regs is None or spill is None:
                raise AssertionError(f"no ptxas report for {sym}")
            syms.append(sym)
            out.append((int(regs.group(1)), int(spill.group(1)),
                        int(spill.group(2))))
    return [(kern, *nums) for kern, nums in zip(demangle(build, syms), out)]


def mma_count(build, name: str, kernel: str) -> dict:
    """{instantiation: tensor-core instructions} of the functions named
    ``kernel`` in the built library of ``name``, from ``cuobjdump -sass``:
    ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync) together, the proof that
    they run on the tensor cores."""
    import re
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-sass", str(build._lib_path(name))],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr.strip()[-2000:]}")
    counts, cur = {}, None
    for line in res.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            cur = fn.group(1)
            counts.setdefault(cur, 0)
        elif cur is not None:
            counts[cur] += len(re.findall(r"\bH(?:G)?MMA\.", line))
    return {kern: n for kern, n in zip(demangle(build, list(counts)),
                                       counts.values())
            if re.search(rf"(^|::){kernel}<", kern)}


# (library, kernel, bf16 instantiations): every one must hold tensor-core
# instructions (flash and its backward: HGMMA; decode, paged,
# quant_matmul: HMMA)
TENSOR_CORE_KERNELS = (
    ("flash_attention", "flash_attention_tc_kernel", 3),
    ("flash_attention_bwd", "dkdv_kernel", 3),
    ("flash_attention_bwd", "dq_kernel", 3),
    ("decode_attention", "decode_attention_mma_kernel", 3),
    ("paged_attention", "paged_attention_mma_kernel", 6),
    ("quant_matmul", "qmm_mma_kernel", 2))


def check_tensor_cores(build) -> dict:
    """Phase 1's proof that every bf16 instantiation of the tensor-core
    kernels runs on the tensor cores; returns {library: {instantiation:
    n}}."""
    out = {}
    for lib, kernel, want in TENSOR_CORE_KERNELS:
        counts = mma_count(build, lib, kernel)
        out.setdefault(lib, {}).update(counts)
        for kern, n in sorted(counts.items()):
            log(f"  sass {kern}: {n} HGMMA/HMMA instructions")
        if len(counts) != want or not all(counts.values()):
            raise AssertionError(f"every bf16 {kernel} instantiation must run "
                                 f"on the tensor cores: {counts}")
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
def decode_case(torch, dtype, *, b=8, s=2048, h=14, hkv=2, d=64, seed=0,
                mask="ragged"):
    """``ragged``: per-row lengths, one wrapped (all-valid) row;
    ``masked``: row 0 all masked, row 1 live on its first 10 keys only (so
    every later split is all-masked), the others ragged; ``holes``: a
    wrapped ring with about a third of its cells dead at random."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lengths[0] = s
    valid = torch.arange(s, device="cuda")[None] < lengths[:, None]
    if mask == "masked":
        valid[0] = False
        valid[1] = torch.arange(s, device="cuda") < 10
    elif mask == "holes":
        valid = torch.rand((b, s), generator=g, device="cuda") > 0.35
    return (q, k, v, valid), {}


# phase-2 decode forms: (label, decode_case arguments)
DECODE_FORMS = (("B8 S2048 G7", {}),
                ("B3 S1000 G7", dict(b=3, s=1000)),
                ("all-masked rows", dict(b=4, mask="masked")),
                ("ring with holes", dict(b=4, s=1500, mask="holes")),
                ("S1", dict(b=4, s=1)),
                ("S777 G8 D32", dict(b=5, s=777, h=16, hkv=2, d=32)),
                ("G1", dict(b=4, s=600, h=8, hkv=8)),
                ("G16 D128", dict(b=2, s=900, h=32, hkv=2, d=128)),
                ("deepseek G1 D128", dict(h=16, hkv=16, d=128)),
                ("glm4 G16 D128", dict(h=32, hkv=2, d=128)),
                ("yi G7 D128", dict(h=56, hkv=8, d=128)),
                ("seamless G1 D64", dict(h=16, hkv=16)))


FLASH_FORMS = ("engine", "causal_offset", "window", "ragged", "cross",
               "g7_ragged_tiles", "window_qpos", "d32", "d128", "last_tile",
               "deepseek_engine", "glm4_engine", "yi_engine",
               "glm4_window_ring", "seamless_engine")
# (H, Hkv) at D 128 of the MoE model and the dense family's serving paths
FAMILY_HEADS = {"deepseek": (16, 16), "glm4": (32, 2), "yi": (56, 8)}


def flash_case(torch, dtype, form, *, seed=0):
    """``engine``: a 512-token bucket over a 2048 cache, per-row
    q_positions and kv_valid; ``causal_offset`` / ``window``: the Pallas
    kernel's own modes; ``ragged``: Skv = 1000; ``cross``: the vision
    model's cross-attention prefill, non-causal, 8 rows x 64-token bucket
    over the 2304-slot context, each row's first 1-4 images live.  Forms
    that stress the bf16 kernel's design: ``g7_ragged_tiles`` (G = 7, Sq =
    100 not a multiple of the 18 tokens a packed tile holds),
    ``window_qpos`` (a window with per-row q_positions), ``d32`` /
    ``d128`` (the other head dims, D 128 at G 8), ``last_tile``
    (non-causal, rows whose only live keys lie in the last KV tile).
    ``<model>_engine``: the engine form at ``FAMILY_HEADS`` (G 1, 16 and 7
    at D 128), ``seamless_engine`` the audio decoder's (G 1 at D 64);
    ``glm4_window_ring``: a 256 window over a 256-slot ring, rows
    resuming at 0, 256 and 512 (the last past the window's reach: no live
    key, the mean of V)."""
    family = {f"{m}_engine": (8, 512, 2048, *hh, 128)
              for m, hh in FAMILY_HEADS.items()}
    family["glm4_window_ring"] = (3, 256, 256, *FAMILY_HEADS["glm4"], 128)
    b, sq, skv, h, hkv, d = {**family,
                             "engine": (8, 512, 2048, 14, 2, 64),
                             "seamless_engine": (8, 512, 2048, 16, 16, 64),
                             "causal_offset": (2, 512, 2048, 14, 2, 64),
                             "window": (2, 512, 512, 14, 2, 64),
                             "ragged": (3, 200, 1000, 14, 2, 64),
                             "cross": (CROSS["b"], 64, CROSS["ctx"],
                                       CROSS["h"], CROSS["hkv"],
                                       CROSS["d"]),
                             "g7_ragged_tiles": (2, 100, 600, 14, 2, 64),
                             "window_qpos": (4, 256, 1024, 14, 2, 64),
                             "d32": (2, 70, 300, 8, 2, 32),
                             "d128": (2, 65, 400, 16, 2, 128),
                             "last_tile": (3, 40, 300, 14, 2, 64)}[form]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    kw = {"causal": form not in ("cross", "last_tile")}
    if form == "cross":
        kw["kv_valid"] = cross_valid(torch, g, b, skv)
    elif form == "glm4_window_ring":
        kw["q_positions"] = (torch.tensor([[0], [256], [512]], device="cuda")
                             + torch.arange(sq, device="cuda")).int()
        kw["window"] = 256
    elif form in ("engine", "window_qpos") or form.endswith("_engine"):
        start = torch.randint(0, skv - sq + 1, (b,), generator=g,
                              device="cuda")
        kw["q_positions"] = (start[:, None] + torch.arange(
            sq, device="cuda")[None]).to(torch.int32)
        kw["kv_valid"] = torch.arange(skv, device="cuda")[None] < \
            (start + sq)[:, None]
        if form == "window_qpos":
            kw["window"] = 200
    elif form in ("causal_offset", "ragged", "g7_ragged_tiles", "d32",
                  "d128"):
        kw["q_offset"] = skv - sq
    elif form == "window":
        kw["window"] = 256
    elif form == "last_tile":
        idx = torch.arange(skv, device="cuda")
        kw["kv_valid"] = torch.stack([idx >= skv - 10, idx == skv - 1,
                                      idx >= 0])
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
               d=64, seed=0, short=None, stacked=0):
    """The serving arena: ``reserved + b * p`` pages (reserved as the pool
    reserves them), ragged positions, rows 0 and 1 sharing their first four
    pages, row 2 wrapped, every entry past a row's pages at page 0.
    ``short``: row 3's position (``0``: one live cell); ``stacked``: the
    pages are layer 1 of an ``[N, stacked, ps, Hkv, D]`` arena (a view whose
    page stride is not its page size)."""
    from repro_torch.core.paged_kv import PagedKVPool
    from repro_torch.kernels.quant_matmul import quantize_kv_int8
    n = PagedKVPool.full_capacity(b, ps * p, ps)
    reserved = n - b * p
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    kw, kv = {}, []
    lead = (stacked,) if stacked else ()
    for name in ("k", "v"):
        x = torch.randn((n, *lead, ps, hkv, d), generator=g, device="cuda")
        sc = None
        if int8:
            x, sc = quantize_kv_int8(x)
        else:
            x = x.to(dtype)
        if stacked:
            x, sc = x[:, 1], None if sc is None else sc[:, 1]
        if sc is not None:
            kw[f"{name}_scale"] = sc
        kv.append(x)
    pos = torch.randint(4 * ps, p * ps, (b,), generator=g, device="cuda")
    pos[2] = p * ps + 37
    table = torch.zeros((b, p), dtype=torch.int32, device="cuda")
    perm = torch.randperm(b * p, generator=g, device="cuda") + reserved
    for row in range(b):
        live = p if row == 2 else int(pos[row]) // ps + 1
        table[row, :live] = perm[row * p:row * p + live].int()
    table[1, :4] = table[0, :4]
    if short is not None:
        pos[3] = short
    return (q, kv[0], kv[1], table, pos.int()), kw


# phase-2 paged forms, each on fp and int8 pages: (label, paged_case
# arguments)
PAGED_FORMS = (("B8 ps16 P128", {}),
               ("one live cell", dict(b=4, short=0)),
               ("one split live", dict(b=4, short=19)),
               ("G1 D32 ps4", dict(b=4, ps=4, p=40, h=8, hkv=8, d=32)),
               ("G16 D64 ps32", dict(b=4, ps=32, p=10, h=16, hkv=1, d=64)),
               ("G16 D128", dict(b=3, p=20, h=32, hkv=2, d=128)),
               ("G1 D128", dict(b=3, p=20, h=16, hkv=16, d=128)),
               ("stacked arena", dict(b=4, stacked=3)),
               ("4e H64 Hkv8 D128", dict(h=64, hkv=8, d=128)),
               ("deepseek G1 D128", dict(h=16, hkv=16, d=128)),
               ("glm4 G16 D128", dict(h=32, hkv=2, d=128)),
               ("yi G7 D128", dict(h=56, hkv=8, d=128)),
               ("seamless G1 D64", dict(h=16, hkv=16, d=64)))


def max_err(torch, a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_kernels(torch, dec, fla, pag, qm):
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        cases = [("decode_attention", what, dec,
                  decode_case(torch, dtype, **kw)) for what, kw in DECODE_FORMS]
        cases += [("decode_attention", "cross D128 G8", dec,
                   cross_decode_case(torch, dtype))]
        cases += [("flash_attention", form, fla, flash_case(torch, dtype, form))
                  for form in FLASH_FORMS]
        cases += [("paged_attention", f"{what}{' int8' if int8 else ''}",
                   pag, paged_case(torch, dtype, int8=int8, seed=int(int8),
                                   **kw))
                  for what, kw in PAGED_FORMS for int8 in (False, True)]
        cases += [("quant_matmul", f"{m}x{k}x{n}", qm,
                   qmm_case(torch, qm, dtype, m, k, n))
                  for m in (8, 512) for k, n in MLP_SHAPES]
        cases += [("quant_matmul", f"{m}x{k}x{n}", qm,
                   qmm_case(torch, qm, dtype, m, k, n))
                  for m, k, n in ((12, 4096, 4096), (77, 1000, 1040),
                                  (77, 1000, 1000))]
        for name, what, mod, (args, kw) in cases:
            kern = getattr(mod, f"{name}_cuda")
            plain = getattr(mod, f"{name}_plain")
            got = kern(*args, **kw)
            if name == "flash_attention" and not torch.equal(
                    kern(*args, **kw, return_lse=True)[0], got):
                raise AssertionError(f"flash_attention {dname} {what}: the "
                                     "output changes with return_lse")
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
        check_split_counts(torch, pag, qm, dtype)
        torch.cuda.empty_cache()
    return errs


def check_rmsnorm(torch, rms) -> float:
    """The rmsnorm kernel against its plain version at the serving paths'
    rows (8 decode rows, 40 verify rows, 512 prefill rows) and widths (D
    896 and 2048), bf16 (atol 2e-2) and float32 (1e-5); then against
    itself across call sizes, bit for bit: rows 0-7 alone equal the same
    rows inside 40 and inside 512.  Returns the largest bf16 error."""
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(13)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for d in RMS_WIDTHS:
            x = (torch.randn((512, d), generator=g, device="cuda") * 2
                 ).to(dtype)
            w = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
                 ).to(dtype)
            alone = rms.rmsnorm_cuda(x[:8].clone(), w)
            for rows in (8, 40, 512):
                got = rms.rmsnorm_cuda(x[:rows].clone(), w)
                torch.cuda.synchronize()
                err = max_err(torch, got, rms.rmsnorm_plain(x[:rows], w))
                same = bool(torch.equal(got[:8], alone))
                ok = err <= RMS_TOL[dname] and same and \
                    bool(torch.isfinite(got).all())
                log(f"  rmsnorm           {dname:8s} {rows:3d}x{d}: "
                    f"max|kernel-plain| {err:.3e} (tol {RMS_TOL[dname]:g}); "
                    f"rows 0-7 equal to 8 rows alone bit for bit {same} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"rmsnorm {dname} {rows}x{d}: error "
                                         f"{err}, row-invariant {same}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
    return worst


def check_threefry(torch, sampling) -> dict:
    """The threefry streams on the card against the same functions on the
    CPU (which the CPU tests hold to JAX bit for bit): bits, uniforms and
    folded step keys bit for bit at [8, 151936], Gumbel noise within 4 ulp
    of max(1, |g|) (the card's log against the CPU's), and categorical
    draws equal."""
    import numpy as np
    keys = np.stack([sampling.request_base_key(s) for s in
                     (0, 1, 42, 1234, 2**31 + 7, 2**32 + 9, 2**40 + 3,
                      2**63 - 1)]).astype(np.int64)
    kc = torch.from_numpy(keys)
    kg = kc.cuda()
    v = 151936
    pos = torch.tensor([0, 7, 300, 2047, 4095, 9, 65536, 3])
    step_c = sampling.fold_step_keys(kc, pos)
    step_g = sampling.fold_step_keys(kg, pos.cuda())
    logits = torch.randn((8, v), generator=torch.Generator().manual_seed(5))
    out = {
        "step_keys_equal": bool(torch.equal(step_g.cpu(), step_c)),
        "bits_equal": bool(torch.equal(sampling.random_bits(step_g, v).cpu(),
                                       sampling.random_bits(step_c, v))),
        "uniforms_equal": bool(torch.equal(
            sampling.uniform(step_g, v).cpu().view(torch.int32),
            sampling.uniform(step_c, v).view(torch.int32))),
        "categorical_equal": bool(torch.equal(
            sampling.categorical(step_g, logits.cuda()).cpu(),
            sampling.categorical(step_c, logits))),
    }
    gg = sampling.gumbel(step_g, v).cpu()
    gc_ = sampling.gumbel(step_c, v)
    diff = ((gg - gc_).abs() / gc_.abs().clamp_min(1.0)).max().item()
    out["gumbel_max_rel_to_max1"] = diff
    ok = all(out[k] for k in ("step_keys_equal", "bits_equal",
                              "uniforms_equal", "categorical_equal")) and \
        diff <= 4 * 2.0 ** -23
    log(f"  threefry on the card vs the CPU at [8, {v}]: {out} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"threefry card vs CPU: {out}")
    return out


def categorical_case(torch, sampling, b, v, seed=0):
    """Base keys of seeded requests (seeds past 2**32 among them),
    positions (the last past 2**32) and float32 logits ``[b, v]`` on the
    card: row 0 masks every third entry, row 1 keeps one live entry, row 2
    is all -inf."""
    import numpy as np
    keys = torch.from_numpy(np.stack([
        sampling.request_base_key(CAT_SEEDS[i % len(CAT_SEEDS)]
                                  + i // len(CAT_SEEDS))
        for i in range(b)]).astype(np.int64)).cuda()
    pos = torch.arange(b, device="cuda") * 4099 + 7
    pos[-1] += 2**32
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((b, v), generator=g, device="cuda") * 3
    logits[0, ::3] = float("-inf")
    live = logits[1, v // 2].clone()
    logits[1] = float("-inf")
    logits[1, v // 2] = live
    logits[2] = float("-inf")
    return keys, pos, logits


def check_categorical(torch, cat, sampling) -> dict:
    """The draw kernel against its plain version (``sampling.categorical``
    of the folded keys) at B 8 over :data:`CAT_WIDTHS`, unsalted and on the
    three salted streams of speculation: draws equal; the one live entry
    and the all -inf row's 0 drawn; rows 0-7 alone (row 0 also alone) equal
    to the same rows inside 40; the draws equal at chunks of 256 and 8192
    elements a block; the noise (``gumbel_noise``) against
    ``sampling.gumbel`` at [8, 151936], bit for bit or within
    :data:`GUMBEL_ULP` ulp (the gap recorded)."""
    from repro_torch.core.spec_decode import (ACCEPT_SALT, CORRECTION_SALT,
                                              DRAFT_SALT)
    salts = (None, ACCEPT_SALT, CORRECTION_SALT, DRAFT_SALT)
    cases = 0
    for v in CAT_WIDTHS:
        keys, pos, logits = categorical_case(torch, sampling, 40, v, seed=v)
        for salt in salts:
            k8, p8, l8 = keys[:8].clone(), pos[:8].clone(), logits[:8].clone()
            got = cat.categorical_cuda(l8, k8, p8, salt)
            inside = cat.categorical_cuda(logits, keys, pos, salt)
            alone = cat.categorical_cuda(l8[:1].clone(), k8[:1].clone(),
                                         p8[:1].clone(), salt)
            torch.cuda.synchronize()
            want = cat.categorical_plain(l8, k8, p8, salt)
            ok = (torch.equal(got, want) and torch.equal(inside[:8], got)
                  and alone.item() == got[0].item()
                  and got[1].item() == v // 2 and got[2].item() == 0)
            if v == CAT_WIDTHS[0] and salt in (None, DRAFT_SALT):
                ok = ok and all(torch.equal(cat.categorical_cuda(
                    l8, k8, p8, salt, chunk=c), got) for c in (256, 8192))
            log(f"  categorical       V {v:6d} salt {salt}: draws "
                f"{got.tolist()} plain {want.tolist()}; 8 rows = inside 40 "
                f"= row 0 alone {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"categorical V {v} salt {salt}: kernel "
                                     f"{got.tolist()} plain {want.tolist()} "
                                     f"inside 40 {inside[:8].tolist()} alone "
                                     f"{alone.tolist()}")
            cases += 1
    keys, pos, _ = categorical_case(torch, sampling, 8, 8)
    noise = {}
    for salt in (None, CORRECTION_SALT):
        got = cat.gumbel_noise(keys, pos, CAT_WIDTHS[0], salt)
        step = (sampling.fold_step_keys(keys, pos) if salt is None
                else sampling.fold_salted_keys(keys, salt, pos))
        want = sampling.gumbel(step, CAT_WIDTHS[0])
        torch.cuda.synchronize()
        ulp = (got.view(torch.int32).long()
               - want.view(torch.int32).long()).abs().max().item()
        noise[str(salt)] = {"bit_for_bit": bool(torch.equal(
            got.view(torch.int32), want.view(torch.int32))),
            "max_ulp": ulp, "max_abs": max_err(torch, got, want)}
        log(f"  categorical       noise [8, {CAT_WIDTHS[0]}] salt {salt} vs "
            f"sampling.gumbel: {noise[str(salt)]} (limit {GUMBEL_ULP} ulp)")
        if ulp > GUMBEL_ULP or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"categorical noise: {noise[str(salt)]}")
    return {"draw_cases_equal": cases, "noise": noise,
            "max_abs_err": max(n["max_abs"] for n in noise.values())}


def check_split_counts(torch, pag, qm, dtype):
    """The paged kernel (fp and int8 pages) with 1, 3 and the planned
    number of splits, and the bf16 ``quant_matmul`` with 1, 3 and the
    planned splits of K, each against the plain version."""
    dname = str(dtype).split(".")[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for int8 in (False, True):
        args, kw = paged_case(torch, dtype, int8=int8, seed=7)
        q, k, table = args[0], args[1], args[3]
        plan = pag.plan_splits(table.shape[1] * k.shape[1],
                               q.shape[0] * k.shape[2], sms)
        want = pag.paged_attention_plain(*args, **kw)
        for n in (1, 3, plan):
            err = max_err(torch, pag._launch(*args, kw.get("k_scale"),
                                             kw.get("v_scale"), n), want)
            log(f"  paged_attention   {dname:8s} {n:3d} splits"
                f"{' int8' if int8 else ''}{' (plan)' if n == plan else ''}: "
                f"max|kernel-plain| {err:.3e} (tol {TOL[dname]:g})")
            if err > TOL[dname]:
                raise AssertionError(f"paged {n} splits: error {err}")
    if dtype != torch.bfloat16:
        return
    (x, w_q, sc), _ = qmm_case(torch, qm, dtype, 8, 28672, 8192)
    want = qm.quant_matmul_plain(x, w_q, sc).float()
    plan = qm.planned_splits(x, w_q)
    for n in (1, 3, plan):
        rel = max_err(torch, qm._launch(x, w_q, sc, n), want) / \
            want.abs().max().item()
        log(f"  quant_matmul      {dname:8s} 8x28672x8192 {n:3d} K splits"
            f"{' (plan)' if n == plan else ''}: max|Δ|/max|plain| {rel:.3e} "
            f"(tol {QMM_REL[dname]:g})")
        if rel > QMM_REL[dname]:
            raise AssertionError(f"quant_matmul {n} K splits: error {rel}")


# --------------------------------------------------------------------------- #
# phase 3: the full-width model through the kernels vs the plain versions
# --------------------------------------------------------------------------- #
PLAIN_OPS = {"flash_attention": "_flash_plain",
             "decode_attention": "_decode_plain",
             "paged_attention": "_paged_plain", "rmsnorm": "rmsnorm_plain",
             "categorical": "categorical_plain"}


@contextmanager
def plain_attention(ops, names=("flash_attention", "decode_attention",
                                "paged_attention", "rmsnorm")):
    """Route the named entry points of ``ops`` (by default the layers'
    kernel calls: attention and rmsnorm; ``("categorical",)`` the sampler's
    draw) to the plain versions (the comparison's reference side),
    whatever the tensors' device."""
    saved = {name: getattr(ops, name) for name in names}
    for name in names:
        setattr(ops, name, getattr(ops, PLAIN_OPS[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def phrase_prompt(torch, g, vocab, s, period=6):
    """``s`` tokens repeating one ``period``-token phrase (a templated
    prompt): its tokens crowd the same experts of an MoE layer."""
    phrase = torch.randint(0, vocab, (period,), generator=g, device="cuda")
    return phrase.repeat(-(-s // period))[:s]


def count_drops(torch, layers, p, x, cfg, seq_valid) -> int:
    """Pairs of live tokens that capacity drops in one MoE call, by the
    routing arithmetic recomputed here: ``cap`` over the call's ``B * S``,
    softmax top-k over the float32 router, and each expert keeping its
    first ``cap`` live pairs, so it drops ``max(0, pairs - cap)``."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    cap = max(8, math.ceil(t * m.experts_per_token / m.num_experts
                           * m.capacity_factor))
    flat = layers.rmsnorm(x, p["ln"], cfg.rms_eps).reshape(t, -1)
    idx = torch.topk(torch.softmax(flat.float() @ p["router"], -1),
                     m.experts_per_token).indices
    live = idx if seq_valid is None else idx[seq_valid.reshape(t)]
    load = torch.bincount(live.reshape(-1), minlength=m.num_experts)
    return int((load - cap).clamp_min(0).sum())


@contextmanager
def counting_drops(torch, layers, counter: list):
    """Wrap ``layers.apply_moe``: each call's dropped pairs
    (:func:`count_drops`, on the call's own inputs) go to ``counter``."""
    inner = layers.apply_moe

    def counted(p, x, cfg, seq_valid=None):
        counter.append(count_drops(torch, layers, p, x, cfg, seq_valid))
        return inner(p, x, cfg, seq_valid=seq_valid)

    layers.apply_moe = counted
    try:
        yield counter
    finally:
        layers.apply_moe = inner


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


@contextmanager
def segsum_in_float64(ops):
    """Route ``ops._segsum`` (the SSD's log-space decay matrix, a difference
    of two cumulative sums) through float64, its result cast back: the
    float32 cancellation between the cumulative sums taken out, all else
    unchanged."""
    inner = ops._segsum
    ops._segsum = lambda x: inner(x.double()).to(x.dtype)
    try:
        yield
    finally:
        ops._segsum = inner


@contextmanager
def scaled_queries(ops, factor):
    """A deliberately wrong attention: every attention entry point of
    ``ops`` (whatever it routes to) gets its queries times ``factor``,
    i.e. a softmax scale ``factor`` times the right one."""
    names = ("flash_attention", "decode_attention", "paged_attention")
    saved = {name: getattr(ops, name) for name in names}
    for name, fn in saved.items():
        setattr(ops, name, lambda q, *a, _fn=fn, **k: _fn(q * factor, *a,
                                                          **k))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextmanager
def skipped_norm(ops, index, per_forward):
    """A deliberately wrong rmsnorm: call ``index`` of every forward's
    ``per_forward`` calls returns its input unchanged."""
    inner, calls = ops.rmsnorm, [0]

    def norm(x, w, eps=1e-5):
        calls[0] += 1
        return x if (calls[0] - 1) % per_forward == index else inner(x, w,
                                                                     eps)
    ops.rmsnorm = norm
    try:
        yield
    finally:
        ops.rmsnorm = inner


def check_model(torch, ns, cfg, *, lengths=(300, 257), cache_len=512,
                chunk=None, window=None, phrase_row=False, reprefill=False,
                recurrent=False, step_tol=(1e-3, 1e-3), params=None,
                compare_fn=compare, mutants=()):
    """``cfg`` (float32 unless a caller's bf16 ``compare_fn`` holds it)
    with seeded random weights (or ``params``): a resume-prefill of 2
    rows of ``lengths`` tokens (in ``chunk``-token resume chunks, or one
    call), then 8 decode steps, through the kernels and through the plain
    versions, over the dense ring and over a 16-token-page arena; the paged
    run also against the dense one through the kernels.  ``phrase_row``:
    row 1 repeats one phrase (:func:`phrase_prompt`).  ``reprefill``: the
    prompt + the 8 decoded tokens prefilled as one sequence, the way a
    preempted request whose snapshot was lost resumes, must give the 8th
    decode step's logits (dense and paged) through the kernels.
    ``recurrent`` (a Mamba model, whose state a prefill carries from chunk
    to chunk): also, through the kernels, the chunked prefill against one
    prefill call, each of the 8 decode steps against a prefill of the
    prompt + the tokens fed so far (the chunked SSD scan) to
    ``step_tol[0]``, and again with the SSD's decay matrix in float64
    (:func:`segsum_in_float64`) to ``step_tol[1]``, and the right-padded
    row 1 against the same row prefilled alone.  ``mutants``: (label, context manager
    factory) pairs, each a deliberately wrong plain path whose dense logits
    are read against the plain ones.  Returns a record: the pairs that
    capacity dropped in the kernels' dense prefill of an MoE model
    (:func:`count_drops`), the decode-vs-prefill gaps of a recurrent one,
    each mutant's reading."""
    torch_ops, layers = ns.ops, ns.layers
    model = ns.Model(cfg)
    if params is None:
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, s = len(lengths), max(lengths)
    chunk = chunk or s
    padded = -(-s // chunk) * chunk
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, padded), generator=g,
                           device="cuda")
    if phrase_row:
        tokens[1] = phrase_prompt(torch, g, cfg.vocab_size, padded)
    lengths = torch.tensor(lengths, device="cuda")
    if int(lengths.min()) <= padded - chunk:
        raise ValueError("every row must end in the last prefill chunk")

    def prefill(rows, step):
        """The rows' prompts prefilled in ``step``-token resume calls:
        (the last real token's logits, the cache)."""
        n = len(rows)
        cache = ns.init_cache(cfg, n, cache_len, device="cuda")
        lens = lengths[rows]
        for c0 in range(0, padded, step):
            pos = (c0 + torch.arange(step, device="cuda"))[None].expand(
                n, step)
            out = model.apply(params, tokens[rows, c0:c0 + step],
                              mode="prefill", positions=pos, cache=cache,
                              resume=True, seq_valid=pos < lens[:, None],
                              window=window,
                              last_idx=(lens - 1 - c0).clamp(0, step - 1))
        return out.logits[:, 0], cache

    def run(feed, paged):
        """Prefill, then 8 decode steps fed ``feed`` (or, with None, the
        path's own greedy tokens, which are returned): over the dense ring,
        or (``paged``) with the prefilled rows committed to a 16-token-page
        arena and every decode step read through its page table."""
        first, cache = prefill(list(range(b)), chunk)
        logits = [first]
        kw = {}
        if paged:
            pool = ns.PagedKVPool(cfg, b, cache_len, page_size=16,
                                  dtype=getattr(torch, cfg.dtype),
                                  device="cuda")
            slots = [pool.allocate() for _ in range(b)]
            pool.insert_many(slots, [ns.slice_cache_row(cache, i)
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
                              positions=pos[:, None], cache=cache,
                              window=window, **kw)
            logits.append(out.logits[:, 0])
            pos = pos + 1
        return torch.stack(logits).float(), toks

    def resume_prefill(fed):
        """Each row's prompt + ``fed`` (its first decoded tokens) as one
        sequence, prefilled in one call: the last position's logits."""
        n = len(fed)
        seq = torch.cat([tokens[:, :s], torch.zeros_like(tokens[:, :n])], 1)
        rows = torch.arange(b, device="cuda")
        for i, tok in enumerate(fed):
            seq[rows, lengths + i] = tok
        cache = ns.init_cache(cfg, b, cache_len, device="cuda")
        pos = torch.arange(s + n, device="cuda")[None].expand(b, s + n)
        return model.apply(params, seq, mode="prefill", positions=pos,
                           cache=cache, resume=True, window=window,
                           seq_valid=pos < (lengths + n)[:, None],
                           last_idx=lengths + n - 1).logits[:, 0]

    kinds = cfg.layer_kinds()
    log(f"  {cfg.name} {cfg.dtype}, {cfg.num_layers} layers "
        f"{'+'.join(kinds)} (published widths): prefill {b}x"
        f"{lengths.tolist()}{f' in {chunk}-token chunks' if chunk < s else ''}"
        f"{f', window {window}' if window else ''} over a {cache_len}-slot "
        f"ring + 8 decode steps")
    drops, rec = [], {}
    with torch.no_grad():
        with counting_drops(torch, layers, drops):
            kern, fed = run(None, paged=False)
        paged, _ = run(fed, paged=True)
        with plain_attention(torch_ops):
            plain, _ = run(fed, paged=False)
            paged_plain, _ = run(fed, paged=True)
            wrong = {}
            for label, mutant in mutants:
                with mutant():
                    wrong[label] = run(fed, paged=False)[0]
        resumed = resume_prefill(fed) if reprefill else None
        if recurrent:
            one_call = prefill(list(range(b)), padded)[0]
            per_step = [resume_prefill(fed[:n]) for n in range(1, 9)]
            alone = prefill([1], chunk)[0]
            with segsum_in_float64(torch_ops):
                kern64, _ = run(fed, paged=False)
                per_step64 = [resume_prefill(fed[:n]) for n in range(1, 9)]
    torch.cuda.synchronize()
    compare_fn(torch, "dense, kernels vs plain", kern, plain)
    compare_fn(torch, "paged, kernels vs plain", paged, paged_plain)
    compare_fn(torch, "paged vs dense, both through the kernels", paged,
               kern)
    if reprefill:
        compare_fn(torch, "re-prefill of prompt + 8 tokens vs decode step "
                   "8, dense", resumed, kern[8])
        compare_fn(torch, "re-prefill of prompt + 8 tokens vs decode step "
                   "8, paged", resumed, paged[8])
    if recurrent:
        compare_fn(torch, f"prefill in {chunk}-token chunks vs one call",
                   kern[0], one_call)
        gaps = {"as_ported": [], "segsum_float64": []}
        for n, (want, want64) in enumerate(zip(per_step, per_step64), 1):
            gaps["as_ported"].append(max_err(torch, kern[n], want))
            gaps["segsum_float64"].append(max_err(torch, kern64[n], want64))
            compare_fn(torch, f"decode step {n} vs a prefill of prompt + "
                       f"{n} tokens", kern[n], want, tol=step_tol[0])
            compare_fn(torch, f"the same, decay matrix in float64",
                       kern64[n], want64, tol=step_tol[1])
        compare_fn(torch, "right-padded row 1 inside the wave vs alone",
                   kern[0, 1:], alone)
        rec["decode_vs_prefill"] = gaps
        log(f"  decode step vs prefill, largest gap as ported "
            f"{max(gaps['as_ported']):.3e}, with the decay matrix in float64 "
            f"{max(gaps['segsum_float64']):.3e}")
    if mutants:
        scale = plain.abs().max().item()
        rec["mutants"] = {
            label: {"max_abs_err": max_err(torch, got, plain),
                    "rel_to_logit_scale": max_err(torch, got, plain) / scale,
                    "argmax_agree": int((got.argmax(-1)
                                         == plain.argmax(-1)).sum()),
                    "positions": got.shape[0] * got.shape[1]}
            for label, got in wrong.items()}
        for label, r in rec["mutants"].items():
            log(f"  deliberately wrong plain path, {label}: max|Δlogit| "
                f"{r['max_abs_err']:.3e} ({r['rel_to_logit_scale']:.4f} of "
                f"the logit scale), argmax equal at {r['argmax_agree']}/"
                f"{r['positions']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    moe_layers = sum(k.endswith("moe") for k in kinds)
    if moe_layers:
        rec["dropped"] = sum(drops[:len(range(0, padded, chunk))
                                   * moe_layers])
    return rec


class CapturingModel:
    """A model whose ``apply`` keeps the logits of its last call (the
    verify round returns tokens; phase 3 holds its logits too)."""

    def __init__(self, model):
        self.model, self.logits = model, None

    def apply(self, *args, **kw):
        out = self.model.apply(*args, **kw)
        self.logits = out.logits
        return out


def check_verify(torch, model, params, cache, last, lengths, *, what,
                 cache_len, page_size=0, ctx_valid=None, spec_k=4):
    """A speculative verify round over ``[last, d_0 .. d_3]`` through the
    kernels (float32), ``d`` the model's own next greedy tokens, against
    ``spec_k + 1`` sequential decode steps from the same prefilled
    ``cache`` (a dense tree, or a paged arena with its ``page_table``):
    logits at every position within 1e-3 with argmax equal, every draft
    accepted and the cells kept; then a round whose rows carry a wrong
    draft (row 0 at d_3, row 1 at d_1) must accept the prefix before it,
    emit the target's token there, and leave every cell past the
    accepted prefix as it was before the round (bit for bit)."""
    from repro_torch.core.kv_cache import (admit_decode_state, gather_cells,
                                           init_decode_state, restore_cells)
    from repro_torch.core.spec_decode import (build_spec_verify_fn,
                                              stage_drafts)
    from repro_torch.models.model import tree_leaves, tree_map
    paged = "page_table" in cache
    b = last.shape[0]
    rows = torch.arange(b, device="cuda")
    kw = {}
    if paged:
        kw = dict(page_table=cache["page_table"],
                  slot_active=torch.ones(b, dtype=torch.bool, device="cuda"))
    if ctx_valid is not None:
        kw["ctx_valid"] = ctx_valid
    seq_cache = tree_map(torch.clone, cache)
    if paged:
        kw["page_table"] = seq_cache["page_table"]
    seq_logits, fed, tok, pos = [], [last], last, lengths.clone()
    for _ in range(spec_k + 1):
        out = model.apply(params, tok[:, None], mode="decode",
                          positions=pos[:, None], cache=seq_cache, **kw)
        seq_logits.append(out.logits[:, 0])
        tok = out.logits[:, 0].argmax(-1)
        fed.append(tok)
        pos = pos + 1
    want = torch.stack(seq_logits, 1)                   # [B, S, V]
    drafts = torch.stack(fed[1:spec_k + 1], 1)          # [B, k]

    capture = CapturingModel(model)
    verify = build_spec_verify_fn(capture, use_ctx=ctx_valid is not None,
                                  n_top=1, paged=paged, cache_len=cache_len,
                                  page_size=page_size)

    def round_(stage):
        work = tree_map(torch.clone, cache)
        st = init_decode_state(b, 1, spec_k=spec_k,
                               ctx_len=0 if ctx_valid is None
                               else ctx_valid.shape[1], device="cuda")
        admit_decode_state(st, list(range(b)), last_token=last.tolist(),
                           positions=lengths.tolist(), temps=[0.0] * b,
                           top_p=[1.0] * b, top_k=[0] * b, min_p=[0.0] * b,
                           sample_key=[[0, 0]] * b, budget=[100] * b,
                           active=[True] * b,
                           **({} if ctx_valid is None
                              else {"ctx_valid": ctx_valid.cpu().numpy()}))
        stage_drafts(st, stage, [spec_k] * b)
        emit, n_acc, n_emit, _ = verify(params, work, st, spec_k=spec_k)
        return work, emit.T, n_acc, n_emit

    full, emit, n_acc, n_emit = round_(drafts)
    torch.cuda.synchronize()
    err = max_err(torch, capture.logits, want)
    compare(torch, f"{what}: verify over [last, d_0..d_3] vs 5 sequential "
            "decode steps", capture.logits.float(), want.float())
    if n_acc.tolist() != [spec_k] * b or \
            not torch.equal(emit, torch.stack(fed[1:], 1)):
        raise AssertionError(f"{what}: all-correct drafts accepted "
                             f"{n_acc.tolist()}, emitted {emit.tolist()}")
    kept = max(max_err(torch, a, w) for a, w in zip(
        tree_leaves(full), tree_leaves(seq_cache)))
    wrong = drafts.clone()
    bad_at = [spec_k - 1, 1][:b]
    for r, j in enumerate(bad_at):
        wrong[r, j] = (wrong[r, j] + 1) % model.cfg.vocab_size
    got, emit, n_acc, n_emit = round_(wrong)
    if n_acc.tolist() != bad_at or n_emit.tolist() != [j + 1 for j in bad_at]:
        raise AssertionError(f"{what}: a wrong draft at {bad_at} accepted "
                             f"{n_acc.tolist()}, emitted {n_emit.tolist()}")
    for r, j in enumerate(bad_at):
        if emit[r, :j + 1].tolist() != [int(t[r]) for t in fed[1:j + 2]]:
            raise AssertionError(f"{what}: row {r} emitted "
                                 f"{emit[r].tolist()}")
    # put the kept cells (positions p0 .. p0 + n_emit - 1) back to their
    # pre-round values; then the whole cache must equal the pre-round one
    jidx = torch.arange(spec_k + 1, device="cuda")[None]
    ring = (lengths[:, None] + jidx) % cache_len
    if paged:
        r_idx = got["page_table"][rows[:, None], ring // page_size].long()
        c_idx = ring % page_size
        names = ("k", "v", "k_scale", "v_scale")
    else:
        r_idx, c_idx, names = rows[:, None].expand_as(ring), ring, ("k", "v")
    restore_cells(got, gather_cells(cache, r_idx, c_idx, names), r_idx,
                  c_idx, jidx >= n_emit[:, None])
    same = all(torch.equal(a, w) for a, w in zip(tree_leaves(got),
                                                 tree_leaves(cache)))
    log(f"  {what}: all-correct drafts accepted {spec_k} a row, kept cells "
        f"vs sequential max|Δ| {kept:.3e}; wrong draft at {bad_at}: "
        f"accepted {n_acc.tolist()}, emitted {n_emit.tolist()}, cells past "
        f"the accepted prefix restored bit for bit: {same}")
    if not same or kept > 1e-3:
        raise AssertionError(f"{what}: rollback failed (restored {same}, "
                             f"kept cells {kept})")
    return {"max_abs_err": err, "kept_cells_err": kept}


def check_model_verify(torch, ns, cfg, *, lengths=(300, 257), cache_len=512):
    """Phase 3's verify check on ``cfg`` (float32, seeded weights): a
    resume-prefill of 2 rows, then :func:`check_verify` over the dense
    ring and over a 16-token-page arena."""
    model = ns.Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, s = len(lengths), max(lengths)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device="cuda")
    lengths = torch.tensor(lengths, device="cuda")
    out = {}
    with torch.no_grad():
        for paged in (False, True):
            cache = ns.init_cache(cfg, b, cache_len, device="cuda")
            pos = torch.arange(s, device="cuda")[None].expand(b, s)
            last = model.apply(params, tokens, mode="prefill", positions=pos,
                               cache=cache, resume=True,
                               seq_valid=pos < lengths[:, None],
                               last_idx=lengths - 1).logits[:, 0].argmax(-1)
            if paged:
                pool = ns.PagedKVPool(cfg, b, cache_len, page_size=16,
                                      dtype=torch.float32, device="cuda")
                slots = [pool.allocate() for _ in range(b)]
                pool.insert_many(slots, [ns.slice_cache_row(cache, i)
                                         for i in range(b)],
                                 consumed=lengths.tolist())
                assert pool.ensure_decode_capacity(
                    dict(zip(slots, lengths.tolist())), 5)
                cache = pool.cache
            label = f"{cfg.name} {'paged' if paged else 'dense'}"
            out["paged" if paged else "dense"] = check_verify(
                torch, model, params, cache, last, lengths, what=label,
                cache_len=cache_len, page_size=16 if paged else 0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def check_cross_model(torch, ops, init_cache, model, params, *, what,
                      media_kw, draw_media, cache_len=512):
    """A model with cross-attention in float32: a prefill of 2 rows (300
    and 257 tokens) over the context ``draw_media(g, b)`` gives (passed as
    ``media_kw``, with its liveness), the same prefill with the cross KV
    injected (``cross_cached``), 8 decode steps; kernels vs plain, and the
    fresh prefill equal to the cross-cached one.  Returns the inputs and
    the prefill, for the caller's further checks."""
    cfg = model.cfg
    b, s = 2, 300
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device="cuda")
    lengths = torch.tensor([s, 257], device="cuda")
    seq_valid = torch.arange(s, device="cuda")[None] < lengths[:, None]
    positions = torch.arange(s, device="cuda")[None].expand(b, s)
    media, ctx_valid = draw_media(g, b)
    ctx = ctx_valid.shape[1]
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
        logits = [prefill(fresh, **{media_kw: media})]
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

    with torch.no_grad():
        kern, kern_cached, fed = run(None)
        with plain_attention(ops):
            plain, plain_cached, _ = run(fed)
    torch.cuda.synchronize()
    compare(torch, f"{what}, kernels vs plain", kern, plain)
    compare(torch, f"{what} cross-cached prefill, kernels vs plain",
            kern_cached, plain_cached)
    same = max_err(torch, kern_cached, kern[0])
    log(f"  fresh vs cross-cached prefill logits through the kernels: "
        f"max|Δ| {same:.3e}")
    if same > 1e-6:
        raise AssertionError(f"{what} cross-cached prefill differs: {same}")
    return types.SimpleNamespace(prefill=prefill, media=media, b=b, ctx=ctx,
                                 lengths=lengths, ctx_valid=ctx_valid)


def check_vision_model(torch, ops, get_config, Model, init_cache):
    """5 layers of llama-3.2-vision-90b (4 self-attn + 1 cross-attn) in
    float32 with images through :func:`check_cross_model`; another image
    must move the logits; then a speculative verify round through the
    cross-attention S > 1 branch (:func:`check_verify`), whose record is
    returned."""
    cfg = vision_config(get_config, 5, "float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    open_gates(torch, params)
    ctx, cache_len = CROSS["ctx"], 512

    def images(g, b):
        embeds = torch.rand((b, ctx, cfg.vision.embed_dim), generator=g,
                            device="cuda") * 2 - 1
        return embeds, torch.arange(ctx, device="cuda")[None] < torch.tensor(
            [[ctx], [ctx // 4]], device="cuda")

    log(f"  {VISION} float32, {cfg.num_layers} layers "
        f"{''.join('x' if k == 'xattn' else 'a' for k in cfg.layer_kinds())}"
        f" (published widths, depth cut), gates {GATE}: prefill 2x300 "
        f"over a {ctx}-slot context, cross-cached prefill, 8 decode steps")
    run = check_cross_model(torch, ops, init_cache, model, params,
                            what="vision", media_kw="image_embeds",
                            draw_media=images, cache_len=cache_len)
    with torch.no_grad():
        image_moves_logits(torch, model, params, init_cache, ctx,
                           "5-layer float32")
        cache = init_cache(cfg, run.b, cache_len, ctx_len=ctx, device="cuda")
        last = run.prefill(cache, image_embeds=run.media).argmax(-1)
        verify = check_verify(torch, model, params, cache, last, run.lengths,
                              what=f"{VISION} 5 layers, cross S > 1",
                              cache_len=cache_len, ctx_valid=run.ctx_valid)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return verify


def check_audio_model(torch, ops, get_config, Model, init_cache):
    """``seamless-m4t-medium`` at full depth (12 encoder + 12 decoder
    layers) in float32 with random frame embeddings through
    :func:`check_cross_model`: the fresh prefills run the encoder, the
    cross-cached ones do not (self and cross attention of the decode steps
    through the decode kernel)."""
    cfg = dataclasses.replace(get_config(AUDIO), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ctx = cfg.audio.num_frames
    encoded = []
    real_encode = model.encode_audio

    def counted_encode(*a):
        encoded.append(1)
        return real_encode(*a)

    object.__setattr__(model, "encode_audio", counted_encode)

    def frames(g, b):
        return (torch.randn((b, ctx, cfg.audio.embed_dim), generator=g,
                            device="cuda"),
                torch.ones((b, ctx), dtype=torch.bool, device="cuda"))

    log(f"  {AUDIO} float32, {cfg.audio.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers (published widths, full depth): "
        f"prefill 2x[300, 257] over {ctx} encoder frames, cross-cached "
        f"prefill, 8 decode steps")
    check_cross_model(torch, ops, init_cache, model, params, what="audio",
                      media_kw="audio_frames", draw_media=frames)
    if len(encoded) != 2:
        raise AssertionError(f"the encoder ran {len(encoded)} times for 2 "
                             "fresh and 2 cross-cached prefills")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def jamba_config(get_config):
    """``jamba-1.5-large-398b`` at published widths in bf16, depth cut to
    5 layers: ssm, ssm_moe, ssm, ssm_moe, attn (one of each kind)."""
    return dataclasses.replace(get_config(JAMBA), num_layers=JAMBA_LAYERS,
                               dtype="bfloat16")


def near_tie_compare(rel, records):
    """A bf16 comparison for :func:`check_model`: logits within ``rel``
    times the largest reference logit, and the argmax equal wherever the
    reference's top-2 gap exceeds that tolerance (the positions under it
    are counted); each comparison's record goes to ``records``."""
    def cmp(torch, what, got, want, tol=None):
        scale = want.abs().max().item()
        limit = rel * scale
        err = max_err(torch, got, want)
        top2 = want.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        agree = got.argmax(-1) == want.argmax(-1)
        rec = records[what] = {
            "max_abs_err": err, "tol": limit, "tol_rel": rel,
            "logit_scale": scale, "positions": agree.numel(),
            "argmax_agree": int(agree.sum()),
            "near_ties": int((gap <= limit).sum()),
            "argmax_disagree_past_tol": int((~agree & (gap > limit)).sum())}
        log(f"  {what}: max|Δlogit| {err:.3e} (tol {limit:.3e} = {rel:g} x "
            f"the largest logit {scale:.3e}), argmax equal at "
            f"{rec['argmax_agree']}/{rec['positions']} positions, "
            f"{rec['near_ties']} with a top-2 gap <= tol, "
            f"{rec['argmax_disagree_past_tol']} disagreeing past it")
        if err > limit or rec["argmax_disagree_past_tol"] or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: {rec}")
    return cmp


def check_jamba_model(torch, ns, cfg, params):
    """The 5-layer jamba in bf16 (float32 needs ~96 GB) through
    :func:`check_model` (2 rows of 300 and 257 tokens, one a repeated
    phrase, in 256-token chunks, 8 decode steps, dense ring and pages,
    kernels against plain versions) held by :func:`near_tie_compare` at
    :data:`JAMBA_TOL`; two deliberately wrong plain paths read against the
    same limit (a 2 % and a 25 % softmax scale error in the attention
    layer, read; its input rmsnorm skipped, which the limit must catch).  Then one served prefill wave's memory.
    Returns the record, with the (token, expert) pairs capacity dropped in
    the kernels' prefill."""
    attn_norm = input_norm_index(cfg, cfg.layer_kinds().index("attn"))
    per_forward = rmsnorm_per_forward(cfg)
    compared = {}
    rec = check_model(
        torch, ns, cfg, chunk=256, phrase_row=True, params=params,
        compare_fn=near_tie_compare(JAMBA_TOL, compared),
        mutants=(("softmax scale x 1.02",
                  lambda: scaled_queries(ns.ops, 1.02)),
                 ("softmax scale x 1.25",
                  lambda: scaled_queries(ns.ops, 1.25)),
                 (SKIPPED_NORM,
                  lambda: skipped_norm(ns.ops, attn_norm, per_forward))))
    rec["compared"] = compared
    for label, r in rec["mutants"].items():
        r["caught"] = r["max_abs_err"] > JAMBA_TOL * compared[
            "dense, kernels vs plain"]["logit_scale"]
    log(f"  {JAMBA}: capacity dropped {rec['dropped']} (token, expert) "
        f"pairs in the prefill; wrong paths past the limit: "
        f"{ {k: r['caught'] for k, r in rec['mutants'].items()} }")
    if not rec["mutants"][SKIPPED_NORM]["caught"]:
        raise AssertionError("the jamba limit does not see a skipped norm")
    g = torch.Generator(device="cuda").manual_seed(2)
    model = ns.Model(cfg)
    # one full prefill wave of the served shape (8 rows x 512 tokens over a
    # 2048-slot cache), through the kernels: its memory above the weights
    cache = ns.init_cache(cfg, 8, 2048, device="cuda")
    wave = torch.randint(0, cfg.vocab_size, (8, 512), generator=g,
                         device="cuda")
    pos = torch.arange(512, device="cuda")[None].expand(8, 512)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model.apply(params, wave, mode="prefill", positions=pos, cache=cache,
                    resume=True,
                    seq_valid=torch.ones_like(wave, dtype=torch.bool),
                    last_idx=torch.full((8,), 511, device="cuda"))
    torch.cuda.synchronize()
    rec["wave_8x512_peak_gib_over_resident"] = (
        torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"  one 8 x 512 prefill wave: peak "
        f"{rec['wave_8x512_peak_gib_over_resident']:.3f} GiB above the "
        f"{base / 2**30:.2f} GiB resident (weights + its 8-row cache)")
    del cache
    if not rec["dropped"]:
        raise AssertionError("the jamba prefill dropped no pair: the "
                             "capacity path did not run")
    return rec


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


def prompt_text(kind, body) -> str:
    """The text the server tokenizes for one body (the chat template of
    ``serving/api.py``)."""
    if kind == "chat":
        return "".join(f"<|{m['role']}|>{m['content']}"
                       for m in body["messages"]) + "<|assistant|>"
    return body["prompt"]


def check_response(kind, body, resp, tok) -> int:
    """Check finish_reason and usage of one response; returns its
    completion tokens."""
    want_prompt = len(tok.encode(prompt_text(kind, body)))
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
                  profile=True, arch="qwen2-0.5b", profile_ops=None,
                  params=None, responses=None, cfg=None, requests=None,
                  ordered=False, **engine_kw):
    """Serve ``arch`` (bf16, published widths, seeded random weights) and
    ``bodies`` ``rounds`` times (the first takes the first-call costs; the
    last is the counted one) and once more under the profiler
    (``profile_ops``: then the engine alone once more, through the callable
    ``profile_ops(torch, engine, bodies)``).  ``wrappers`` maps each
    kernel's name to its CUDA wrapper, whose ``launches`` count is zeroed
    just before the counted round and read just after.  ``params``: the model's weights,
    made by the engine from its seed when None.  ``responses``: a list the
    counted round's responses go to.  ``cfg``: the model's config when
    not ``get_config(arch)`` (a depth cut).  ``requests``: a list every
    round's engine requests go to, in arrival order.  ``ordered``: each
    round's bodies reach the engine one after another in their order while
    its loop is held (:func:`hold_engine`), which is released once all are
    queued, so the first step sees every request and the waves and decode
    steps follow the bodies alone, not the client threads' timing.
    Returns (launches, serve record, /stats after the counted round,
    engine layers)."""
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg or get_config(arch), params, device="cuda",
                             max_batch=8, cache_len=2048, prefill_chunk=512,
                             seed=0, **engine_kw)
    seen = [] if requests is None else requests
    real_add = engine.add_request

    def add_request(req):
        seen.append(req)
        return real_add(req)
    engine.add_request = add_request
    gate = hold_engine(engine) if ordered else None
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    client = EngineClient(engine)
    server = ApiServer(OpenAIServer(client, arch), host="127.0.0.1",
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
        if gate is not None:
            gate.clear()
        for t in threads:
            queued = len(seen)
            t.start()
            if gate is not None:
                wait_for(lambda: len(seen) > queued, "a request queued",
                         timeout=60, phase="ordered round")
        if gate is not None:
            gate.set()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = 0
        for (kind, body), resp in zip(bodies, results):
            if resp is None or isinstance(resp, Exception):
                raise AssertionError(f"request {body} failed: {resp!r}")
            done += check_response(kind, body, resp, tok)
        if responses is not None:
            responses[:] = results
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
    if profile_ops is not None:
        prof = prof or {}
        prof["engine_alone"] = profile_ops(torch, engine, bodies[:6])
    stats = {k: after[k] - before[k] for k in
             ("retired", "aborted", "prefill_waves", "device_steps")}
    spec = ({k: after["speculation"][k] - before["speculation"][k]
             for k in SPEC_COUNTERS}
            if engine_kw.get("spec_mode", "off") != "off" else None)
    if stats["retired"] != len(bodies) or stats["aborted"]:
        raise AssertionError(f"engine counters disagree: {stats}")
    layers = engine.cfg.num_layers
    log(f"  {len(bodies)} requests finished with correct usage: {done} "
        f"completion tokens in {wall:.3f} s ({done / wall:.1f} tokens/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first "
        f"round {cold_wall} s), "
        f"{stats['prefill_waves']} prefill waves, "
        f"{stats['device_steps']} decode steps, launches {launches} "
        f"({layers} per decode step / prefill wave)")
    serve = {"arch": arch, "layers": layers, "init_s": init_s,
             "requests": len(bodies), "completion_tokens": done,
             "wall_s": wall, "tokens_per_s": done / wall,
             "first_round_wall_s": cold_wall,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "prefill_waves": stats["prefill_waves"],
             "decode_steps": stats["device_steps"], "launches": launches,
             "max_batch": 8, "cache_len": 2048, "dtype": "bfloat16",
             **engine_kw, "profiled_round": prof,
             "prefix_evictions": (engine.prefix_cache.stats.evictions
                                  if engine.prefix_cache else None)}
    if spec is not None:
        serve["speculation"] = spec
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


def require_rmsnorm(launches, serve, layers):
    """The counted round's rmsnorm launches: 2 per layer (before attention
    and before the MLP) + 1 (the final norm) per forward, one forward per
    decode step and per prefill wave."""
    want = (2 * layers + 1) * (serve["decode_steps"] + serve["prefill_waves"])
    if launches["rmsnorm"] != want or not want:
        raise AssertionError(f"rmsnorm launches {launches['rmsnorm']}, want "
                             f"{want}")


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
# phase 4i: speculative decoding
# --------------------------------------------------------------------------- #
SPEC_K = 4
SPEC_COUNTERS = ("rounds", "tokens_drafted", "tokens_accepted",
                 "tokens_rejected", "tokens_emitted")


def repetition_bodies():
    """6 repetition-heavy requests (code, a table, a refrain): prompt
    lookup finds their trailing n-grams earlier in the context."""
    texts = ["def f(x):\n    return x + 1\n" * 6,
             "| id | name | qty |\n| 1 | bolt | 10 |\n" * 5,
             "row row row your boat, gently down the stream. " * 6,
             "for i in range(10):\n    print(i)\n" * 6,
             "<item><key>a</key><value>1</value></item>\n" * 5,
             "the cat sat on the mat and the cat sat on the mat " * 5]
    return [("chat" if i % 2 else "completion",
             ({"messages": [{"role": "user", "content": t}]} if i % 2
              else {"prompt": t}) | {"max_tokens": 64})
            for i, t in enumerate(texts)]


def require_spec_launches(launches, rec, layers, *, decode_kernel, unused,
                          draft_layers=0, draft_prefills=0):
    """A spec round's launches: ``decode_kernel`` once per layer per block
    decode step and ``spec_k + 1`` times per layer per verify round (plus
    ``spec_k`` per draft layer per draft round on the dense decode kernel),
    flash once per layer per prefill wave (plus one per draft layer per
    prime prefill), ``unused`` never."""
    spec = rec["speculation"]
    rounds = spec["rounds"]
    blocks = rec["decode_steps"] - rounds
    want = {decode_kernel: layers * (blocks + (SPEC_K + 1) * rounds),
            "flash_attention": layers * rec["prefill_waves"]
            + draft_layers * draft_prefills, unused: 0}
    want["decode_attention"] = want.get("decode_attention", 0) + \
        draft_layers * SPEC_K * rounds
    if any(launches[name] != n for name, n in want.items()) or \
            rounds <= 0:
        raise AssertionError(f"spec launch counts {launches}, want {want} "
                             f"({blocks} block steps, {rounds} rounds)")
    return want


def spec_reading(rec) -> dict:
    """Acceptance, accepted tokens a round and forwards per emitted token
    of one counted spec round."""
    sp = rec["speculation"]
    if sp["tokens_drafted"] != sp["tokens_accepted"] + sp["tokens_rejected"]:
        raise AssertionError(f"spec counters do not add up: {sp}")
    return {"acceptance": sp["tokens_accepted"] / max(sp["tokens_drafted"], 1),
            "accepted_per_round": sp["tokens_accepted"] / max(sp["rounds"], 1),
            "device_steps": rec["decode_steps"],
            "completion_tokens": rec["completion_tokens"]}


def check_spec_serving(torch, serving, params):
    """4i-a/b: ``qwen2-0.5b`` (bf16, 24 layers) serving the 4a mix plus 6
    repetition-heavy requests with ``spec_mode="ngram"``, ``spec_k`` 4,
    beside the same rounds with spec off — on the dense ring (a) and on
    16-token fp pages with the prefix cache on (b).  Every request
    finishes with the right usage, rounds > 0, tokens_accepted > 0 and
    drafted = accepted + rejected; the kernels run exactly as counted; on
    pages no page stays pinned, every page is free or a cache lease, and
    no full copy is made.  Reads the share of texts equal to spec off,
    tokens/s of both, accepted tokens a round, and forwards against
    emitted tokens."""
    bodies = serve_requests() + repetition_bodies()
    out = {}
    for label, layout in (("a_dense", {}),
                          ("b_paged", dict(kv_layout="paged",
                                           kv_page_size=16))):
        runs = {}
        for mode in ("off", "ngram"):
            responses = []
            spec = ({} if mode == "off"
                    else dict(spec_mode="ngram", spec_k=SPEC_K))
            launches, rec, stats, layers = check_serving(
                *serving, bodies=bodies, profile=False, params=params,
                responses=responses, **layout, **spec)
            kern, other = (("paged_attention", "decode_attention") if layout
                           else ("decode_attention", "paged_attention"))
            if mode == "off":
                require_launches(launches, rec, layers, decode_kernel=kern,
                                 unused=other)
            else:
                require_spec_launches(launches, rec, layers,
                                      decode_kernel=kern, unused=other)
                rec["reading"] = spec_reading(rec)
                if rec["speculation"]["tokens_accepted"] <= 0:
                    raise AssertionError(f"4i {label}: no draft accepted: "
                                         f"{rec['speculation']}")
            if layout:
                pages = stats["kv_pages"]
                rec["kv_pages"] = pages
                if pages["pinned"] or pages["full_copies"] or \
                        pages["free"] + pages["reclaimable"] != pages["total"]:
                    raise AssertionError(f"4i {label} {mode}: pages {pages}")
            rec["texts"] = [text_of(b, r) for (_, b), r in
                            zip(bodies, responses)]
            runs[mode] = rec
        same = [a == b for a, b in zip(runs["off"].pop("texts"),
                                       runs["ngram"].pop("texts"))]
        on, off = runs["ngram"], runs["off"]
        rd = on["reading"]
        log(f"  4i-{label}: spec {on['speculation']}; acceptance "
            f"{rd['acceptance']:.3f}, {rd['accepted_per_round']:.2f} "
            f"accepted a round (all slots); {on['decode_steps']} forwards "
            f"for {on['completion_tokens']} tokens (spec off "
            f"{off['decode_steps']} for {off['completion_tokens']}); "
            f"{on['tokens_per_s']:.1f} tokens/s vs {off['tokens_per_s']:.1f} "
            f"off; texts equal to spec off {sum(same)}/{len(same)}")
        out[label] = {"identical_share": sum(same) / len(same), **runs}
    return out


def row_drift(torch, params, cfg, rows=8, s=SPEC_K + 1) -> dict:
    """Which bf16 products of a decode step give a row another value when
    the call carries more rows: each of layer 0's weight products and the
    LM head on ``rows`` random rows alone against the same rows inside a
    call of ``rows * s`` (a verify forward's M), max |Δ| (0: bit-identical);
    ``rmsnorm_var_rows``, the rows whose float32 ``torch.mean`` of squares
    (the plain rmsnorm's variance) differs between the two calls; and
    ``rmsnorm_kernel_rows``, ``tools/spec_row_drift.py``'s reading 2 through
    ``layers.rmsnorm`` (the row-invariant kernel): of 200 x ``rows`` rows
    in bf16 normalised alone and inside ``rows * s``, how many differ."""
    from repro_torch.models import layers as lyr
    g = torch.Generator(device="cuda").manual_seed(5)
    layer = {k: v[0] for k, v in params["block"]["pos0"]["attn"].items()
             if k.startswith("w")}
    layer.update({k: v[0] for k, v in params["block"]["pos0"]["ffn"].items()})
    layer["lm_head"] = (params["embed"].T if cfg.tie_embeddings
                        else params["lm_head"])
    out = {}
    for name, w in layer.items():
        x = torch.randn((rows * s, w.shape[0]), generator=g, device="cuda",
                        dtype=torch.float32).to(w.dtype)
        out[name] = max_err(torch, x[:rows] @ w, (x @ w)[:rows])
    x = torch.randn((rows, s, cfg.d_model), generator=g, device="cuda")
    out["rmsnorm_var_rows"] = int(
        (torch.mean(x[:, :1].contiguous() ** 2, dim=-1)
         != torch.mean(x * x, dim=-1)[:, :1]).sum())
    w = params["final_ln"]
    differ = 0
    for _ in range(200):
        x = torch.randn((rows, s, cfg.d_model), generator=g,
                        device="cuda").to(w.dtype)
        differ += int((lyr.rmsnorm(x[:, :1].contiguous(), w, cfg.rms_eps)
                       != lyr.rmsnorm(x, w, cfg.rms_eps)[:, :1]
                       ).any(-1).sum())
    out["rmsnorm_kernel_rows"] = [differ, 200 * rows]
    return out


def check_draft_engine(torch, get_config, InferenceEngine, Request,
                       SamplingParams, wrappers, params):
    """4i-c: ``spec_mode="draft"`` with the target's own weights as the
    draft (the reference's oracle test), the engine alone: 8 greedy
    requests (2 of the mix, the 6 repetition-heavy ones) after a warm-up,
    beside the same requests with spec off; greedy acceptance > 0.3; the
    decode kernel runs 24 x (block steps + 5 x rounds) for the target plus
    24 x 4 x rounds for the draft, flash 24 x (prefill waves + the draft's
    prime prefills); a seeded stochastic request replays token for token
    in two runs; ``draft_pool_bytes`` > 0."""
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    cfg = get_config("qwen2-0.5b")
    texts = [prompt_text(k, b) for k, b in
             (serve_requests()[3:5] + repetition_bodies())]

    def reqs(**sp):
        return [Request(prompt_tokens=tok.encode(t),
                        sampling=SamplingParams(max_tokens=64, **sp))
                for t in texts]

    out = {}
    for mode in ("off", "draft"):
        spec = ({} if mode == "off" else
                dict(spec_mode="draft", spec_k=SPEC_K, spec_draft_config=cfg,
                     spec_draft_params=params))
        eng = InferenceEngine(cfg, params, device="cuda", max_batch=8,
                              cache_len=2048, prefill_chunk=512, seed=0,
                              enable_prefix_cache=False, **spec)
        eng.generate(reqs()[:2])                        # warm-up
        sched = eng.scheduler.stats
        before = (sched.device_steps, sched.prefill_waves,
                  eng.speculation_stats(),
                  eng._draft_source.prefills if mode == "draft" else 0)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.generate(reqs())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        n = sum(len(r.output_tokens) for r in done)
        if not all(r.finish_reason is not None for r in done):
            raise AssertionError("4i-c: a request did not finish")
        rec = {"requests": len(done), "completion_tokens": n, "wall_s": wall,
               "tokens_per_s": n / wall,
               "decode_steps": sched.device_steps - before[0],
               "prefill_waves": sched.prefill_waves - before[1],
               "launches": launches,
               "tokens": [r.output_tokens for r in done]}
        if mode == "off":
            require_launches(launches, rec, cfg.num_layers,
                             decode_kernel="decode_attention",
                             unused="paged_attention")
        else:
            sp = eng.speculation_stats()
            rec["speculation"] = {k: sp[k] - before[2][k]
                                  for k in SPEC_COUNTERS}
            rec["draft_prefills"] = eng._draft_source.prefills - before[3]
            rec["draft_pool_bytes"] = sp["draft_pool_bytes"]
            require_spec_launches(
                launches, rec, cfg.num_layers,
                decode_kernel="decode_attention", unused="paged_attention",
                draft_layers=cfg.num_layers,
                draft_prefills=rec["draft_prefills"])
            rec["reading"] = spec_reading(rec)
            if rec["reading"]["acceptance"] <= 0.3 or \
                    sp["draft_pool_bytes"] <= 0:
                raise AssertionError(f"4i-c: acceptance "
                                     f"{rec['reading']['acceptance']}, draft "
                                     f"pool {sp['draft_pool_bytes']} bytes")
            # the seeded replay's draft and correction draws run on the
            # salted streams: twice through the categorical kernel, once
            # with ops.categorical routed to the plain version
            from repro_torch.kernels import ops
            replay, draws = [], []
            for route in ("kernel", "kernel", "plain"):
                r = Request(prompt_tokens=tok.encode(texts[2]),
                            sampling=SamplingParams(max_tokens=48,
                                                    temperature=0.9,
                                                    top_p=0.9, seed=42))
                n0 = wrappers["categorical"].launches
                with (plain_attention(ops, ("categorical",))
                      if route == "plain" else nullcontext()):
                    eng.generate([r])
                replay.append(r.output_tokens)
                draws.append(wrappers["categorical"].launches - n0)
            if any(t != replay[0] for t in replay) or len(replay[0]) != 48 \
                    or not all(draws[:2]) or draws[2]:
                raise AssertionError(f"4i-c: seeded replay differs or the "
                                     f"draws missed the kernel: {replay}, "
                                     f"categorical launches {draws}")
            rec["seeded_replay_identical"] = True
            rec["seeded_replay_categorical_launches"] = draws
        out[mode] = rec
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = [a == b for a, b in zip(out["off"].pop("tokens"),
                                   out["draft"].pop("tokens"))]
    out["row_drift"] = row_drift(torch, params, cfg)
    if out["row_drift"]["rmsnorm_kernel_rows"][0]:
        raise AssertionError(f"4i-c: layers.rmsnorm gives rows another value "
                             f"inside a larger call: {out['row_drift']}")
    on, off = out["draft"], out["off"]
    log(f"  4i-c draft = target weights: spec {on['speculation']}; greedy "
        f"acceptance {on['reading']['acceptance']:.3f}, "
        f"{on['reading']['accepted_per_round']:.2f} accepted a round (all "
        "slots), "
        f"{on['draft_prefills']} prime prefills, draft pool "
        f"{on['draft_pool_bytes'] / 2**20:.1f} MiB; {on['decode_steps']} "
        f"forwards for {on['completion_tokens']} tokens (off "
        f"{off['decode_steps']} for {off['completion_tokens']}); "
        f"{on['tokens_per_s']:.1f} tokens/s vs {off['tokens_per_s']:.1f} "
        f"off; outputs equal to spec off {sum(same)}/{len(same)}; seeded "
        "stochastic replay identical twice through the categorical kernel "
        f"({on['seeded_replay_categorical_launches'][:2]} launches) and "
        "once through its plain version; 8 rows alone vs inside "
        f"{8 * (SPEC_K + 1)} rows: {out['row_drift']}")
    out["identical_share"] = sum(same) / len(same)
    return out


def check_spec_launcher(torch, serve_mod):
    """4i-d: a server built by ``launch/serve.py --spec-mode ngram`` answers
    a chat, a completion and a streamed chat over HTTP with the right
    usage, and its ``/stats`` has the ``speculation`` block."""
    from repro_torch.serving.tokenizer import ByteTokenizer
    args = serve_mod.parse_args(["--arch", "qwen2-0.5b", "--port", "0",
                                 "--cache-len", "2048", "--spec-mode",
                                 "ngram", "--spec-k", str(SPEC_K)])
    srv = serve_mod.build_server(args)
    srv.start()
    try:
        bodies = [b for b in repetition_bodies()[:2]] + [
            ("chat", {"messages": [{"role": "user", "content":
                                    "la la la la la la la la"}],
                      "max_tokens": 32, "stream": True,
                      "stream_options": {"include_usage": True}})]
        tok = ByteTokenizer()
        n = 0
        for kind, body in bodies:
            path = ("/v1/chat/completions" if kind == "chat"
                    else "/v1/completions")
            n += check_response(kind, body, post(srv.port, path, body), tok)
        code, _, stats = http(srv.port, "/stats")
        spec = stats.get("speculation")
        if code != 200 or not spec or spec["mode"] != "ngram" or \
                spec["k"] != SPEC_K:
            raise AssertionError(f"4i-d: /stats speculation block {spec}")
    finally:
        srv.stop()
        srv.api.client.stop()
    log(f"  4i-d: launcher --spec-mode ngram served {len(bodies)} requests "
        f"(one streamed), {n} completion tokens; /stats speculation {spec}")
    return {"completion_tokens": n, "speculation": spec}


# --------------------------------------------------------------------------- #
# phase 4m / 4n: the recurrent and audio families
# --------------------------------------------------------------------------- #
def layer_norms(cfg, kind) -> int:
    """rmsnorm launches of one layer of ``kind`` in a forward, in order:
    one before self-attention and one before an audio decoder's
    cross-attention (or an ``xattn`` layer's), two in a Mamba block (its
    input norm and the gated norm), one before the MoE or the MLP."""
    return ((2 if kind.startswith("ssm") else 1)
            + (cfg.family == "audio" and kind in ("attn", "moe"))
            + (kind.endswith("moe") or cfg.d_ff > 0))


def rmsnorm_per_forward(cfg, encoder=False) -> int:
    """rmsnorm launches of one forward: :func:`layer_norms` of each layer,
    then the final norm.  ``encoder``: the audio encoder's 2 a layer and
    ``enc_ln`` as well."""
    n = 1 + sum(layer_norms(cfg, kind) for kind in cfg.layer_kinds())
    if encoder:
        n += 2 * cfg.audio.encoder_layers + 1
    return n


def input_norm_index(cfg, layer) -> int:
    """The place of layer ``layer``'s input norm among a decoder forward's
    rmsnorm calls."""
    return sum(layer_norms(cfg, kind) for kind in cfg.layer_kinds()[:layer])


def attention_layers(cfg) -> int:
    return sum(k in ("attn", "moe") for k in cfg.layer_kinds())


SSM_OPS = ("ssd_scan", "ssd_decode_step", "causal_conv")


def profile_ssm_ops(torch, engine, bodies) -> dict:
    """The engine alone, in this thread, serving the prompts of ``bodies``
    greedily under ``torch.profiler`` with the host's operators traced:
    the device time under the chunked SSD scan, the SSD decode step and the
    causal conv (each wrapped in a ``record_function`` for this round), of
    the matrix-product kernels and of the rmsnorm kernel, each as a share
    of all device time, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.request import Request, SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    def traced(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    saved = (ops.ssd, ops.ssd_decode_step, layers._causal_conv)
    ops.ssd = traced("ssd_scan", saved[0])
    ops.ssd_decode_step = traced("ssd_decode_step", saved[1])
    layers._causal_conv = traced("causal_conv", saved[2])
    tok = engine.tokenizer
    reqs = [Request(prompt_tokens=tok.encode(prompt_text(kind, body)),
                    sampling=SamplingParams(max_tokens=body["max_tokens"]))
            for kind, body in bodies]
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.generate(reqs)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.ssd, ops.ssd_decode_step, layers._causal_conv = saved
    device_us = 0.0
    part = {k: 0.0 for k in (*SSM_OPS, "gemm", "rmsnorm")}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            if ev.key in SSM_OPS:
                # a record_function range also shows as a device annotation
                # spanning its kernels: counted by its host event instead
                continue
            device_us += ev.self_device_time_total
            kernels.append((ev.self_device_time_total, ev.count, ev.key))
            if any(w in ev.key for w in GEMM_KERNEL_WORDS):
                part["gemm"] += ev.self_device_time_total
            elif "rmsnorm" in ev.key:
                part["rmsnorm"] += ev.self_device_time_total
        elif ev.key in SSM_OPS:
            part[ev.key] += ev.device_time_total
    if device_us <= 0 or part["ssd_scan"] <= 0 or part["rmsnorm"] <= 0 \
            or sum(part.values()) > device_us:
        raise RuntimeError(f"the engine-alone profile recorded {device_us} "
                           f"us of device time, {part} by part")
    out = {"wall_s": wall, "device_busy_share": device_us / 1e6 / wall,
           "completion_tokens": sum(len(r.output_tokens) for r in reqs),
           **{f"{k}_share_of_device": v / device_us for k, v in part.items()}}
    log("  engine alone, host operators traced: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    top = sorted(kernels, reverse=True)[:8]
    out["top_kernels"] = [{"kernel": k[:90], "launches": n,
                           "share_of_device": us / device_us}
                          for us, n, k in top]
    for row in out["top_kernels"]:
        log(f"    {row['share_of_device']:.4f} of device, {row['launches']} "
            f"launches: {row['kernel']}")
    return out


def by_prompt(reqs, n):
    """The requests of each round of ``n`` bodies, keyed by prompt."""
    return [{tuple(r.prompt_tokens): r for r in reqs[i:i + n]}
            for i in range(0, len(reqs) - len(reqs) % n, n)]


def check_ssm_serving(torch, serving, arch, cfg, params, *, what,
                      require_equal, profile_fn=None):
    """4m-a / 4m-c: ``cfg`` (bf16, seeded random weights) serving 4a's 12
    bodies over HTTP twice, on the dense ring and then on 16-token fp
    pages, prefix cache on, each round's bodies queued in their order
    (``check_serving``'s ``ordered``), so the two layouts run the same
    waves and decode steps; with ``profile_fn``, the dense engine alone
    once more under the profiler (:func:`profile_ssm_ops`).  Launches of
    the counted round: each attention kernel once per attention layer per
    decode step (the layout's decode kernel) or prefill wave (flash), the
    other decode kernel never, and rmsnorm :func:`rmsnorm_per_forward` a
    forward.  Each request's tokens on the two layouts, round by round:
    those that took no prefix hit in either run must be equal when
    ``require_equal`` (else a reading); a request with a hit is listed
    with its hit lengths (the reference's recurrent-state quirk shows
    there)."""
    bodies = serve_requests()
    attn = attention_layers(cfg)
    runs, rec = {}, {}
    for layout, kw in (("dense", {}),
                       ("paged", dict(kv_layout="paged", kv_page_size=16))):
        reqs = []
        launches, serve, stats, _ = check_serving(
            *serving, bodies=bodies, arch=arch, cfg=cfg, params=params,
            profile=False,
            profile_ops=profile_fn if layout == "dense" else None,
            requests=reqs, ordered=True, **kw)
        used, unused = (("paged_attention", "decode_attention")
                        if layout == "paged" else
                        ("decode_attention", "paged_attention"))
        forwards = serve["decode_steps"] + serve["prefill_waves"]
        want = {used: attn * serve["decode_steps"],
                "flash_attention": attn * serve["prefill_waves"], unused: 0,
                "rmsnorm": rmsnorm_per_forward(cfg) * forwards}
        if any(launches[k] != v for k, v in want.items()) or \
                not launches["rmsnorm"]:
            raise AssertionError(f"{what} {layout}: launches {launches}, "
                                 f"want {want}")
        log(f"  {layout}: launches {launches} = {want} "
            f"({rmsnorm_per_forward(cfg)} rmsnorm a forward); prefix cache "
            f"{stats['prefix_cache']}, {serve['prefix_evictions']} entries "
            "evicted over both rounds")
        if layout == "paged":
            pages = stats["kv_pages"]
            log(f"  kv pages {pages}")
            if pages["pinned"] or pages["full_copies"] or \
                    pages["free"] + pages["reclaimable"] != pages["total"]:
                raise AssertionError(f"{what} paged: pages {pages}")
            serve["kv_pages"] = pages
        serve["prefix_cache"] = stats["prefix_cache"]
        runs[layout] = by_prompt(reqs, len(bodies))
        rec[layout] = serve
    same, hits, compared = 0, [], 0
    for rnd, (dense, paged) in enumerate(zip(runs["dense"], runs["paged"])):
        for key, d in dense.items():
            p = paged[key]
            eq = d.output_tokens == p.output_tokens
            if d.cached_prefix_len or p.cached_prefix_len:
                hits.append({"round": rnd, "prompt_tokens": len(key),
                             "hit_dense": d.cached_prefix_len,
                             "hit_paged": p.cached_prefix_len,
                             "tokens_equal": eq})
                continue
            compared += 1
            same += eq
    rec["no_hit_requests"] = compared
    rec["no_hit_tokens_equal"] = same
    rec["with_hit"] = hits
    log(f"  dense vs paged over HTTP, the counted round's waves / decode "
        f"steps {rec['dense']['prefill_waves']} / "
        f"{rec['dense']['decode_steps']} and "
        f"{rec['paged']['prefill_waves']} / {rec['paged']['decode_steps']}; "
        f"tokens, rounds 1-2: {same}/{compared} equal among requests with "
        f"no prefix hit in either run; with a hit: {hits}")
    if require_equal and same != compared:
        raise AssertionError(f"{what}: dense and paged tokens differ for "
                             f"{compared - same} requests with no prefix "
                             "hit")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def check_ssm_preemption(torch, ns, wrappers, cfg, params):
    """4m-b: ``cfg`` (bf16) with ``max_batch`` 1, EDF and preemption, the
    prefix cache off (so only the snapshot is tested), dense ring and
    16-token pages: the urgent request evicts the batch one and finishes
    first; the batch request resumes from its snapshot (``conv``/``state``
    copied out and back) with tokens identical to the same engine's FIFO
    run.  Launches: no attention kernel, rmsnorm a forward's count."""
    out = {}
    per = rmsnorm_per_forward(cfg)
    for layout in ("dense", "paged"):
        kw = dict(device="cuda", max_batch=1, cache_len=2048,
                  enable_prefix_cache=False, kv_layout=layout,
                  kv_page_size=16)
        fifo = ns.InferenceEngine(cfg, params, sched_policy="fifo", **kw)
        fb, fu, _ = run_preempt_scenario(fifo, ns.Request, ns.SamplingParams,
                                         batch_tokens=BATCH_PROMPT)
        engine = ns.InferenceEngine(cfg, params, sched_policy="edf",
                                    preemption=True, **kw)
        for w in wrappers.values():
            w.launches = 0
        b, u, _ = run_preempt_scenario(engine, ns.Request, ns.SamplingParams,
                                       batch_tokens=BATCH_PROMPT)
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in wrappers.items()}
        st = engine.scheduler.stats
        same = (b.output_tokens == fb.output_tokens
                and u.output_tokens == fu.output_tokens)
        want = {"rmsnorm": per * (st.device_steps + st.prefill_waves),
                "flash_attention": 0, "decode_attention": 0,
                "paged_attention": 0}
        log(f"  {layout}, prefix cache off: preemptions {st.preemptions}, "
            f"resumed {st.resumed}, urgent first "
            f"{u.finish_time < b.finish_time}, batch tokens identical to "
            f"FIFO {same} ({b.num_generated}), launches {launches}")
        if not (st.preemptions >= 1 and st.resumed >= 1 and same
                and u.finish_time < b.finish_time):
            raise AssertionError(f"4m-b {layout}: preemption broke")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"4m-b {layout}: launches {launches}, want "
                                 f"{want}")
        out[layout] = {"preemptions": st.preemptions, "resumed": st.resumed,
                       "identical_to_fifo": same, "launches": launches,
                       "decode_steps": st.device_steps,
                       "prefill_waves": st.prefill_waves}
        del fifo, engine
    return out


def audio_requests(ns, tok, wave, n, seed):
    """``n`` requests sharing ``wave``, each with its own short prompt."""
    return [ns.Request(prompt_tokens=tok.encode(f"transcribe {seed}-{i}"),
                       sampling=ns.SamplingParams(max_tokens=12), audio=wave)
            for i in range(n)]


def check_audio_serving(torch, ns, wrappers, cfg, params):
    """4n: ``seamless-m4t-medium`` (bf16, full depth) on the engine, dense
    ring then 16-token fp pages (the reference has no audio on its HTTP
    surface), prefix and content caches on.  After a warm-up request:
    (a) 8 concurrent requests with one new waveform cost exactly one
    encoder invocation, the other 7 joining it in flight or hitting its
    embedding; launches counted over the round: flash 2 x 12 a prefill
    wave (decoder self- and cross-attention) + 12 in each wave that encodes
    fresh audio (the encoder), the decode step's self-attention on the
    layout's kernel and its cross-attention on the decode kernel (12 each
    a step), rmsnorm a forward's count (+ the encoder's in a fresh wave);
    (b) a cold request alone with another new waveform, then its warm
    repeat: identical tokens, 1 embedding hit, 1 cross-KV hit, no encoder
    call, no encoder flash launch; TTFT cold vs warm read.  The tokens
    must be equal across the layouts."""
    import numpy as np
    out, tokens = {}, {}
    layers_ = cfg.num_layers
    enc = cfg.audio.encoder_layers
    per = rmsnorm_per_forward(cfg)
    per_enc = rmsnorm_per_forward(cfg, encoder=True) - per
    rng = np.random.default_rng(7)
    warm_wave, wave, solo_wave = (
        rng.standard_normal(16000).astype(np.float32) for _ in range(3))
    for layout in ("dense", "paged"):
        torch.cuda.reset_peak_memory_stats()
        engine = ns.InferenceEngine(
            cfg, params, device="cuda", max_batch=8, cache_len=2048,
            prefill_chunk=512, seed=0, kv_layout=layout, kv_page_size=16,
            vision_work_iters=1)
        tok = engine.tokenizer
        engine.generate(audio_requests(ns, tok, warm_wave, 1, "warm"))
        waves = []
        real = engine._prefill

        def prefill(*a, real=real, waves=waves, **k):
            waves.append(a[-1])                 # cross_cached
            return real(*a, **k)
        engine._prefill = prefill
        ms = engine.media_stats
        m0 = dict(vars(ms))
        for w in wrappers.values():
            w.launches = 0
        st = engine.scheduler.stats
        s0 = (st.device_steps, st.prefill_waves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = audio_requests(ns, tok, wave, 8, 0)
        engine.generate(cold)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        steps, nwaves = (st.device_steps - s0[0], st.prefill_waves - s0[1])
        fresh = sum(not c for c in waves)
        dm = {k: v - m0[k] for k, v in vars(ms).items()}
        used = "paged_attention" if layout == "paged" else "decode_attention"
        want = {"flash_attention": 2 * layers_ * nwaves + enc * fresh,
                "rmsnorm": per * (steps + nwaves) + per_enc * fresh}
        if layout == "paged":
            want.update(paged_attention=layers_ * steps,
                        decode_attention=layers_ * steps)
        else:
            want.update(decode_attention=2 * layers_ * steps,
                        paged_attention=0)
        done = sum(len(r.output_tokens) for r in cold)
        log(f"  {layout} (a) 8 requests, one new waveform: encoder calls "
            f"{dm['encoder_invocations']}, dedup joins {dm['dedup_joins']}, "
            f"embedding hits {dm['embed_hits']}, cross-KV misses "
            f"{dm['xkv_misses']}; {nwaves} prefill waves ({fresh} encoding "
            f"fresh audio), {steps} decode steps, {done} tokens in "
            f"{wall:.3f} s; launches {launches} (want {want})")
        if dm["encoder_invocations"] != 1 or \
                dm["dedup_joins"] + dm["embed_hits"] != 7 or \
                any(r.finish_reason is None or r.error for r in cold):
            raise AssertionError(f"4n {layout} (a): media {dm}")
        if any(launches[k] != v for k, v in want.items()) or not fresh:
            raise AssertionError(f"4n {layout} (a): launches {launches}, "
                                 f"want {want}")
        solo = audio_requests(ns, tok, solo_wave, 1, 1)
        engine.generate(solo)
        waves.clear()
        m1 = dict(vars(ms))
        for w in wrappers.values():
            w.launches = 0
        repeat = audio_requests(ns, tok, solo_wave, 1, 1)
        engine.generate(repeat)
        torch.cuda.synchronize()
        dm2 = {k: v - m1[k] for k, v in vars(ms).items()}
        same = repeat[0].output_tokens == solo[0].output_tokens
        fla_launches = wrappers["flash_attention"].launches
        log(f"  {layout} (b) warm repeat: tokens identical {same}, media "
            f"{ {k: v for k, v in dm2.items() if v} }, flash launches "
            f"{fla_launches} over {len(waves)} waves (cross-cached "
            f"{sum(waves)}), TTFT cold {solo[0].ttft:.4f} s vs warm "
            f"{repeat[0].ttft:.4f} s")
        if not (same and dm2["embed_hits"] == 1 and dm2["xkv_hits"] == 1
                and dm2["encoder_invocations"] == 0 and all(waves)
                and fla_launches == 2 * layers_ * len(waves)):
            raise AssertionError(f"4n {layout} (b): tokens identical {same}, "
                                 f"media {dm2}, waves {waves}, flash "
                                 f"{fla_launches}")
        tokens[layout] = [r.output_tokens for r in cold + solo]
        out[layout] = {"media": dm, "warm_media": dm2, "launches": launches,
                       "prefill_waves": nwaves, "fresh_waves": fresh,
                       "decode_steps": steps, "completion_tokens": done,
                       "wall_s": wall, "tokens_per_s": done / wall,
                       "ttft_cold_s": solo[0].ttft,
                       "ttft_warm_s": repeat[0].ttft,
                       "peak_mem_gib":
                           torch.cuda.max_memory_allocated() / 2**30}
        del engine, prefill
        gc.collect()
        torch.cuda.empty_cache()
    out["tokens_equal_across_layouts"] = tokens["dense"] == tokens["paged"]
    log(f"  dense vs paged tokens equal: {out['tokens_equal_across_layouts']}")
    if not out["tokens_equal_across_layouts"]:
        raise AssertionError("4n: dense and paged tokens differ")
    return out


# --------------------------------------------------------------------------- #
# phase 4l: sampled requests through the categorical kernel
# --------------------------------------------------------------------------- #
def check_sampled_round(torch, ns, wrappers, params):
    """4l: 4a's 12 prompts as sampled requests (temperature 0.8, top-p 0.95
    on every other one, a seed each; 4a's ``max_tokens``) on ``qwen2-0.5b``
    (bf16, 24 layers, the served weights, dense ring, 8 slots, prefix cache
    off so every run prefills alike), the engine alone: a warm-up run of
    all 12, then in turns (kernel, plain, plain, kernel, kernel, plain) the
    counted run through the categorical kernel, runs with
    ``ops.categorical`` routed to the plain version, and seeded replays
    through the kernel.  Tokens identical in every run; tokens/s of each
    side the mean of its three runs; the counted run launches decode and
    flash 24 x steps and waves, rmsnorm 49 x forwards, and the categorical
    kernel once per sampled decode step and once per wave that commits
    first tokens (between the decode steps and decode steps + waves); the
    plain run never launches it.  Tokens/s of both read."""
    from repro_torch.kernels import ops
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    bodies = serve_requests()

    def reqs():
        return [ns.Request(prompt_tokens=tok.encode(prompt_text(kind, body)),
                           sampling=ns.SamplingParams(
                               max_tokens=body["max_tokens"], temperature=0.8,
                               top_p=0.95 if i % 2 else 1.0, seed=1000 + i))
                for i, (kind, body) in enumerate(bodies)]

    engine = engine_4j(ns, params, enable_prefix_cache=False)
    engine.generate(reqs())                             # warm-up
    layers = engine.cfg.num_layers

    def run(route):
        st = engine.scheduler.stats
        before = (st.device_steps, st.prefill_waves)
        rs = reqs()
        zero(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (plain_attention(ops, ("categorical",)) if route == "plain"
              else nullcontext()):
            engine.generate(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [r.finish_reason for r in rs if r.finish_reason is None
               or r.finish_reason.value not in ("stop", "length")]
        if bad:
            raise AssertionError(f"4l {route}: unexpected finishes {bad}")
        n = sum(len(r.output_tokens) for r in rs)
        return {"tokens": [list(r.output_tokens) for r in rs],
                "completion_tokens": n, "wall_s": wall,
                "tokens_per_s": n / wall,
                "decode_steps": st.device_steps - before[0],
                "prefill_waves": st.prefill_waves - before[1],
                "launches": counted(wrappers)}

    order = ("kernel", "plain", "plain", "kernel", "kernel", "plain")
    runs = [(route, run(route)) for route in order]
    kern = runs[0][1]
    require_launches(kern["launches"], kern, layers,
                     decode_kernel="decode_attention",
                     unused="paged_attention")
    require_rmsnorm(kern["launches"], kern, layers)
    n_cat = kern["launches"]["categorical"]
    lo, hi = kern["decode_steps"], kern["decode_steps"] + kern["prefill_waves"]
    if not lo <= n_cat <= hi or not n_cat:
        raise AssertionError(f"4l: categorical launches {n_cat}, want "
                             f"{lo}..{hi} (sampled decode steps + waves)")
    if any(rec["launches"]["categorical"] for route, rec in runs
           if route == "plain"):
        raise AssertionError("4l: the plain route launched the kernel")
    same_replay = all(rec["tokens"] == kern["tokens"] for route, rec in runs
                      if route == "kernel")
    same_plain = all(rec["tokens"] == kern["tokens"] for route, rec in runs
                     if route == "plain")
    tps = {side: [rec["tokens_per_s"] for route, rec in runs
                  if route == side] for side in ("kernel", "plain")}
    means = {side: sum(v) / len(v) for side, v in tps.items()}
    turns = ", ".join(f"{r} {rec['tokens_per_s']:.1f}" for r, rec in runs)
    log(f"  4l: {len(bodies)} sampled requests, {kern['completion_tokens']} "
        f"tokens, {kern['decode_steps']} decode steps, "
        f"{kern['prefill_waves']} waves, categorical launches {n_cat}; "
        f"tokens/s in turns: {turns} (means kernel {means['kernel']:.1f}, "
        f"plain draw "
        f"{means['plain']:.1f}: {means['kernel'] / means['plain']:.3f}x); "
        f"seeded replays identical {same_replay}, plain-route tokens "
        f"identical {same_plain}")
    if not (same_replay and same_plain):
        raise AssertionError(f"4l: tokens differ (replay {same_replay}, "
                             f"plain route {same_plain})")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    for _, rec in runs:
        rec.pop("tokens")
    return {"order": list(order), "runs": [rec for _, rec in runs],
            "tokens_per_s": tps, "tokens_per_s_means": means,
            "tokens_identical": True, "kernel": kern}


# --------------------------------------------------------------------------- #
# phase 4h: overload serving (preemption, the page-pressure ladder,
# admission control)
# --------------------------------------------------------------------------- #
BATCH_PROMPT = "long-running batch request " * 2
URGENT_PROMPT = "urgent interactive!"


def run_preempt_scenario(engine, Request, SamplingParams, *, batch_tokens,
                         batch_max=64, images=None):
    """The reference's ``_preempt_scenario`` (tests/test_sched_policy.py):
    one batch request decodes alone, then after 4 steps an urgent request
    with a 1 ms deadline arrives.  Returns (batch, urgent, the batch
    request's pages when it was evicted and when it resumed)."""
    tok = engine.tokenizer
    batch = Request(prompt_tokens=tok.encode(batch_tokens),
                    images=list(images or []),
                    sampling=SamplingParams(max_tokens=batch_max))
    engine.add_request(batch)
    for _ in range(4):
        engine.step()
    urgent = Request(prompt_tokens=tok.encode(URGENT_PROMPT),
                     sampling=SamplingParams(max_tokens=6), deadline_ms=1.0)
    engine.add_request(urgent)
    stats, pages = engine.scheduler.stats, {}
    while engine.scheduler.has_work:
        held = list(engine.pool.slot_pages(0)) if engine._paged else None
        counts = (stats.preemptions, stats.resumed)
        engine.step()
        if stats.preemptions > counts[0]:
            pages.setdefault("evicted", held)
        if stats.resumed > counts[1] and engine._paged:
            pages.setdefault("resumed", list(engine.pool.slot_pages(0)))
    return batch, urgent, pages


def check_policy_preemption(torch, ns, wrappers, params):
    """4h-a: ``qwen2-0.5b`` (bf16, published widths, 24 layers) with
    ``max_batch`` 1, EDF and preemption, on the dense ring and on 16-token
    fp pages, the prefix cache on and off: the urgent request evicts the
    batch one and finishes first; the batch request resumes from its
    snapshot with tokens identical to the same engine's FIFO run; on pages
    the resumed slot maps the evicted page ids with no copy.  The layout's
    decode kernel runs 24 times per decode step, the other never."""
    layers = ns.get_config("qwen2-0.5b").num_layers
    out = {}
    for layout in ("dense", "paged"):
        for cache_on in (True, False):
            kw = dict(device="cuda", max_batch=1, cache_len=2048,
                      enable_prefix_cache=cache_on, kv_layout=layout,
                      kv_page_size=16)
            fifo = ns.InferenceEngine(ns.get_config("qwen2-0.5b"), params,
                                      sched_policy="fifo", **kw)
            fb, fu, _ = run_preempt_scenario(fifo, ns.Request,
                                             ns.SamplingParams,
                                             batch_tokens=BATCH_PROMPT)
            engine = ns.InferenceEngine(ns.get_config("qwen2-0.5b"), params,
                                        sched_policy="edf", preemption=True,
                                        **kw)
            for w in wrappers.values():
                w.launches = 0
            b, u, pages = run_preempt_scenario(engine, ns.Request,
                                               ns.SamplingParams,
                                               batch_tokens=BATCH_PROMPT)
            torch.cuda.synchronize()
            launches = {n: w.launches for n, w in wrappers.items()}
            st = engine.scheduler.stats
            used, unused = (("paged_attention", "decode_attention")
                            if layout == "paged" else
                            ("decode_attention", "paged_attention"))
            name = f"{layout}, prefix cache {'on' if cache_on else 'off'}"
            same = (b.output_tokens == fb.output_tokens
                    and u.output_tokens == fu.output_tokens)
            log(f"  {name}: preemptions {st.preemptions}, resumed "
                f"{st.resumed}, urgent first {u.finish_time < b.finish_time}"
                f", batch tokens identical to FIFO {same} "
                f"({b.num_generated}), launches {launches} over "
                f"{st.device_steps} decode steps / {st.prefill_waves} prefill "
                f"waves ({launches[used] / st.device_steps:g} {used} per "
                f"step)")
            if not (st.preemptions >= 1 and st.resumed >= 1 and same
                    and u.finish_time < b.finish_time
                    and b.finish_reason == fb.finish_reason):
                raise AssertionError(f"4h-a {name}: preemption broke")
            want = {used: layers * st.device_steps,
                    "flash_attention": layers * st.prefill_waves, unused: 0}
            if any(launches[k] != v for k, v in want.items()):
                raise AssertionError(f"4h-a {name}: launches {launches}, "
                                     f"want {want}")
            if layout == "paged":
                ev, re = pages.get("evicted"), pages.get("resumed")
                log(f"    pages at eviction {ev}, at resume {re}, full "
                    f"copies {engine.pool.stats.full_copies}")
                if not ev or re[:len(ev)] != ev or \
                        engine.pool.stats.full_copies:
                    raise AssertionError(f"4h-a {name}: resume did not "
                                         f"adopt the evicted pages")
            out[name] = {"preemptions": st.preemptions,
                         "resumed": st.resumed, "identical_to_fifo": same,
                         "decode_steps": st.device_steps,
                         "prefill_waves": st.prefill_waves,
                         "launches": launches}
            del fifo, engine
    return out


def pressure_bodies(tok, max_tokens=128, share=0.45):
    """The 4b text mix (12 requests + the 6 shared-prompt chats), every
    ``max_tokens`` raised to ``max_tokens``, and the arena that holds
    ``share`` of the pages its live set asks for at its peak (the 8 largest
    requests' prompt + output pages).  Returns (bodies, arena pages, peak
    pages)."""
    bodies = serve_requests() + shared_prompt_chats()
    for _, body in bodies:
        body["max_tokens"] = max_tokens
    need = sorted((-(-(len(tok.encode(prompt_text(k, b))) + max_tokens)
                    // 16) for k, b in bodies), reverse=True)
    peak = sum(need[:8])
    reserved = 2                              # one trash page + scratch
    return bodies, reserved + math.ceil(peak * share), peak


def check_pressure_serving(torch, serving, params):
    """4h-b: the text mix with raised ``max_tokens`` on 16-token fp pages
    with the prefix cache on, once at full capacity and once in an arena
    below it: every request finishes with the right usage, rung 2 preempts
    and the victims resume by re-prefill, rung 3 fails nothing, no page
    stays pinned, and the kernels run as on every paged round.  Prints the
    share of requests whose text equals the full-capacity run's (a reading:
    re-prefill rounds bf16 differently from incremental decode)."""
    from repro_torch.serving.tokenizer import ByteTokenizer
    bodies, arena, peak = pressure_bodies(ByteTokenizer())
    runs = {}
    for label, pages in (("full", None), ("pressure", arena)):
        responses = []
        launches, rec, stats, layers = check_serving(
            *serving, bodies=bodies, rounds=1, profile=False, params=params,
            responses=responses, kv_layout="paged", kv_page_size=16,
            kv_num_pages=pages)
        require_launches(launches, rec, layers,
                         decode_kernel="paged_attention",
                         unused="decode_attention")
        occ = stats["kv_pages"]
        rec.update(preemptions=stats["preemptions"],
                   resumed=stats["resumed"], failed=stats["failed"],
                   kv_pages=occ, texts=[text_of(b, r) for (_, b), r in
                                        zip(bodies, responses)])
        runs[label] = rec
        log(f"  {label}: arena {occ['total']} allocatable pages, "
            f"preemptions {stats['preemptions']} (snapshot resumes "
            f"{stats['resumed']}, re-prefill resumes "
            f"{stats['preemptions'] - stats['resumed']}), failed "
            f"{stats['failed']}, pinned {occ['pinned']}, "
            f"{rec['tokens_per_s']:.1f} tokens/s, peak "
            f"{rec['peak_mem_gib']:.2f} GiB")
        if stats["failed"] or occ["pinned"]:
            raise AssertionError(f"4h-b {label}: failed {stats['failed']}, "
                                 f"pinned {occ['pinned']}")
    press = runs["pressure"]
    log(f"  arena {arena} pages (2 reserved) against a live-set peak of "
        f"{peak} pages ({peak / (arena - 2):.2f}x)")
    if press["preemptions"] < 1 or \
            press["preemptions"] - press["resumed"] < 1:
        raise AssertionError("4h-b: no rung-2 preemption and re-prefill "
                             "resume under page pressure")
    same = [a == b for a, b in zip(runs["full"].pop("texts"),
                                   press.pop("texts"))]
    share = sum(same) / len(same)
    log(f"  requests whose text equals the full-capacity run's: "
        f"{sum(same)}/{len(same)} ({share:.3f}; a reading, not a gate)")
    return {"arena_pages": arena, "peak_live_pages": peak,
            "identical_share": share, **runs}


def text_of(body, resp) -> str:
    """The completion text of one checked response (chat, completion or
    SSE chunks)."""
    if body.get("stream"):
        return "".join(c["choices"][0]["delta"].get("content", "")
                       for c in resp if c["choices"])
    choice = resp["choices"][0]
    return choice["message"]["content"] if "message" in choice \
        else choice["text"]


def http(port: int, path: str, body=None, headers=None):
    """(status, headers, JSON body) of one call; HTTP errors included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def fire(port, bodies, headers=None):
    """Send ``bodies`` to chat completions, one thread each; returns the
    threads and the list their (status, headers, body) land in."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = http(port, "/v1/chat/completions", bodies[i], headers)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    return threads, out


def wait_for(cond, what, timeout=120.0, phase="4h-c"):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{phase}: {what} not reached")
        time.sleep(0.005)


def chat(text, max_tokens=4, **extra):
    return {"messages": [{"role": "user", "content": text}],
            "max_tokens": max_tokens, **extra}


def hold_engine(engine) -> threading.Event:
    """Make the engine's steps wait on the returned event while it is
    clear: the client's loop thread then stays inside one step and releases
    nothing more, so every later submit waits at admission."""
    gate = threading.Event()
    gate.set()
    step = engine.step

    def held_step():
        gate.wait()
        return step()

    engine.step = held_step
    return gate


def check_admission_serving(torch, serve_mod):
    """4h-c: ``qwen2-0.5b`` servers built as ``launch/serve.py`` builds
    them (dense ring, admission on, ``--shed-wait 0`` so the ladder reads
    queue depth): a tenant over its requests/s gets 429s; with the loop
    held inside a step (:func:`hold_engine`), SHED_BULK answers a
    batch-class request 503 and queues interactive ones, a full queue
    answers the rest of a 16-request burst 503, ``/readyz`` reads 503 at
    SHED_ALL and 200 before and after; a request held past the queue
    timeout finishes with ``timeout``.  Every admitted request
    completes."""
    out = {}

    def build(*flags):
        args = serve_mod.parse_args(["--arch", "qwen2-0.5b", "--port", "0",
                                     "--cache-len", "2048", "--shed-wait",
                                     "0", *flags])
        srv = serve_mod.build_server(args)
        srv.start()
        return srv

    def ok(resp, what):
        code, _, body = resp
        reason = body.get("choices", [{}])[0].get("finish_reason")
        if code != 200 or reason not in ("stop", "length"):
            raise AssertionError(f"4h-c {what}: {code} {body}")

    def rejected(resp, status, etype, code):
        st, headers, body = resp
        err = body.get("error", {})
        if st != status or err.get("type") != etype or \
                err.get("code") != code or int(headers["Retry-After"]) < 1:
            raise AssertionError(f"4h-c: want {status} {etype}/{code}, got "
                                 f"{st} {headers.get('Retry-After')} {body}")
        return int(headers["Retry-After"])

    def hold(srv):
        """Close the gate with one request inside the held step."""
        gate = hold_engine(srv.api.engine)
        gate.clear()
        threads, res = fire(srv.port, [chat("first in", 16)])
        wait_for(lambda: len(srv.api.engine.scheduler.pending) == 1,
                 "the held step")
        return gate, threads, res

    # (1) rate limit: tenant bulk at 2 requests/s (burst 8, the launcher's
    # default); a concurrent burst of 16
    srv = build("--tenant", "bulk=1:2")
    try:
        threads, res = fire(srv.port, [chat(f"bulk {i}") for i in range(16)],
                            {"x-tenant": "bulk"})
        for t in threads:
            t.join(timeout=600)
        limited = [r for r in res if r[0] == 429]
        for r in res:
            if r[0] == 429:
                rejected(r, 429, "rate_limit_error", "rate_limited")
            else:
                ok(r, "bulk request")
        snap = http(srv.port, "/stats")[2]["admission"]
        log(f"  rate limit: 16 bulk requests, {len(limited)} x 429 "
            f"(Retry-After {sorted({int(r[1]['Retry-After']) for r in limited})}"
            f" s), {16 - len(limited)} served; tenant counters "
            f"{snap['tenants']['bulk']}")
        if len(limited) < 4 or \
                snap["tenants"]["bulk"]["shed_rate_limited"] != len(limited):
            raise AssertionError(f"4h-c: {len(limited)} 429s, {snap}")
        out["rate_limited"] = len(limited)
    finally:
        srv.stop()
        srv.api.client.stop()

    # (2) shedding and the bounded queue: depth 4, batch shed from 2
    srv = build("--max-queue-depth", "4", "--shed-queue-depth", "2")
    gate = None
    try:
        ctl = srv.api.client._admission
        idle = http(srv.port, "/readyz")
        gate, t0, o0 = hold(srv)
        t1, o1 = fire(srv.port, [chat(f"interactive {i}",
                                      deadline_ms=60_000.0)
                                 for i in range(2)])
        wait_for(lambda: ctl.queue_depth == 2, "two queued")
        level_bulk = ctl.snapshot()["level_name"]
        shed = http(srv.port, "/v1/chat/completions", chat("batch work"))
        rejected(shed, 503, "overloaded_error", "overloaded")
        t2, o2 = fire(srv.port, [chat("interactive 2", priority=3)])
        wait_for(lambda: ctl.queue_depth == 3, "interactive queued")
        t3, burst = fire(srv.port, [chat(f"burst {i}", deadline_ms=60_000.0)
                                    for i in range(16)])
        wait_for(lambda: sum(r is not None for r in burst) >= 15, "burst")
        full = http(srv.port, "/readyz")
        snap = http(srv.port, "/stats")[2]["admission"]
        gate.set()
        for t in t0 + t1 + t2 + t3:
            t.join(timeout=600)
        queued_burst = [r for r in burst if r[0] == 200]
        for r in o0 + o1 + o2 + queued_burst:
            ok(r, "admitted request")
        retry = [rejected(r, 503, "overloaded_error", "overloaded")
                 for r in burst if r[0] != 200]
        wait_for(lambda: http(srv.port, "/readyz")[0] == 200, "ready again")
        log(f"  shedding: /readyz idle {idle[0]}; at depth 2 level "
            f"{level_bulk}: a batch request {shed[0]} "
            f"({shed[2]['error']['message']!r}), an interactive one queued; "
            f"a 16-request burst: {len(queued_burst)} queued, {len(retry)} x "
            f"503 (Retry-After {sorted(set(retry))} s); /readyz at "
            f"{full[2].get('level')} {full[0]}, then 200; admission "
            f"snapshot {json.dumps({k: snap[k] for k in ('queue_depth', 'level_name', 'shed_overload')})}; "
            f"{len(o0 + o1 + o2 + queued_burst)} admitted requests completed")
        if idle[0] != 200 or level_bulk != "shed_bulk" or \
                "batch-class" not in shed[2]["error"]["message"] or \
                len(queued_burst) != 1 or len(retry) != 15 or \
                full[0] != 503 or full[2].get("level") != "shed_all" or \
                snap["queue_depth"] != 4:
            raise AssertionError("4h-c: shedding / readiness broke")
        out.update(shed_bulk_503=1, overloaded_503=len(retry),
                   readyz={"idle": idle[0], "shed_all": full[0], "after": 200},
                   admitted_completed=len(o0 + o1 + o2 + queued_burst))
    finally:
        if gate is not None:
            gate.set()
        srv.stop()
        srv.api.client.stop()

    # (3) a queue-wait expiry behind the held step
    srv = build("--queue-timeout", "0.5")
    gate = None
    try:
        gate, t0, o0 = hold(srv)
        t1, late = fire(srv.port, [chat("waits too long")])
        wait_for(lambda: srv.api.client._admission.queue_depth == 1,
                 "the late request queued")
        time.sleep(0.7)
        gate.set()
        for t in t0 + t1:
            t.join(timeout=600)
        ok(o0[0], "first request")
        code, _, body = late[0]
        reason = body["choices"][0]["finish_reason"]
        log(f"  queue timeout 0.5 s: the late request {code}, finish_reason "
            f"{reason!r}, usage {body['usage']}")
        if code != 200 or reason != "timeout" or \
                body["usage"]["completion_tokens"]:
            raise AssertionError(f"4h-c: timeout finish {code} {body}")
        out["timeout_finish"] = reason
    finally:
        if gate is not None:
            gate.set()
        srv.stop()
        srv.api.client.stop()
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
        # (d) n = 2 with a new image: the choices admit independently (a
        # group's shared value carries no context rows), one encoder call
        g0, c5 = server.api.stats()["prefill_groups"], cc()
        two_body = media_body("two takes", [image_urls(media, 105)[1]], n=2)
        two = post(server.port, "/v1/chat/completions", two_body)
        enc = delta(c5, cc(), "encoder_invocations")
        g1 = server.api.stats()["prefill_groups"]
        groups = {k: g1[k] - g0[k] for k in g1}
        texts = [c["message"]["content"] for c in two["choices"]]
        log(f"  n = 2 with a new image: {enc}, groups {groups}, "
            f"finishes {[c['finish_reason'] for c in two['choices']]}, "
            f"choices equal {len(set(texts)) == 1}")
        if len(texts) != 2 or len(set(texts)) != 1 or \
                enc != {"encoder_invocations": 1} or groups != {
                    "groups": 1, "shared_admits": 0,
                    "independent_fallbacks": 1} or \
                any(c["finish_reason"] not in ("stop", "length")
                    for c in two["choices"]):
            raise AssertionError(f"n = 2 media request: {two}, {enc}, "
                                 f"{groups}")
        tokens += two["usage"]["completion_tokens"]
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
    preempt = check_media_preemption(torch, ns, cfg, engine.params, layout)
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
    # two norms a layer (self- or cross-attention, then the MLP) + the final
    want["rmsnorm"] = (2 * (n_self + n_cross) + 1) * (steps + waves)
    want["categorical"] = 0          # every media request is greedy
    want["flash_attention_bwd"] = 0  # serving runs no backward
    log(f"  {layout}: 13 media requests, {tokens} completion tokens in "
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
              "requests": 13, "completion_tokens": tokens, "wall_s": wall,
              "tokens_per_s": tokens / wall, "prefill_waves": waves,
              "decode_steps": steps, "launches": launches,
              "ttft_cold_s": cold_ttft, "ttft_warm_s": warm_ttft,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "content_cache": stats, "max_batch": 8, "cache_len": 2048,
              "ctx_len": engine.ctx_len, "dtype": "bfloat16",
              "profiled_round": prof, "preemption": preempt}
    del engine, client, server
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record, cold_toks


def check_media_preemption(torch, ns, cfg, params, layout):
    """The served model's weights (not drawn again) in two engines with
    ``max_batch`` 1: an image request preempted by an urgent text request
    (EDF) resumes from its snapshot — ctx rows and cross KV included —
    with the tokens of its FIFO run and no second encoder call."""
    import numpy as np
    image = np.random.default_rng(105).integers(0, 256, (32, 32, 3),
                                                dtype=np.uint8)
    kw = dict(device="cuda", max_batch=1, cache_len=2048, kv_layout=layout)
    runs = []
    for policy in ("fifo", "edf"):
        engine = ns.InferenceEngine(cfg, params, sched_policy=policy,
                                    preemption=policy == "edf", **kw)
        b, u, pages = run_preempt_scenario(
            engine, ns.Request, ns.SamplingParams, images=[image],
            batch_tokens="describe the picture at length", batch_max=24)
        runs.append((b, u, engine.scheduler.stats,
                     engine.media_stats.encoder_invocations))
        del engine
    (fb, fu, _, _), (b, u, st, calls) = runs
    same = (b.output_tokens == fb.output_tokens
            and u.output_tokens == fu.output_tokens)
    log(f"  {layout}: an image request preempted {st.preemptions}x, resumed "
        f"{st.resumed}x from its snapshot, encoder calls {calls}, urgent "
        f"first {u.finish_time < b.finish_time}, tokens identical to its "
        f"un-preempted run {same}")
    if not (st.preemptions >= 1 and st.resumed >= 1 and same and calls == 1
            and u.finish_time < b.finish_time):
        raise AssertionError(f"{layout}: media preemption broke")
    return {"preemptions": st.preemptions, "resumed": st.resumed,
            "encoder_invocations": calls, "identical": same}


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


# the host operators whose device time makes an MoE layer's parts: the
# expert products (torch.bmm, which nothing else on the serving path
# calls) and the dispatch and combine (top-k, one-hot, cumsum, and the
# indexed reads and writes, which the KV cells' reads and writes share)
MOE_OPS = {"expert_bmm": ("aten::bmm",),
           "index_sort_scatter": ("aten::topk", "aten::one_hot",
                                  "aten::cumsum", "aten::index",
                                  "aten::index_put_")}


def profile_moe_ops(torch, engine, bodies) -> dict:
    """The engine alone, in this thread, serving the prompts of ``bodies``
    greedily (their ``max_tokens``) under ``torch.profiler`` with the
    host's operators traced: the device time launched under each of
    ``MOE_OPS`` as a share of all device time.  (The profiler traces the
    host operators of its own thread, and the served rounds run the
    engine on the client's loop thread.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.request import Request, SamplingParams
    tok = engine.tokenizer
    reqs = [Request(prompt_tokens=tok.encode(prompt_text(kind, body)),
                    sampling=SamplingParams(max_tokens=body["max_tokens"]))
            for kind, body in bodies]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.generate(reqs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device_us, op_us = 0.0, {k: 0.0 for k in MOE_OPS}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            device_us += ev.self_device_time_total
        part = next((k for k, names in MOE_OPS.items() if ev.key in names),
                    None)
        if part is not None:
            op_us[part] += ev.device_time_total
    if device_us <= 0 or op_us["expert_bmm"] <= 0:
        raise RuntimeError(f"the engine-alone profile recorded {device_us} "
                           f"us of device time, {op_us} under MOE_OPS")
    out = {"wall_s": wall, "device_busy_share": device_us / 1e6 / wall,
           "completion_tokens": sum(len(r.output_tokens) for r in reqs),
           **{f"{k}_share_of_device": v / device_us
              for k, v in op_us.items()}}
    log("  engine alone, host operators traced: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


# words in the names of cuBLAS's matrix-product kernels
GEMM_KERNEL_WORDS = ("gemm", "gemv", "xmma", "cutlass", "nvjet")


def profile_round(torch, send_all):
    """One more round of the same mix under ``torch.profiler`` (device
    activity only), its responses checked like the other rounds': device
    time by kind over the round's wall time, i.e. where the serving time
    goes and how long the card sits idle.  The profiled round is slower
    than the counted one; only shares are read."""
    from torch.profiler import ProfilerActivity, profile
    # the split combine (csrc/flash_decoding.cuh) is launched by decode
    # and by paged; its Caller template argument names which
    kinds = {"decode_attention": ("decode_attention_kernel",
                                  "decode_attention_mma_kernel",
                                  "DecodeCaller"),
             "flash_attention": ("flash_attention_kernel",
                                 "flash_attention_tc_kernel"),
             "paged_attention": ("paged_attention_kernel",
                                 "paged_attention_mma_kernel",
                                 "PagedCaller"),
             "rmsnorm": ("rmsnorm",),
             "gemm": GEMM_KERNEL_WORDS,
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
# phase 4j: speculative wave filling, n groups, echo, faults with recovery,
# the watchdog and drain, handoff (qwen2-0.5b, bf16, 24 layers)
# --------------------------------------------------------------------------- #
QWEN = "qwen2-0.5b"
LAYOUTS_4J = {"dense": {}, "paged": dict(kv_layout="paged", kv_page_size=16)}
USED = {"dense": ("decode_attention", "paged_attention"),
        "paged": ("paged_attention", "decode_attention")}


def engine_4j(ns, params, **kw):
    """``qwen2-0.5b`` as phases 4a-4i serve it: 8 slots, a 2048 ring,
    512-token chunks, the served weights."""
    kw = {"max_batch": 8, "cache_len": 2048, "prefill_chunk": 512,
          "seed": 0, **kw}
    return ns.InferenceEngine(ns.get_config(QWEN), params, device="cuda",
                              **kw)


def random_prompts(ns, n, lo, hi, seed):
    """``n`` prompts of random token ids from the upper half of the vocab
    (past the byte tokenizer's specials), lengths from ``lo`` to ``hi``
    staggered evenly."""
    import numpy as np
    vocab = ns.get_config(QWEN).vocab_size
    rng = np.random.default_rng(seed)
    return [rng.integers(vocab // 2, vocab,
                         lo + (hi - lo) * i // max(1, n - 1)).tolist()
            for i in range(n)]


def zero(wrappers):
    for w in wrappers.values():
        w.launches = 0


def counted(wrappers) -> dict:
    return {name: w.launches for name, w in wrappers.items()}


def drive(torch, engine, reqs, what, *, errors_ok=False):
    """Add ``reqs`` at once and step the engine until it is idle; every
    finish must be stop or length (an ``error`` fails the run unless
    ``errors_ok``).  Returns (wall s, {request_id: finish events})."""
    finishes = {}
    t0 = time.perf_counter()
    for r in reqs:
        engine.add_request(r)
    while engine.scheduler.has_work:
        for ev in engine.step():
            if ev.finished:
                finishes.setdefault(ev.request_id, []).append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(r.request_id, r.finish_reason, r.error) for r in reqs
           if r.finish_reason is None or (r.finish_reason.value not in (
               "stop", "length") and not (errors_ok and
                                          r.finish_reason.value == "error"))]
    if bad:
        raise AssertionError(f"4j {what}: unexpected finishes {bad}")
    return wall, finishes


def require_engine_launches(launches, engine, layout, what, extra_flash=0):
    """The layout's decode kernel 24 times per decode step, flash 24 times
    per prefill wave (+ ``extra_flash`` forwards), the other never."""
    st, layers = engine.scheduler.stats, engine.cfg.num_layers
    used, unused = USED[layout]
    want = {used: layers * st.device_steps, unused: 0,
            "flash_attention": layers * (st.prefill_waves + extra_flash)}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"4j {what}: launches {launches}, want {want}")


def check_spec_fill(torch, ns, wrappers, params):
    """4j-a: 24 requests with staggered prompts of 300-1500 tokens on 8
    slots (512-token chunks, so waves carry padding rows), with
    speculative wave filling on and off, on the dense ring and on 16-token
    fp pages: the same greedy tokens, ``spec_jobs``, ``spec_chunks`` and
    ``spec_admitted`` > 0 with it on, flash 24 x prefill waves either way
    (a backfilled row replaces a padding row: no launch of its own).
    Reads waves, the TTFT of the 16 queued requests and tokens/s."""
    prompts = random_prompts(ns, 24, 300, 1500, seed=11)
    out = {}
    for layout, kw in LAYOUTS_4J.items():
        runs = {}
        # the first run takes the first-call costs; off and on are read
        for label, fill in (("warm", True), ("off", False), ("on", True)):
            engine = engine_4j(ns, params, speculative_fill=fill, **kw)
            reqs = [ns.Request(prompt_tokens=list(p),
                               sampling=ns.SamplingParams(max_tokens=16))
                    for p in prompts]
            zero(wrappers)
            wall, _ = drive(torch, engine, reqs, f"4j-a {layout} {label}")
            launches = counted(wrappers)
            require_engine_launches(launches, engine, layout,
                                    f"4j-a {layout} {label}")
            st = engine.scheduler.stats
            ttft = sorted(r.first_token_time - r.arrival_time
                          for r in reqs[8:])
            done = sum(r.num_generated for r in reqs)
            runs[label] = {
                "tokens": [r.output_tokens for r in reqs],
                "prefill_waves": st.prefill_waves,
                "prefill_rows": st.prefill_chunks,
                "spec_jobs": st.spec_jobs, "spec_chunks": st.spec_chunks,
                "spec_admitted": st.spec_admitted, "wall_s": wall,
                "tokens_per_s": done / wall,
                "queued_ttft_mean_s": sum(ttft) / len(ttft),
                "queued_ttft_p50_s": ttft[len(ttft) // 2],
                "queued_ttft_max_s": ttft[-1], "launches": launches}
            del engine
        on, off = runs["on"], runs["off"]
        same = on.pop("tokens") == off.pop("tokens")
        runs.pop("warm")
        log(f"  4j-a {layout}: spec fill on {on['spec_jobs']} jobs, "
            f"{on['spec_chunks']} chunks, {on['spec_admitted']} admitted; "
            f"waves {on['prefill_waves']} vs {off['prefill_waves']} off; "
            f"queued TTFT mean {on['queued_ttft_mean_s']:.4f} s vs "
            f"{off['queued_ttft_mean_s']:.4f} s off; "
            f"{on['tokens_per_s']:.1f} vs {off['tokens_per_s']:.1f} "
            f"tokens/s; tokens identical to off {same}")
        if not same or min(on["spec_jobs"], on["spec_chunks"],
                           on["spec_admitted"]) <= 0 or off["spec_jobs"]:
            raise AssertionError(f"4j-a {layout}: identical {same}, {on}")
        out[layout] = runs
    return out


def check_groups(torch, ns, wrappers, params):
    """4j-b: ``n`` = 4 behind a ~600-token system prompt, the prefix cache
    off, on the dense ring and on fp pages: the prompt prefills once
    (``ceil(L / 512)`` chunks) and the 3 followers prefill 1 token each
    (shared admits 3), flash 24 x prefill waves, 0 full copies and 0
    pinned pages on pages, every choice equal to the others and to an
    ``n`` = 1 request of the same prompt."""
    from repro_torch.core.request import GenerationRequest
    system = "You are a careful assistant for a parts catalogue. " * 12
    text = f"<|system|>{system}<|user|>part number 7?<|assistant|>"
    out = {}
    for layout, kw in LAYOUTS_4J.items():
        engine = engine_4j(ns, params, enable_prefix_cache=False, **kw)
        prompt = engine.tokenizer.encode(text)
        group = GenerationRequest(prompt=prompt, n=4, sampling=(
            ns.SamplingParams(max_tokens=24))).to_requests(engine.tokenizer)
        zero(wrappers)
        drive(torch, engine, group, f"4j-b {layout}")
        launches = counted(wrappers)
        require_engine_launches(launches, engine, layout, f"4j-b {layout}")
        st = engine.scheduler.stats
        chunks = -(-len(prompt) // 512)
        rec = {"prompt_tokens": len(prompt), "group_stats":
               dict(engine.group_stats), "prefill_waves": st.prefill_waves,
               "prefill_rows": st.prefill_chunks, "launches": launches}
        if engine._paged:
            rec["full_copies"] = engine.pool.stats.full_copies
            rec["pinned"] = engine.pool.page_occupancy()["pinned"]
        solo = ns.Request(prompt_tokens=list(prompt),
                          sampling=ns.SamplingParams(max_tokens=24))
        drive(torch, engine, [solo], f"4j-b {layout} n=1")
        same = all(r.output_tokens == solo.output_tokens for r in group)
        log(f"  4j-b {layout}: {len(prompt)}-token prompt, n 4: "
            f"{rec['group_stats']}, {rec['prefill_waves']} waves / "
            f"{rec['prefill_rows']} rows before the n = 1 request, launches "
            f"{launches}, full copies {rec.get('full_copies')}, pinned "
            f"{rec.get('pinned')}; choices equal to each other and to n = 1 "
            f"{same}")
        if rec["group_stats"] != {"groups": 1, "shared_admits": 3,
                                  "independent_fallbacks": 0} or \
                rec["prefill_rows"] != chunks + 3 or \
                rec["prefill_waves"] != chunks + 1 or \
                rec.get("full_copies") or rec.get("pinned") or not same:
            raise AssertionError(f"4j-b {layout}: {rec}, same {same}")
        out[layout] = rec
        del engine
    return out


def check_echo_f32(torch, ns, cfg, wrappers, InferenceEngine, Request,
                   SamplingParams):
    """4j-c (in phase 3's float32 model, TF32 off): the engine's echo pass
    over a 500-token prompt through the kernels (24 flash launches) against
    the same pass through the plain versions, and at 3 cut points i the
    log-softmax of the last row of a prefill of ``toks[:i]`` at
    ``toks[i]`` (kernels), all within 1e-3."""
    engine = InferenceEngine(cfg, device="cuda", max_batch=1, cache_len=2048)
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (500,), generator=g,
                         device="cuda").tolist()

    def echo():
        req = Request(prompt_tokens=toks, sampling=SamplingParams(
            max_tokens=1, logprobs=True, echo=True))
        engine._compute_prompt_logprobs(req)
        return req.prompt_logprobs

    with torch.no_grad():
        zero(wrappers)
        kern = echo()
        launches = counted(wrappers)["flash_attention"]
        with plain_attention(ns.ops):
            plain = echo()
        cuts = {}
        for i in (50, 250, 499):
            out = engine.model.apply(
                engine.params, torch.tensor([toks[:i]], device="cuda"),
                mode="prefill", cache=ns.init_cache(cfg, 1, 512,
                                                    device="cuda"),
                logits_mode="last")
            cuts[i] = abs(kern[i] - float(torch.log_softmax(
                out.logits[0, -1].float(), -1)[toks[i]]))
    err = max(abs(a - b) for a, b in zip(kern[1:], plain[1:]))
    log(f"  4j-c echo pass (float32, 500 tokens): kernels vs plain max "
        f"|d logprob| {err:.3e}, vs prefills of the prefix at cut points "
        f"{ {i: f'{e:.3e}' for i, e in cuts.items()} }, flash launches "
        f"{launches}")
    if kern[0] is not None or len(kern) != len(toks) or err > 1e-3 or \
            max(cuts.values()) > 1e-3 or launches != cfg.num_layers:
        raise AssertionError(f"4j-c echo: err {err}, cuts {cuts}, launches "
                             f"{launches}")
    del engine
    return {"max_abs_err_vs_plain": err, "cut_point_err": cuts,
            "flash_launches": launches}


def check_chaos(torch, ns, wrappers, params):
    """4j-d: a ``FaultInjector`` firing at the prefill, decode, codec and
    pool sites, 16 requests on each layout beside a fault-free run: the
    survivors' tokens equal the fault-free run's, each failed request has
    one ``error`` finish naming an injected fault, an error that names none
    fails the run, and no page stays pinned.  Then a decode block that
    raises (after its launches), with 8 live and 4 pending requests: the
    live ones fail, the pending ones finish, the engine serves again, and
    across the rebuild the peak of allocated memory stays less than one
    arena above what was allocated before (never two arenas at once)."""
    from repro_torch.core.faults import FaultInjector
    rates = {"prefill": 0.15, "decode": 0.005, "codec": 0.005, "pool": 0.2}
    prompts = random_prompts(ns, 16, 100, 700, seed=13)
    out = {}
    for layout, kw in LAYOUTS_4J.items():
        def reqs(base):
            return [ns.Request(prompt_tokens=list(p), request_id=base + i,
                               sampling=ns.SamplingParams(max_tokens=32))
                    for i, p in enumerate(prompts)]
        clean = reqs(40_000)
        drive(torch, engine_4j(ns, params, **kw), clean,
              f"4j-d {layout} fault-free")
        inj = FaultInjector(seed=5, rates=rates)
        engine = engine_4j(ns, params, faults=inj, **kw)
        chaos = reqs(40_000)
        _, finishes = drive(torch, engine, chaos, f"4j-d {layout} chaos",
                            errors_ok=True)
        failed = [r for r in chaos if r.finish_reason.value == "error"]
        alien = [r.error for r in failed if "injected" not in r.error]
        diverged = [r.request_id for r, c in zip(chaos, clean)
                    if r.finish_reason.value != "error"
                    and r.output_tokens != c.output_tokens]
        once = all(len(finishes.get(r.request_id, ())) == 1 for r in chaos)
        pinned = (engine.pool.page_occupancy()["pinned"] if engine._paged
                  else 0)
        rec = {"failed": len(failed), "survivors": len(chaos) - len(failed),
               "fired": inj.snapshot(), "diverged": diverged,
               "pinned": pinned}
        log(f"  4j-d {layout} chaos {rates}: {len(failed)} failed "
            f"({sorted({r.error.split(':')[0] for r in failed})}), "
            f"{rec['survivors']} survivors, fired {rec['fired']}, survivors "
            f"diverged from the fault-free run {diverged}, pinned {pinned}")
        if alien or diverged or not once or pinned or \
                not 0 < len(failed) < len(chaos):
            raise AssertionError(f"4j-d {layout}: {rec}, errors not "
                                 f"injected {alien}, one finish {once}")
        rec["block_failure"] = block_failure(torch, ns, params, layout, kw)
        out[layout] = rec
        del engine
    return out


def block_failure(torch, ns, params, layout, kw):
    """A decode block that raises after it ran (4j-d, second half)."""
    engine = engine_4j(ns, params, **kw)
    reqs = [ns.Request(prompt_tokens=list(p),
                       sampling=ns.SamplingParams(max_tokens=64))
            for p in random_prompts(ns, 12, 200, 400, seed=17)]
    for r in reqs:
        engine.add_request(r)
    while len(engine._live_slots) < 8:
        engine.step()
    live = {engine.scheduler.active[s].request_id for s in engine._live_slots}
    real = engine._decode_block

    def boom(*a, **k):
        real(*a, **k)
        raise RuntimeError("injected decode-block failure")

    engine._decode_block = boom
    arena = engine.pool.nbytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    engine._decode_block = real
    drive(torch, engine, [], f"4j-d {layout} after the failure",
          errors_ok=True)
    failed = {r.request_id for r in reqs if r.finish_reason.value == "error"}
    finished = [r for r in reqs if r.finish_reason.value in ("stop",
                                                             "length")]
    again = [ns.Request(prompt_tokens=list(p),
                        sampling=ns.SamplingParams(max_tokens=8))
             for p in random_prompts(ns, 2, 50, 60, seed=19)]
    drive(torch, engine, again, f"4j-d {layout} served again")
    rec = {"live_failed": len(failed), "pending_finished": len(finished),
           "arena_bytes": arena, "peak_above_before_bytes": peak}
    log(f"  4j-d {layout} decode block raised: {len(failed)} live failed "
        f"(decode block failed: injected), {len(finished)} pending finished, "
        f"peak allocated {peak / 2**20:.1f} MiB above before the failure "
        f"against a {arena / 2**20:.1f} MiB arena; served 2 more")
    if failed != live or len(finished) != len(reqs) - len(live) or \
            peak >= arena or not all(
                "decode block failed: injected" in r.error
                for r in reqs if r.request_id in failed):
        raise AssertionError(f"4j-d {layout} block failure: {rec}")
    del engine
    return rec


def check_watchdog_drain(torch, serve_mod):
    """4j-e, on servers built as ``launch/serve.py`` builds them: a
    ``slow_step`` fault (1.0 s steps, ``--watchdog-timeout 0.5``) flips
    ``/readyz`` to 503 and back; the echo completion over a ~500-token
    prompt (4j-c over HTTP) and ``error_echo_stream``'s 400; ``POST
    /admin/drain`` lets 4 in-flight requests finish while a new one gets
    the 503 ``draining`` envelope with ``Retry-After``; on 16-token pages a
    drain past ``--drain-timeout`` publishes the 8 live slots' exact
    sequences (pages incref'd), aborts all 10 requests and leaves no page
    pinned."""
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    out = {}

    def build(*flags):
        # --shed-wait 0: a burst is judged by queue depth alone (with no
        # release rate observed yet the estimated wait is infinite)
        args = serve_mod.parse_args(["--arch", QWEN, "--port", "0",
                                     "--cache-len", "2048", "--shed-wait",
                                     "0", *flags])
        srv = serve_mod.build_server(args)
        srv.start()
        return srv

    srv = build("--watchdog-timeout", "0.5", "--fault-rate",
                "slow_step=1.0")
    api = srv.api
    try:
        api.engine.faults.slow_step_s = 1.0
        states = []
        threads, res = fire(srv.port, [chat("wedge me", 2)])
        while threads[0].is_alive():
            states.append(http(srv.port, "/readyz")[0])
            time.sleep(0.05)
        threads[0].join()
        api.engine.faults = None
        wait_for(lambda: http(srv.port, "/readyz")[0] == 200,
                 "/readyz back to 200", timeout=10, phase="4j-e")
        trips = api.client.stats()["watchdog"]["trips"]
        out["watchdog"] = {"readyz_503_polls": states.count(503),
                           "readyz_polls": len(states), "trips": trips}
        log(f"  4j-e watchdog: /readyz 503 on {states.count(503)} of "
            f"{len(states)} polls during 1.0 s steps, {trips} trips, 200 "
            "after")
        if res[0][0] != 200 or not states.count(503) or trips < 1:
            raise AssertionError(f"4j-e watchdog: {out['watchdog']}, "
                                 f"{res[0][0]}")
        # echo over HTTP on the bf16 server
        text = " ".join(f"word{i:03d}" for i in range(62))
        body = {"prompt": text, "max_tokens": 4, "echo": True, "logprobs": 1}
        code, _, resp = http(srv.port, "/v1/completions", body)
        n_prompt = len(tok.encode(text))
        lps = resp["choices"][0]["logprobs"]["token_logprobs"] \
            if code == 200 else []
        usage = resp.get("usage", {})
        ok = (code == 200 and len(lps) == n_prompt
              + usage.get("completion_tokens", -1) and lps[0] is None
              and all(math.isfinite(x) and x <= 0 for x in lps[1:])
              and resp["choices"][0]["text"].startswith(text))
        stream_code = http(srv.port, "/v1/completions", {
            "prompt": "echo me", "max_tokens": 4, "echo": True,
            "stream": True})[0]
        out["echo"] = {"prompt_tokens": n_prompt, "entries": len(lps),
                       "stream_status": stream_code}
        log(f"  4j-c over HTTP: echo + logprobs on a {n_prompt}-token "
            f"prompt: {len(lps)} entries (first null, the rest <= 0: {ok}); "
            f"echo + stream -> {stream_code}")
        if not ok or stream_code != 400:
            raise AssertionError(f"4j-c echo over HTTP: {code} {resp}")
        # graceful drain: in-flight requests finish, new ones get 503
        threads, res = fire(srv.port, [chat(f"keep going {i}", 256)
                                       for i in range(4)])
        wait_for(lambda: len(api.engine._live_slots) == 4,
                 "4 live slots", timeout=60, phase="4j-e")
        code, _, body = http(srv.port, "/admin/drain", {"timeout_s": 120})
        rejected = http(srv.port, "/v1/chat/completions", chat("too late"))
        ready = http(srv.port, "/readyz")
        for t in threads:
            t.join(timeout=300)
        reasons = [r[2]["choices"][0]["finish_reason"] for r in res]
        err = rejected[2].get("error", {})
        out["drain"] = {"status": code, "rejected": rejected[0],
                        "code": err.get("code"), "reasons": reasons,
                        "readyz": ready[0]}
        log(f"  4j-e drain: POST /admin/drain {code} {body}; a new request "
            f"{rejected[0]} {err.get('type')}/{err.get('code')} Retry-After "
            f"{rejected[1].get('Retry-After')}; /readyz {ready[0]} "
            f"{ready[2]}; in-flight finished {reasons}")
        if code != 202 or rejected[0] != 503 or \
                err.get("code") != "draining" or \
                int(rejected[1].get("Retry-After", 0)) < 1 or \
                ready[0] != 503 or not ready[2]["draining"] or \
                any(r not in ("stop", "length") for r in reasons):
            raise AssertionError(f"4j-e drain: {out['drain']}")
        wait_for(lambda: not api.client.alive, "drained", timeout=60,
                 phase="4j-e")
    finally:
        srv.stop()
        api.client.stop()

    srv = build("--kv-layout", "paged", "--drain-timeout", "0.5")
    api = srv.api
    try:
        engine = api.engine
        threads, res = fire(srv.port, [chat(f"long job {i} " * 20, 1024)
                                       for i in range(10)])
        wait_for(lambda: len(engine._live_slots) == 8 and all(
            len(r.output_tokens) >= 8 for r in list(
                engine.scheduler.active.values())), "8 live slots",
            timeout=120, phase="4j-e")
        live = [r for r in list(engine.scheduler.active.values())]
        code = http(srv.port, "/admin/drain", {})[0]
        for t in threads:
            t.join(timeout=120)
        reasons = [r[2]["choices"][0]["finish_reason"] for r in res]
        wait_for(lambda: not api.client.alive, "cutoff", timeout=60,
                 phase="4j-e")
        occ = engine.pool.page_occupancy()
        held = []
        for r in live:
            value = engine.prefix_cache.take_exact(r.prompt_tokens
                                                   + r.output_tokens)
            held.append(0 if value is None else len(value["pages"]))
            if value is not None:
                engine._release_snapshot_value(value)
        out["cutoff"] = {"status": code, "reasons": reasons,
                         "published_pages": held, "kv_pages": occ}
        log(f"  4j-e drain cutoff (--drain-timeout 0.5, pages): POST "
            f"{code}, finishes {reasons}; exact entries of the 8 live slots "
            f"hold {held} pages; pages {occ}")
        if code != 202 or reasons != ["abort"] * 10 or len(live) != 8 or \
                not all(held) or occ["pinned"] or \
                occ["reclaimable"] < sum(held):
            raise AssertionError(f"4j-e cutoff: {out['cutoff']}")
    finally:
        srv.stop()
        api.client.stop()
    return out


def slot_cells(torch, engine, slot, n):
    """A slot's cache cells at positions < n, leaf by leaf (on pages the
    raw contents: int8 values and their scales)."""
    pool, out = engine.pool, []
    subs = [(sub, False) for sub in pool.cache["prefix"]]
    subs += [(sub, True) for sub in (pool.cache.get("block") or {}).values()]
    for sub, stacked in subs:
        for name in sorted(sub):
            leaf = sub[name]
            if engine._paged:
                ids = torch.tensor(pool.slot_pages(slot), device="cuda")
                rows = (leaf[:, ids] if stacked else leaf[ids]).flatten(
                    int(stacked), int(stacked) + 1)
            else:
                rows = leaf[:, slot] if stacked else leaf[slot]
            out.append((rows[:, :n] if stacked else rows[:n]).clone())
    return out


def check_handoff(torch, ns, wrappers, params):
    """4j-f: two engines on the card, dense, fp pages and int8 pages: 10
    requests on A (8 live, 2 queued), exported mid-decode and imported
    into B.  B's tokens equal an undrained run's; its 8 snapshots resume
    with no flash launch (the prefill rows B runs are the queued requests'
    alone, flash 24 x B's waves); the resumed slots' cells equal A's bit
    for bit (int8 values and scales on int8 pages)."""
    prompts = random_prompts(ns, 10, 200, 600, seed=23)
    out = {}
    for label, kw in (("dense", {}), ("paged", LAYOUTS_4J["paged"]),
                      ("int8", dict(LAYOUTS_4J["paged"], kv_dtype="int8"))):
        def reqs():
            return [ns.Request(prompt_tokens=list(p),
                               sampling=ns.SamplingParams(max_tokens=48))
                    for p in prompts]
        layout = "dense" if label == "dense" else "paged"
        undrained = reqs()
        drive(torch, engine_4j(ns, params, **kw), undrained,
              f"4j-f {label} undrained")
        a = engine_4j(ns, params, **kw)
        moving = reqs()
        for r in moving:
            a.add_request(r)
        while len(a._live_slots) < 8 or any(
                a.scheduler.active[s].num_generated < 4
                for s in a._live_slots):
            a.step()
        cells = {}
        for s in a._live_slots:
            r = a.scheduler.active[s]
            n = len(r.prompt_tokens) + r.num_generated - 1
            cells[r.request_id] = (n, slot_cells(torch, a, s, n))
        records = a.export_handoff()
        snap = {rec["req"].request_id for rec in records
                if rec["cache"] is not None}
        del a
        b = engine_4j(ns, params, **kw)
        rows = []
        inner = b._run_wave_group

        def run_wave_group(bucket, cross, group):
            rows.extend(job.req.request_id for job, _ in group)
            return inner(bucket, cross, group)

        b._run_wave_group = run_wave_group
        for rec in records:
            b.import_handoff(rec)
        zero(wrappers)
        b._plan_admissions()
        same_cells = all(
            all(torch.equal(x, y) for x, y in zip(
                slot_cells(torch, b, s, cells[r.request_id][0]),
                cells[r.request_id][1]))
            for s, r in b.scheduler.active.items() if r.request_id in cells)
        drive(torch, b, [], f"4j-f {label} on B")
        launches = counted(wrappers)
        require_engine_launches(launches, b, layout, f"4j-f {label} B")
        same = [r.output_tokens for r in moving] == \
            [r.output_tokens for r in undrained]
        st = b.scheduler.stats
        rec = {"records": len(records), "snapshots": len(snap),
               "resumed": st.resumed, "b_prefill_rows_of_snapshots":
               len(set(rows) & snap), "b_prefill_waves": st.prefill_waves,
               "tokens_identical": same, "cells_identical": same_cells,
               "launches": launches}
        log(f"  4j-f {label}: {len(records)} records ({len(snap)} "
            f"snapshots), B resumed {st.resumed}, B prefill rows of "
            f"snapshotted requests {rec['b_prefill_rows_of_snapshots']} "
            f"(waves {st.prefill_waves}, launches {launches}); resumed "
            f"cells equal A's bit for bit {same_cells}; tokens identical "
            f"to the undrained run {same}")
        if len(records) != 10 or snap != set(cells) or st.resumed != 8 or \
                rec["b_prefill_rows_of_snapshots"] or not same_cells or \
                not same:
            raise AssertionError(f"4j-f {label}: {rec}")
        out[label] = rec
        del b
    return out


# --------------------------------------------------------------------------- #
# phase 4k: multi-replica serving (router, ASGI transport, async client,
# batch) on qwen2-0.5b, bf16, 24 layers
# --------------------------------------------------------------------------- #
SEED_BODY = {"temperature": 0.8, "top_p": 0.9, "seed": 1234}


def launcher_4k(serve_mod, *extra):
    """A server built as ``launch/serve.py --replicas 2 --router-policy
    affinity --transport asgi`` builds it (8 slots, a 2048 ring, the seeded
    weights every phase serves, admission on with ``--shed-wait 0``), not
    started; ``extra`` adds or overrides flags."""
    return serve_mod.build_server(serve_mod.parse_args(
        ["--arch", QWEN, "--port", "0", "--max-batch", "8", "--cache-len",
         "2048", "--shed-wait", "0", "--replicas", "2", "--router-policy",
         "affinity", "--transport", "asgi", *extra]))


def mix_4k():
    """(headers, kind, body) of 4k-a's mix: 16 chats in 8 ``x-session``s
    (two turns each, greedy) and 4b's 6 shared-system-prompt chats."""
    out = [({"x-session": f"sess-{i % 8}"}, "chat",
            chat(f"[{i % 8}] session {i % 8}, turn {i // 8}: describe part "
                 f"{100 + i} of the catalogue", max_tokens=10 + i))
           for i in range(16)]
    return out + [({}, kind, body) for kind, body in shared_prompt_chats()]


def send_4k(port, items, tok):
    """All items at once, a thread each; every response checked (status,
    finish_reason, usage).  Returns (texts, completion tokens, wall s)."""
    out = [None] * len(items)

    def one(i):
        hdr, kind, body = items[i]
        path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
        out[i] = http(port, path, body, hdr)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    done = 0
    for (hdr, kind, body), res in zip(items, out):
        if res is None or res[0] != 200:
            raise AssertionError(f"4k: {body} failed: {res}")
        done += check_response(kind, body, res[2], tok)
    return [text_of(b, r[2]) for (_, _, b), r in zip(items, out)], done, wall


def recording(router) -> list:
    """Wrap each replica's ``submit``: every request placed on replica i
    appends (i, session, prompt) to the returned list."""
    placed = []
    for i, rep in enumerate(router.replicas):
        inner = rep.client.submit

        def submit(greq, i=i, inner=inner):
            placed.append((i, greq.session, greq.prompt))
            return inner(greq)

        rep.client.submit = submit
    return placed


def replicas_4k(stats) -> dict:
    """Per replica: (device steps, prefill waves, prefix-cache hits and
    misses, retired, requests the router placed there: 0 without one)
    from a /stats v2 ``replicas[]``."""
    return {r["name"]: {"device_steps": r["device_steps"],
                        "prefill_waves": r["prefill_waves"],
                        "hits": r["prefix_cache"]["hits"],
                        "misses": r["prefix_cache"]["misses"],
                        "retired": r["retired"],
                        "submitted": r.get("submitted", 0)}
            for r in stats["replicas"]}


def round_4k(torch, srv, wrappers, tok, *, count=False):
    """The 4k-a mix twice (the first takes the first-call costs); the
    second is counted: launches zeroed just before and read just after,
    per-replica counters read from /stats v2 around it.  Returns (texts,
    completion tokens, wall, launches, per-replica deltas, /stats)."""
    send_4k(srv.port, mix_4k(), tok)
    before = replicas_4k(http(srv.port, "/stats")[2])
    if count:
        zero(wrappers)
    texts, done, wall = send_4k(srv.port, mix_4k(), tok)
    torch.cuda.synchronize()
    launches = counted(wrappers) if count else None
    stats = http(srv.port, "/stats")[2]
    after = replicas_4k(stats)
    delta = {n: {k: after[n][k] - before[n][k] for k in after[n]}
             for n in after}
    return texts, done, wall, launches, delta, stats


def check_router_serving(torch, serve_mod, wrappers):
    """4k-a (fp pages) and the readings: the mix served twice by two
    replicas behind the affinity router over HTTP (ASGI); each session's
    turns on one replica, the shared-prompt chats on one replica with
    digest placements and prefix-cache hits there, greedy texts equal to a
    single-replica server's, usage right, no page pinned, the kernels as
    counted over both replicas.  Readings: tokens/s against one replica,
    the prefix-hit share against ``--router-policy random``.  Returns the
    record and the still-running affinity server (4k-c runs on it)."""
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    paged = ("--kv-layout", "paged", "--kv-page-size", "16")
    rec = {}
    single = launcher_4k(serve_mod, *paged, "--replicas", "1")
    single.start()
    try:
        want, n1, wall1, _, _, _ = round_4k(torch, single, wrappers, tok)
    finally:
        single.stop()
        single.api.client.stop()
    del single
    gc.collect()
    torch.cuda.empty_cache()
    srv = launcher_4k(serve_mod, *paged)
    router = srv.api.client
    placed = recording(router)
    srv.start()
    texts, n2, wall2, launches, delta, stats = round_4k(
        torch, srv, wrappers, tok, count=True)
    layers = srv.api.engine.cfg.num_layers
    steps = sum(d["device_steps"] for d in delta.values())
    waves = sum(d["prefill_waves"] for d in delta.values())
    want_l = {"paged_attention": layers * steps, "decode_attention": 0,
              "flash_attention": layers * waves,
              "rmsnorm": (2 * layers + 1) * (steps + waves)}
    if any(launches[k] != v for k, v in want_l.items()) or not steps:
        raise AssertionError(f"4k-a launches {launches}, want {want_l}")
    sessions = {}
    for i, sess, _ in placed:
        if sess is not None:
            sessions.setdefault(sess, set()).add(i)
    system = shared_prompt_chats()[0][1]["messages"][0]["content"]
    shared = {i for i, _, p in placed if system in p}
    warm = f"replica-{next(iter(shared))}" if len(shared) == 1 else None
    rstats = stats["router"]
    pages = [r["kv_pages"] for r in stats["replicas"]]
    rec["a_paged"] = {
        "placements": rstats["placements"],
        "sessions_pinned": rstats["sessions_pinned"],
        "session_replicas": {k: sorted(v) for k, v in sessions.items()},
        "shared_prompt_replicas": sorted(shared), "replicas": delta,
        "texts_equal_single_replica": sum(a == b for a, b in
                                          zip(texts, want)),
        "requests": len(texts), "completion_tokens": n2,
        "tokens_per_s": n2 / wall2, "single_replica_tokens_per_s":
            n1 / wall1, "launches": launches,
        "pinned_pages": [p["pinned"] for p in pages]}
    log(f"  4k-a: 2 replicas (affinity, fp pages, ASGI): placements "
        f"{rstats['placements']}, {rstats['sessions_pinned']} sessions "
        f"pinned, each on one replica {all(len(v) == 1 for v in sessions.values())}"
        f"; shared-prompt chats on {sorted(shared)}; per replica {delta}; "
        f"texts equal to one replica {rec['a_paged']['texts_equal_single_replica']}"
        f"/{len(texts)}; {n2 / wall2:.1f} tokens/s vs {n1 / wall1:.1f} "
        f"with one replica; launches {launches}")
    if len(sessions) != 8 or any(len(v) != 1 for v in sessions.values()) \
            or rstats["sessions_pinned"] != 8 or warm is None \
            or rstats["placements"]["session"] < 24 \
            or rstats["placements"]["prefix"] < 11 \
            or delta[warm]["hits"] < 6 or texts != want \
            or any(p["pinned"] or p["free"] + p["reclaimable"] != p["total"]
                   for p in pages):
        raise AssertionError(f"4k-a: {rec['a_paged']}, pages {pages}")
    rnd = launcher_4k(serve_mod, *paged, "--router-policy", "random")
    rnd.start()
    try:
        _, _, _, _, rdelta, _ = round_4k(torch, rnd, wrappers, tok)
    finally:
        rnd.stop()
        rnd.api.client.stop()
    del rnd
    gc.collect()

    def share(d):
        hits = sum(r["hits"] for r in d.values())
        return hits / max(1, hits + sum(r["misses"] for r in d.values()))

    rec["prefix_hit_share"] = {"affinity": share(delta),
                               "random": share(rdelta)}
    log(f"  4k readings: prefix-hit share affinity "
        f"{share(delta):.3f} vs random {share(rdelta):.3f}")
    return rec, srv


def check_asgi_4k(torch, srv):
    """4k-c on the affinity server of 4k-a: 32 concurrent SSE streams all
    finish; a client that disconnects mid-stream raises /stats ``aborted``
    within 2 s; ``batch`` of 8 bodies equals 8 single calls; the ASGI
    lifespan protocol; after ``POST /admin/drain`` a new stream gets the
    structured 503 ``draining`` envelope with ``Retry-After``."""
    import asyncio
    import socket

    from repro_torch.serving.asgi import build_app
    api, port = srv.api, srv.port
    try:
        streams = [None] * 32

        def one(i):
            streams[i] = post(port, "/v1/chat/completions",
                              chat(f"stream {i}", max_tokens=8, stream=True))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        finished = sum(1 for r in streams if r and any(
            c["choices"] and c["choices"][0]["finish_reason"] for c in r))
        before = http(port, "/stats")[2]["aborted"]
        body = json.dumps(chat("never ending", max_tokens=1500,
                               stream=True)).encode()
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nhost: x\r\n"
                     b"content-type: application/json\r\ncontent-length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        sock.recv(1)
        sock.close()
        t0 = time.perf_counter()
        wait_for(lambda: http(port, "/stats")[2]["aborted"] > before,
                 "the disconnect's abort", timeout=30, phase="4k-c")
        abort_s = time.perf_counter() - t0
        bodies = [chat(f"batch question {i}", max_tokens=6 + i)
                  for i in range(8)]
        batch = api.batch(bodies)
        singles = [api.chat_completion(b) for b in bodies]
        batch_same = [a["choices"][0]["message"] == b["choices"][0]["message"]
                      and a["usage"] == b["usage"]
                      for a, b in zip(batch, singles)]
        sent = []
        msgs = iter([{"type": "lifespan.startup"},
                     {"type": "lifespan.shutdown"}])

        async def receive():
            return next(msgs)

        async def send(msg):
            sent.append(msg["type"])

        asyncio.run(build_app(api)({"type": "lifespan"}, receive, send))
        code, _, out = http(port, "/admin/drain", {"timeout_s": 30})
        if code != 202:
            raise AssertionError(f"4k-c: drain answered {code} {out}")
        code, hdrs, err = http(port, "/v1/chat/completions",
                               chat("too late", stream=True))
    finally:
        srv.stop()
        api.client.stop()
    rec = {"sse_streams_finished": finished, "disconnect_abort_s": abort_s,
           "batch_equal_singles": sum(batch_same),
           "lifespan": sent, "post_drain": [code, err.get("error", {}).get(
               "code"), hdrs.get("Retry-After")]}
    log(f"  4k-c: {finished}/32 SSE streams finished; disconnect aborted in "
        f"{abort_s:.3f} s; batch of 8 equal to single calls "
        f"{sum(batch_same)}/8; lifespan {sent}; after /admin/drain a stream "
        f"got {rec['post_drain']}")
    if finished != 32 or abort_s > 2.0 or not all(batch_same) or \
            sent != ["lifespan.startup.complete",
                     "lifespan.shutdown.complete"] or \
            rec["post_drain"][:2] != [503, "draining"] or \
            not rec["post_drain"][2]:
        raise AssertionError(f"4k-c: {rec}")
    return rec


def check_router_drain(torch, ns, serve_mod, wrappers):
    """4k-b and 4k-d, on the dense ring and on fp pages: a seeded
    stochastic request (temperature 0.8, top-p 0.9, seed 1234) served on
    each replica; 12 requests placed on replica 0 (8 live, 4 queued, each
    in a session of its own), then ``Router.drain_replica(0)``: every
    output equals an undrained single engine's, the migrated live slots
    resume with no flash launch (replica 1 prefills the queued requests
    alone), each handle's stream carries every token and one finish, the
    session pins move to replica 1, and the seeded request served again
    after the drain gives the same tokens."""
    from repro_torch.core.request import GenerationRequest
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    prompts = random_prompts(ns, 12, 200, 600, seed=29)
    # under one 16-token prefix block, so no replica serves it from its
    # prefix cache (every run prefills it whole, as the first)
    seeded = GenerationRequest(
        prompt=tok.encode("seeded request"),
        sampling=ns.SamplingParams(max_tokens=24, **SEED_BODY))
    out = {}
    for label, flags in (("dense", ()), ("paged", ("--kv-layout", "paged",
                                                   "--kv-page-size", "16"))):
        srv = launcher_4k(serve_mod, *flags)
        router = srv.api.client
        try:
            reps = router.replicas
            seeded_tokens = [rep.client.submit(seeded).result(
                timeout=600).choices[0].tokens for rep in reps]
            reps[1].state = "draining"            # place all on replica 0
            handles = [router.submit(GenerationRequest(
                prompt=list(p), session=f"drain-{label}-{i}",
                sampling=ns.SamplingParams(max_tokens=48)))
                for i, p in enumerate(prompts)]
            reps[1].state = "up"
            wait_for(lambda: sum(h._requests[0].num_generated >= 4
                                 for h in handles) >= 8,
                     "8 live slots 4 tokens in", phase="4k-b")
            live = {h._requests[0].request_id for h in handles
                    if h._requests[0].num_generated > 0}
            b_engine = reps[1].client.engine
            rows = []
            inner = b_engine._run_wave_group

            def run_wave_group(bucket, cross, group):
                rows.extend(job.req.request_id for job, _ in group)
                return inner(bucket, cross, group)

            b_engine._run_wave_group = run_wave_group
            waves0 = b_engine.scheduler.stats.prefill_waves
            zero(wrappers)
            info = router.drain_replica(0)
            results = [h.result(timeout=600) for h in handles]
            torch.cuda.synchronize()
            launches = counted(wrappers)
            waves = b_engine.scheduler.stats.prefill_waves - waves0
            layers = b_engine.cfg.num_layers
            streams = [list(h.stream()) for h in handles]
            gapless = all(
                [e.token for e in ev if type(e).__name__ == "TokenEvent"]
                == r.choices[0].tokens and sum(
                    type(e).__name__ == "FinishEvent" for e in ev) == 1
                for ev, r in zip(streams, results))
            pins = {router._sessions[f"drain-{label}-{i}"]
                    for i in range(len(prompts))}
            seeded_tokens.append(router.submit(seeded).result(
                timeout=600).choices[0].tokens)
            undrained = [ns.Request(prompt_tokens=list(p),
                                    sampling=ns.SamplingParams(max_tokens=48))
                         for p in prompts]
            kw = {} if label == "dense" else LAYOUTS_4J["paged"]
            drive(torch, engine_4j(ns, reps[0].client.engine.params, **kw),
                  undrained, f"4k-b {label} undrained")
        finally:
            router.stop()
        same = [r.choices[0].tokens for r in results] == \
            [r.output_tokens for r in undrained]
        rec = {"exported": info["exported"], "adopted": info["adopted"],
               "live_at_drain": len(live), "b_prefill_rows_of_live":
               len(set(rows) & live), "b_prefill_waves": waves,
               "launches": launches, "tokens_identical": same,
               "streams_gapless": gapless, "pins": sorted(pins),
               "seeded_identical": all(t == seeded_tokens[0]
                                       for t in seeded_tokens),
               "seeded_len": len(seeded_tokens[0])}
        log(f"  4k-b/d {label}: drained {info}; {len(live)} live at the "
            f"drain, replica 1 prefill rows of them "
            f"{rec['b_prefill_rows_of_live']} ({waves} waves, launches "
            f"{launches}); outputs equal to an undrained engine {same}; "
            f"streams gapless {gapless}; session pins {sorted(pins)}; "
            f"seeded request on replica 0, 1 and after the drain identical "
            f"{rec['seeded_identical']}")
        used = "decode_attention" if label == "dense" else "paged_attention"
        if info["exported"] != 12 or info["adopted"] != 12 or \
                len(live) != 8 or rec["b_prefill_rows_of_live"] or not same \
                or not gapless or pins != {1} \
                or not rec["seeded_identical"] or len(seeded_tokens[0]) != 24 \
                or launches["flash_attention"] != layers * waves \
                or not launches[used]:
            raise AssertionError(f"4k-b {label}: {rec}")
        out[label] = rec
        del srv, router
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# the flash backward (phase 2 checks, phase 5 times)
# --------------------------------------------------------------------------- #
# (label, B, Sq, Skv, H, Hkv, D, causal, window): the training shapes of the
# families, from qwen2-0.5b's main path to the audio encoder-decoder's
BWD_FORMS = (
    ("qwen2 S512", 4, 512, 512, 14, 2, 64, True, 0),
    ("qwen2 S2048", 1, 2048, 2048, 14, 2, 64, True, 0),
    ("glm4 window 256", 1, 1024, 1024, 32, 2, 128, True, 256),
    ("deepseek G1 D128", 2, 512, 512, 16, 16, 128, True, 0),
    ("vision cross", 1, 300, 2304, 64, 8, 128, False, 0),
    ("seamless encoder", 2, 512, 512, 16, 16, 64, True, 0),
    ("seamless cross", 2, 200, 512, 16, 16, 64, False, 0),
    ("ragged Sq 333", 2, 333, 333, 14, 2, 64, True, 0),
)
# the backward kernel against its plain version, relative to the largest
# plain gradient: float32 products summed in another order (readings ~1e-6
# on the H100 before this script held them), and in bf16 one rounding of
# each output at the store on both sides (readings up to 2.2e-3)
BWD_REL = {"bfloat16": 1e-2, "float32": 1e-5}
# the forward's log-sum-exp against the plain version's, absolute: both sum
# the same (bf16-valued) products in float32 in another order (readings up
# to 2e-6 on the H100)
LSE_ATOL = 1e-4
BWD_TRAIN = dict(b=8, s=512, h=14, hkv=2, d=64)   # 6a's bf16 training step


def bwd_case(torch, fla, dtype, b, sq, skv, h, hkv, d, causal, window,
             seed=0):
    """((q, k, v, out, dout), lse): random inputs, the forward kernel's
    output and log-sum-exp (``return_lse``), as the training form's
    autograd node keeps them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    out, lse = fla.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    return (q, k, v, out, do), lse


def check_flash_bwd(torch, fla) -> dict:
    """At :data:`BWD_FORMS` in bf16 and float32: the forward's output with
    ``return_lse`` bit for bit the output without it, its LSE against the
    plain LSE (:data:`LSE_ATOL`); the backward kernel given that LSE
    against ``flash_attention_bwd_plain`` (each of dq, dk, dv relative to
    its largest plain entry), two calls and a call that gets the LSE
    itself bit for bit equal.  Returns the largest absolute and relative
    errors and the largest LSE error."""
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0, "lse_max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for label, *shape in BWD_FORMS:
            causal, window = shape[-2:]
            args, lse = bwd_case(torch, fla, dtype, *shape)
            q, k, v, out, _ = args
            out_same = bool(torch.equal(out, fla.flash_attention_cuda(
                q, k, v, causal=causal, window=window)))
            got = fla.flash_attention_bwd_cuda(*args, causal=causal,
                                               window=window, lse=lse)
            again = fla.flash_attention_bwd_cuda(*args, causal=causal,
                                                 window=window, lse=lse)
            own = fla.flash_attention_bwd_cuda(*args, causal=causal,
                                               window=window)
            torch.cuda.synchronize()
            _, plse = fla.flash_attention_plain(q, k, v, causal=causal,
                                                window=window,
                                                return_lse=True)
            lse_err = max_err(torch, lse, plse)
            want = fla.flash_attention_bwd_plain(*args, causal=causal,
                                                 window=window)
            errs = [max_err(torch, a, w) for a, w in zip(got, want)]
            rels = [e / w.float().abs().max().item()
                    for e, w in zip(errs, want)]
            same = all(bool(torch.equal(a, c)) and bool(torch.equal(a, o))
                       for a, c, o in zip(got, again, own))
            ok = (max(rels) <= BWD_REL[dname] and same and out_same
                  and lse_err <= LSE_ATOL
                  and all(bool(torch.isfinite(a).all()) for a in got))
            log(f"  flash_attention_bwd {dname:8s} {label:18s} "
                f"max|kernel-plain|/max|plain| dq {rels[0]:.2e} dk "
                f"{rels[1]:.2e} dv {rels[2]:.2e} (tol {BWD_REL[dname]:g}); "
                f"two calls and one without the LSE bit for bit {same}; "
                f"forward LSE max|kernel-plain| {lse_err:.2e} (tol "
                f"{LSE_ATOL:g}), out unchanged by return_lse {out_same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_bwd {dname} {label}: "
                                     f"{rels}, repeat equal {same}, lse "
                                     f"{lse_err}, out equal {out_same}")
            worst["max_abs_err"] = max(worst["max_abs_err"], *errs)
            worst["max_rel_err"] = max(worst["max_rel_err"], *rels)
            worst["lse_max_abs_err"] = max(worst["lse_max_abs_err"], lse_err)
            del args, lse, got, again, own, want, plse
        torch.cuda.empty_cache()
    return worst


def check_rmsnorm_fn(torch, ops, rms) -> float:
    """``RmsnormFn`` (the kernel forward, the float32 backward) against
    autograd through ``rmsnorm_plain``: dx and dw at 2048 rows of D 896
    (qwen2-0.5b's training rows), float32 (1e-5 of the largest plain
    gradient) and bf16 x with float32 w (1e-2)."""
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(17)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = (torch.randn((2048, 896), generator=g, device="cuda") * 2
             ).to(dtype)
        w = 1 + 0.1 * torch.randn((896,), generator=g, device="cuda")
        dy = torch.randn((2048, 896), generator=g, device="cuda").to(dtype)
        xs = [x.clone().requires_grad_() for _ in range(2)]
        ws = [w.clone().requires_grad_() for _ in range(2)]
        got = torch.autograd.grad(ops.RmsnormFn.apply(
            xs[0], ws[0], 1e-6, rms.rmsnorm_cuda), (xs[0], ws[0]), dy)
        want = torch.autograd.grad(rms.rmsnorm_plain(xs[1], ws[1], 1e-6),
                                   (xs[1], ws[1]), dy)
        rels = [max_err(torch, a, b) / b.float().abs().max().item()
                for a, b in zip(got, want)]
        ok = max(rels) <= tol
        log(f"  RmsnormFn         {str(dtype).split('.')[-1]:8s} 2048x896: "
            f"dx {rels[0]:.2e} dw {rels[1]:.2e} of the largest plain "
            f"gradient (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"RmsnormFn grads disagree: {rels}")
        worst = max(worst, *rels)
    return worst


def time_flash_bwd(torch, fla, F) -> dict:
    """The backward kernel at 6a's bf16 training shape (B 8 x S 512,
    qwen2-0.5b's heads, causal), given the forward's LSE as training gives
    it, so the backward alone is timed, as SDPA's graph is: a call and
    device alone, its plain version (given the same LSE), and SDPA's
    backward as the library yardstick (autograd.grad of one
    ``scaled_dot_product_attention`` graph, kept between calls);
    ``bound_ms`` by operations, five products of the forward's size halved
    under causal, at the bf16 tensor-core rate, against the bytes of q, k,
    v, out, dout and the LSE read and dq, dk, dv written once."""
    b, s, h, hkv, d = (BWD_TRAIN[k] for k in ("b", "s", "h", "hkv", "d"))
    one, one_lse = bwd_case(torch, fla, torch.bfloat16, b, s, s, h, hkv, d,
                            True, 0)
    n_sets = max(2, 2 * L2_BYTES // nbytes(*one, one_lse) + 1)
    sets = [bwd_case(torch, fla, torch.bfloat16, b, s, s, h, hkv, d, True, 0,
                     seed=i) for i in range(n_sets)]
    graphs = []
    for (q, k, v, _, do), _ in sets:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        graphs.append((out, (qt, kt, vt), do.transpose(1, 2).contiguous()))
    kern = lambda i: fla.flash_attention_bwd_cuda(  # noqa: E731
        *sets[i][0], lse=sets[i][1])
    lib = lambda i: torch.autograd.grad(  # noqa: E731
        graphs[i][0], graphs[i][1], graphs[i][2], retain_graph=True)
    flops = 5 * 2 * b * h * s * s * d / 2
    byts = nbytes(*one, one_lse) + nbytes(*one[:3])
    row = {"ms": time_ms(torch, kern, n_sets),
           "device_ms": device_ms(torch, kern, n_sets),
           "plain_ms": time_ms(torch, lambda i: fla.flash_attention_bwd_plain(
               *sets[i][0], lse=sets[i][1]), n_sets, cycles=1),
           "library_ms": time_ms(torch, lib, n_sets),
           "library_device_ms": device_ms(torch, lib, n_sets),
           "library": "SDPA backward",
           **bound(byts, flops),
           "shape": f"B{b} S{s} H{h} Hkv{hkv} D{d} bf16 causal, {n_sets} sets"}
    del sets, graphs
    return row


# --------------------------------------------------------------------------- #
# phase 6: training
# --------------------------------------------------------------------------- #
# kernels vs plain gradients, each leaf relative to its largest plain
# entry, in float32: the attention and norm kernels' outputs differ from
# the plain versions' by float32 summation order (~1e-6), which the
# 24-layer backward carries into every leaf
TRAIN_GRAD_REL = 1e-3
TRAIN_LOSS_REL = 1e-5
# microbatches 2 against 1: the same gradient summed over two halves, in
# float32 (the first moment after one step is 0.1 x the clipped gradient)
MICRO_REL = 1e-4
TRAIN_STEPS = 30
TRAIN_DATA_VOCAB = 512    # the bigram data's ids, as examples/train_tiny.py


def train_batch(torch, tts, vocab, b, s, seed, phrase=False):
    """A training batch of random tokens (``phrase``: row 0 one repeated
    6-token phrase, which crowds an MoE layer's experts past capacity)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, vocab, (b, s), generator=g, device="cuda")
    if phrase:
        toks[0] = phrase_prompt(torch, g, vocab, s)
    return tts.batch_to({"tokens": toks, "labels": toks.roll(-1, 1),
                         "mask": torch.ones((b, s), device="cuda")}, "cuda")


def grads_vs_plain(torch, ns, cfg, params, batch, what, *,
                   tol=TRAIN_GRAD_REL, **kw) -> dict:
    """One loss and every gradient leaf through the kernels against the
    same through the plain versions (autograd through
    ``flash_attention_plain`` and ``rmsnorm_plain``): every leaf has a
    finite gradient, each within ``tol`` of its largest plain entry.
    Returns the
    readings, the kernels' launches and the kernels' (loss, grads)."""
    zero(ns.wrappers)
    loss, parts, grads = ns.tts.loss_and_grads(params, batch, cfg=cfg, **kw)
    torch.cuda.synchronize()
    launches = counted(ns.wrappers)
    with plain_attention(ns.ops, names=("flash_attention", "rmsnorm")):
        ploss, pparts, pgrads = ns.tts.loss_and_grads(params, batch, cfg=cfg,
                                                      **kw)
    paths = [p for p, _ in ns.tree_flatten_with_path(params)]
    worst, where = 0.0, None
    for path, g, pg in zip(paths, grads, pgrads):
        if g is None or pg is None:
            raise AssertionError(f"{what}: no gradient for {path}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite gradient for {path}")
        rel = max_err(torch, g, pg) / max(pg.float().abs().max().item(),
                                          1e-30)
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    loss_rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    aux = float(parts["aux_loss"])
    log(f"  {what}: loss {float(loss):.6f} (plain {float(ploss):.6f}, rel "
        f"{loss_rel:.2e}, tol {TRAIN_LOSS_REL:g}), aux {aux:.6f}; "
        f"{len(paths)} leaves, every one with a finite gradient, worst "
        f"max|Δ|/max|plain| {worst:.2e} at {where} (tol {tol:.2g}); "
        f"launches {launches}")
    if loss_rel > TRAIN_LOSS_REL or worst > tol:
        raise AssertionError(f"{what}: kernels vs plain loss {loss_rel}, "
                             f"grads {worst} at {where}")
    return {"loss": float(loss), "plain_loss": float(ploss),
            "loss_rel": loss_rel, "aux_loss": aux, "worst_leaf_rel": worst,
            "worst_leaf": where, "leaves": len(paths),
            "launches": launches, "result": (loss, grads)}


# device kernels by kind in 6a's profiled step: (kind, name fragments);
# a kernel whose name matches none falls to the autograd node or traced
# range it was launched from (PROFILE_SCOPES), else to "the rest"
PROFILE_KERNELS = (
    ("flash forward", ("flash_attention_tc_kernel", "flash_attention_kernel")),
    ("flash backward", ("dkdv_kernel", "dq_kernel", "bwd_delta_kernel")),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")),
    ("rmsnorm forward", ("rmsnorm",)))
PROFILE_SCOPES = (("rmsnorm backward", "RmsnormFnBackward"),
                  ("AdamW", "adamw_update"))


def profile_train_step(torch, ns, step, state, batch) -> dict:
    """One steady training step under ``torch.profiler`` (CPU and CUDA
    activity): device ms by kind (:data:`PROFILE_KERNELS`, then the
    enclosing autograd node or range, :data:`PROFILE_SCOPES`; the AdamW
    update is wrapped in a ``record_function`` range for this call only),
    the step's host wall time and the device's busy share of it.  Returns
    the state after the step too."""
    from torch.profiler import ProfilerActivity, profile, record_function
    adamw = ns.tts.adamw_update

    def traced(*a, **kw):
        with record_function("adamw_update"):
            return adamw(*a, **kw)

    ns.tts.adamw_update = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ns.tts.adamw_update = adamw
    kinds = [k for k, _ in PROFILE_KERNELS] + [k for k, _ in PROFILE_SCOPES]
    ms = {k: 0.0 for k in kinds + ["the rest"]}
    launches = {k: 0 for k in ms}
    for ev in prof.events():
        for kern in ev.kernels:
            kind = next((k for k, frags in PROFILE_KERNELS
                         if any(f in kern.name for f in frags)), None)
            up = ev
            while kind is None and up is not None:
                kind = next((k for k, scope in PROFILE_SCOPES
                             if scope in up.name), None)
                up = up.cpu_parent
            kind = kind or "the rest"
            ms[kind] += kern.duration / 1e3
            launches[kind] += 1
    busy = sum(ms.values())
    return state, {"device_ms": ms, "kernels": launches,
                   "device_busy_ms": busy, "step_wall_ms": wall_ms,
                   "busy_share": busy / wall_ms if wall_ms else None}


def check_training_qwen(torch, ns, get_config) -> dict:
    """6a: ``qwen2-0.5b`` at full depth.  float32 at B 4 x S 512: the
    kernels against the plain versions, remat on against off bit for bit,
    a step with microbatches 2 against 1; bf16 at B 8 x S 512: remat on
    against off bit for bit, 30 steps on the bigram data (the loss falls;
    tokens/s and peak memory read), a checkpoint round trip bit for bit,
    one steady step under the profiler, and the launcher for a few
    steps."""
    out = {}
    cfg32 = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")
    params = ns.Model(cfg32).init(torch.Generator(device="cuda").manual_seed(0))
    batch = train_batch(torch, ns.tts, cfg32.vocab_size, 4, 512, seed=1)
    kp = grads_vs_plain(torch, ns, cfg32, params, batch,
                        "6a float32 B4xS512, remat off", remat=False)
    loss0, grads0 = kp.pop("result")
    if not (kp["launches"]["flash_attention"] and
            kp["launches"]["flash_attention_bwd"]
            and kp["launches"]["rmsnorm"]):
        raise AssertionError(f"6a: a kernel of the path never ran: "
                             f"{kp['launches']}")
    out["f32_kernels_vs_plain"] = kp
    loss1, _, grads1 = ns.tts.loss_and_grads(params, batch, cfg=cfg32,
                                             remat=True)
    same = bool(torch.equal(loss0, loss1)) and all(
        bool(torch.equal(a, b)) for a, b in zip(grads0, grads1))
    log(f"  6a remat on vs off: loss and all {len(grads0)} gradient leaves "
        f"bit for bit {same}")
    if not same:
        raise AssertionError("6a: remat on differs from remat off")
    out["remat_bit_for_bit"] = same
    del grads0, grads1
    opt = ns.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    states, metrics = [], []
    for mb in (1, 2):
        state = ns.tts.init_train_state(
            cfg32, params=ns.tree_map(torch.clone, params))
        _, m = ns.tts.make_train_step(cfg32, opt, remat=False,
                                      microbatches=mb)(state, batch)
        states.append(state["opt"]["m"])
        metrics.append(m)
    worst = max(max_err(torch, a, b) / max(b.abs().max().item(), 1e-30)
                for a, b in zip(ns.tree_leaves(states[1]),
                                ns.tree_leaves(states[0])))
    mrel = max(abs(metrics[1][k] - metrics[0][k]) / max(abs(metrics[0][k]),
                                                         1e-30)
               for k in ("loss", "grad_norm"))
    log(f"  6a microbatches 2 vs 1 (one step, float32): loss / grad norm "
        f"rel {mrel:.2e}, first moments (0.1 x the clipped gradient) "
        f"max|Δ|/max {worst:.2e} (tol {MICRO_REL:g})")
    if worst > MICRO_REL or mrel > MICRO_REL:
        raise AssertionError(f"6a: microbatches 2 vs 1 {worst}, {mrel}")
    out["microbatch_2_vs_1"] = {"moment_rel": worst, "metric_rel": mrel}
    del params, states, batch
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("qwen2-0.5b")
    state = ns.tts.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    data = ns.BigramDataPipeline(TRAIN_DATA_VOCAB, 512, 8, seed=0)
    batch0 = ns.tts.batch_to(data.batch(0), "cuda")
    runs = [ns.tts.loss_and_grads(state["params"], batch0, cfg=cfg,
                                  remat=remat) for remat in (False, True)]
    same = bool(torch.equal(runs[0][0], runs[1][0])) and all(
        (a is None and b is None) or bool(torch.equal(a, b))
        for a, b in zip(runs[0][2], runs[1][2]))
    log(f"  6a bf16 B8xS512 remat on vs off: loss and all {len(runs[0][2])} "
        f"gradient leaves bit for bit {same}")
    if not same:
        raise AssertionError("6a: bf16 remat on differs from remat off")
    out["bf16_remat_bit_for_bit"] = same
    del runs, batch0
    step = ns.tts.make_train_step(
        cfg, ns.AdamWConfig(lr=1e-3, warmup_steps=6,
                            total_steps=TRAIN_STEPS), remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, t_steady = [], None
    zero(ns.wrappers)
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        if i == 5:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        state, m = step(state, data.batch(i))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = counted(ns.wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tok_s = 8 * 512 * (TRAIN_STEPS - 5) / (t_end - t_steady)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  6a bf16 B8xS512, {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (mean of the first 5 {first:.4f}, last 5 "
        f"{last:.4f}); {tok_s:,.0f} tokens/s over steps 5-{TRAIN_STEPS - 1} "
        f"({(t_end - t0) / TRAIN_STEPS:.3f} s a step with the first), peak "
        f"{peak:.2f} GiB allocated; launches {launches} on {smi()}")
    if not last < first - 0.3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"6a: the loss did not fall: {losses}")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    if not (per_step["flash_attention"] == per_step["flash_attention_bwd"]
            == cfg.num_layers and launches["rmsnorm"] > 0):
        raise AssertionError(f"6a: expected {cfg.num_layers} flash and "
                             f"flash_attention_bwd launches a step: "
                             f"{launches}")
    out["bf16_steps"] = {"losses": losses, "tokens_per_s": tok_s,
                         "peak_gib": peak, "launches": launches,
                         "s_per_step": (t_end - t0) / TRAIN_STEPS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        ns.save_checkpoint(path, state, step=TRAIN_STEPS)
        size = os.path.getsize(path) / 2**30
        back = ns.restore_checkpoint(path, state)
        step_back = ns.checkpoint_step(path)
    same = step_back == TRAIN_STEPS and all(
        a.dtype == b.dtype and bool(torch.equal(a, b))
        for a, b in zip(ns.tree_leaves(back), ns.tree_leaves(state)))
    log(f"  6a checkpoint of the bf16 state ({size:.2f} GiB .npz): restored "
        f"bit for bit {same} in {time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("6a: the checkpoint round trip differs")
    out["checkpoint"] = {"bit_for_bit": same, "gib": size}
    del back
    state, prof = profile_train_step(torch, ns, step, state,
                                     data.batch(TRAIN_STEPS))
    if prof["device_busy_ms"] > 0:
        parts = ", ".join(f"{k} {v:.2f} ms ({prof['kernels'][k]})"
                          for k, v in prof["device_ms"].items())
        log(f"  6a profile of one steady bf16 step (torch.profiler): device "
            f"{prof['device_busy_ms']:.2f} ms of {prof['step_wall_ms']:.2f} "
            f"ms wall (busy {prof['busy_share']:.1%}); by kind (kernels): "
            f"{parts} on {smi()}")
    else:
        log("  6a profile: torch.profiler recorded no device time (not "
            "measured)")
    out["bf16_step_profile"] = prof
    del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = ns.train_launcher.main(["--arch", "qwen2-0.5b", "--steps", "3",
                                  "--batch", "2", "--seq", "256",
                                  "--log-every", "1"])
    log(f"  6a launch/train.py --arch qwen2-0.5b --steps 3 --batch 2 --seq "
        f"256: loss {res['first_loss']:.4f} -> {res['last_loss']:.4f} in "
        f"{time.perf_counter() - t0:.1f} s")
    if not math.isfinite(res["last_loss"]):
        raise AssertionError("6a: the launcher's loss is not finite")
    out["launcher"] = res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_training_moe(torch, ns, get_config) -> dict:
    """6b: ``deepseek-moe-16b`` at published widths cut to 3 layers (the
    dense layer 0 and 2 MoE layers, as phase 3 cuts it), float32, B 2 x S
    512 with a repeated phrase in row 0, remat on (the reference loss's
    default; its 2 MoE layers are the repeat groups, recomputed in the
    backward): kernels against plain, the aux loss > 0 and capacity drops
    > 0."""
    cfg = dataclasses.replace(get_config(MOE), dtype="float32", num_layers=3)
    params = ns.Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    batch = train_batch(torch, ns.tts, cfg.vocab_size, 2, 512, seed=2,
                        phrase=True)
    with counting_drops(torch, ns.layers, []) as drops:
        kp = grads_vs_plain(torch, ns, cfg, params, batch,
                            f"6b {MOE} 3 layers float32 B2xS512, remat on",
                            remat=True)
    kp.pop("result")
    dropped = sum(drops[:2])       # the kernels' run (the plain run follows)
    log(f"  6b capacity factor {cfg.moe.capacity_factor} dropped {dropped} "
        f"(token, expert) pairs over the 2 MoE layers; aux loss "
        f"{kp['aux_loss']:.6f}")
    if not (kp["aux_loss"] > 0 and dropped > 0 and
            kp["launches"]["flash_attention_bwd"]):
        raise AssertionError(f"6b: aux {kp['aux_loss']}, drops {dropped}, "
                             f"launches {kp['launches']}")
    kp["dropped"] = dropped
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return kp


def ssd_grad_sensitivity(torch, ns, cfg, params, batch) -> float:
    """The plain path's own float32 sensitivity: its worst gradient leaf
    (max|Δ| / max) against the same plain path with the SSD's decay matrix
    in float64 (``segsum_in_float64``), the cancellation phase 3's decode
    check reads."""
    with plain_attention(ns.ops, names=("flash_attention", "rmsnorm")):
        _, _, g32 = ns.tts.loss_and_grads(params, batch, cfg=cfg)
        with segsum_in_float64(ns.ops):
            _, _, g64 = ns.tts.loss_and_grads(params, batch, cfg=cfg)
    return max(max_err(torch, a, b) / max(b.float().abs().max().item(), 1e-30)
               for a, b in zip(g32, g64))


def check_training_mamba(torch, ns, get_config) -> dict:
    """6c: ``mamba2-780m`` in float32, B 2 x S 512, remat on (the reference
    loss's default): kernels against plain (only rmsnorm differs; the SSD
    runs its differentiable path), cut to 2 layers within
    :data:`TRAIN_GRAD_REL`, and at full depth (48 layers) within twice the
    plain path's own sensitivity to the SSD's float32 decay matrix
    (:func:`ssd_grad_sensitivity`; at least :data:`TRAIN_GRAD_REL`): 48
    layers of random weights carry a last-bit difference of the norm into
    every leaf."""
    out = {}
    for depth in (2, None):
        cfg = dataclasses.replace(get_config(MAMBA), dtype="float32",
                                  **({"num_layers": depth} if depth else {}))
        layers_n = depth or cfg.num_layers
        params = ns.Model(cfg).init(
            torch.Generator(device="cuda").manual_seed(0))
        batch = train_batch(torch, ns.tts, cfg.vocab_size, 2, 512, seed=3)
        tol, control = TRAIN_GRAD_REL, None
        if depth is None:
            control = ssd_grad_sensitivity(torch, ns, cfg, params, batch)
            tol = max(TRAIN_GRAD_REL, 2 * control)
            log(f"  6c the plain path's gradients with the SSD's decay "
                f"matrix in float64 against float32: worst leaf "
                f"{control:.2e}; the kernels' limit {tol:.2e}")
        kp = grads_vs_plain(torch, ns, cfg, params, batch,
                            f"6c {MAMBA} {layers_n} layers float32 B2xS512",
                            tol=tol, remat=True)
        kp.pop("result")
        kp["tol"], kp["plain_f64_segsum_rel"] = tol, control
        if not kp["launches"]["rmsnorm"] or kp["launches"]["flash_attention"]:
            raise AssertionError(f"6c: launches {kp['launches']}")
        out[f"{layers_n}_layers"] = kp
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = out["48_layers"]["launches"]
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


def device_ms(torch, fn, n_sets: int) -> float:
    """Device ms a call, over two passes through all ``n_sets`` input
    copies, with the host's launch work hidden: the calls are queued behind a kernel that sleeps longer than the host takes to queue
    them, so the events around them time the device alone (the sleep grows
    until that holds)."""
    for i in range(3):
        fn(i % n_sets)
    torch.cuda.synchronize()
    n, cycles_asleep = 2 * n_sets, 2_000_000
    while True:
        asleep, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        asleep.record()
        torch.cuda._sleep(cycles_asleep)
        start.record()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i % n_sets)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < asleep.elapsed_time(start):
            return start.elapsed_time(end) / n
        if cycles_asleep > 2**33:       # several seconds asleep: the host
            # waits on the card (a full launch queue), so the sleep can
            # never hide the host's work
            raise RuntimeError(f"device_ms: {n} calls never queued within "
                               f"{asleep.elapsed_time(start):.0f} ms of "
                               "sleep; fewer input sets are needed")
        cycles_asleep *= 4


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(byts: float, flops: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over ``peak`` (the bf16 tensor-core rate
    unless the work runs outside the tensor cores)."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_kernels(torch, dec, fla, pag, qm):
    """Each kernel, its plain version and SDPA on the same rotating input
    sets; ``bound_ms`` is the mean over those sets of what each one's data
    needs: decode reads only the live K/V rows, flash only the keys below
    each row's ``kv_valid`` length, and both do 4·D FLOPs per head for each
    live (query, key) pair.  Q, the output and the masks count whole."""
    import torch.nn.functional as F
    out = {"decode_attention": time_decode(torch, dec, F),
           "flash_attention": time_flash(torch, fla, F),
           "paged_attention": time_paged(torch, pag, F)}
    for name, extra in time_cross(torch, dec, fla, F).items():
        out[name].update(extra)
    # the MoE model's attention (H 16, Hkv 16, D 128) as moe_* columns
    h, hkv = FAMILY_HEADS["deepseek"]
    moe = {"decode_attention": time_decode(torch, dec, F, h=h, hkv=hkv,
                                           d=128),
           "flash_attention": time_flash(torch, fla, F,
                                         form="deepseek_engine"),
           "paged_attention": time_paged(torch, pag, F, extras=False, h=h,
                                         hkv=hkv, d=128)}
    for name, t in moe.items():
        out[name].update({f"moe_{k}": v for k, v in t.items()})
    out["quant_matmul"] = time_qmm(torch, qm)
    return out


def time_rmsnorm(torch, rms, F):
    """The rmsnorm kernel at the decode step's rows (8 x 896, bf16, what
    each of a step's 49 launches normalises) and at a 512-row prefill
    chunk, its plain version, and ``F.rms_norm`` as the library call, on
    rotating input sets; the bound reads x and w once and writes y once
    (bytes; the 4 flops an element count against the float32 rate).  At
    most 64 input sets: :func:`device_ms` queues two passes behind a
    sleeping kernel, and more launches than the card's queue holds would
    block the host until the sleep ends (8 decode rows are 30 KB, and a
    step's norm reads a residual the step just wrote, hot in L2 anyway)."""
    out = {}
    for rows in (8, 512):
        d = 896
        one = (rows * d * 2) * 2 + d * 2
        n_sets = min(64, max(2, 2 * L2_BYTES // one + 1))
        g = torch.Generator(device="cuda").manual_seed(rows)
        sets = [((torch.randn((rows, d), generator=g, device="cuda") * 2
                  ).to(torch.bfloat16),
                 (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
                  ).to(torch.bfloat16)) for _ in range(n_sets)]
        kern = lambda i: rms.rmsnorm_cuda(*sets[i], 1e-6)  # noqa: E731
        lib = lambda i: F.rms_norm(sets[i][0], (d,), sets[i][1],  # noqa: E731
                                   1e-6)
        x, w = sets[0]
        row = {"ms": time_ms(torch, kern, n_sets),
               "device_ms": device_ms(torch, kern, n_sets),
               "plain_ms": time_ms(torch, lambda i: rms.rmsnorm_plain(
                   *sets[i], 1e-6), n_sets),
               "library_ms": time_ms(torch, lib, n_sets),
               "library_device_ms": device_ms(torch, lib, n_sets),
               "library": "torch.nn.functional.rms_norm",
               **bound(nbytes(x, w, x), 4 * rows * d, PEAK_F32_FLOPS),
               "shape": f"{rows}x{d} bf16, {n_sets} sets"}
        out[rows] = row
        log(f"  rmsnorm {row['shape']}: kernel {row['ms']:.4f} ms (device "
            f"alone {row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
            f"F.rms_norm {row['library_ms']:.4f} ms (device alone "
            f"{row['library_device_ms']:.4f}), bound {row['bound_ms']:.5f} "
            f"ms ({row['bound_by']})")
        del sets
    main = dict(out[8])
    main["prefill_512"] = out[512]
    return main


def time_categorical(torch, cat, sampling) -> dict:
    """The draw kernel at the sampled decode step's [8, 151936] float32
    logits, on rotating logit sets larger than L2, a call and device
    alone; its plain version; ``torch.argmax`` over the same logits, a draw's
    floor (no PyTorch call draws JAX's stream, so no library time).  The
    bound: :data:`CATEGORICAL_INT_OPS` integer operations an element over
    :data:`PEAK_INT32_OPS`, :data:`CATEGORICAL_F32_OPS` float operations
    over the float32 rate, the logits, keys, positions and draws once over
    the memory rate; the largest of the three."""
    b, v = 8, CAT_WIDTHS[0]
    n_sets = min(64, max(2, 2 * L2_BYTES // (b * v * 4) + 1))
    sets = [categorical_case(torch, sampling, b, v, seed=100 + i)
            for i in range(n_sets)]
    kern = lambda i: cat.categorical_cuda(  # noqa: E731
        sets[i][2], sets[i][0], sets[i][1])
    amax = lambda i: torch.argmax(sets[i][2], dim=-1)  # noqa: E731
    keys, pos, logits = sets[0]
    t_int = CATEGORICAL_INT_OPS * b * v / PEAK_INT32_OPS
    t_f32 = CATEGORICAL_F32_OPS * b * v / PEAK_F32_FLOPS
    t_bytes = (nbytes(logits, keys, pos) + 8 * b) / HBM_BYTES_PER_S
    row = {"ms": time_ms(torch, kern, n_sets),
           "device_ms": device_ms(torch, kern, n_sets),
           "plain_ms": time_ms(torch, lambda i: cat.categorical_plain(
               sets[i][2], sets[i][0], sets[i][1]), n_sets, cycles=1),
           "library_ms": None,
           "argmax_ms": time_ms(torch, amax, n_sets),
           "argmax_device_ms": device_ms(torch, amax, n_sets),
           "bound_ms": max(t_int, t_f32, t_bytes) * 1e3,
           "bound_by": "bytes" if t_bytes >= max(t_int, t_f32)
           else "operations",
           "bound_parts_ms": {"int32": t_int * 1e3, "float32": t_f32 * 1e3,
                              "bytes": t_bytes * 1e3},
           "chunk": cat.plan_chunk(b, v, torch.cuda.get_device_properties(
               0).multi_processor_count),
           "shape": f"[{b}, {v}] float32, {n_sets} sets"}
    log(f"  categorical {row['shape']}: kernel {row['ms']:.4f} ms (device "
        f"alone {row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
        f"torch.argmax alone {row['argmax_ms']:.4f} ms (device alone "
        f"{row['argmax_device_ms']:.4f}), bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}: {row['bound_parts_ms']}), chunk {row['chunk']}")
    del sets
    return row


def time_sampler(torch, sampling, ops) -> dict:
    """One ``masked_sample_inner`` step on [8, 151936] float32 logits:
    greedy (the all-greedy skip), stochastic with temperature 0.8 alone
    (the mask skip), and with top-p 0.9 (the sort pipeline) — the last two
    draw through the categorical kernel, and again with ``ops.categorical``
    routed to the plain version (the ``*_plain_ms`` columns).  Host clock
    around 20 steps ending in a synchronize (the step's host dispatch
    included)."""
    import numpy as np
    b, v = 8, 151936
    g = torch.Generator(device="cuda").manual_seed(17)
    logits = torch.randn((b, v), generator=g, device="cuda") * 3
    keys = torch.from_numpy(np.stack([sampling.request_base_key(i)
                                      for i in range(b)]).astype(np.int64)
                            ).cuda()
    pos = torch.arange(b, device="cuda") + 100
    ones, zeros = torch.ones(b, device="cuda"), torch.zeros(b, device="cuda")
    kz = torch.zeros(b, dtype=torch.int64, device="cuda")

    def run(temps, top_p, stochastic, mask):
        def step():
            return sampling.masked_sample_inner(
                logits, keys, pos, temps, top_p, kz, zeros,
                any_stochastic=stochastic, any_mask=mask)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 20

    out = {"greedy_ms": run(zeros, ones, False, False),
           "stochastic_ms": run(ones * 0.8, ones, True, False),
           "stochastic_top_p_ms": run(ones * 0.8, ones * 0.9, True, True),
           "shape": f"[{b}, {v}] float32"}
    with plain_attention(ops, ("categorical",)):
        out["stochastic_plain_ms"] = run(ones * 0.8, ones, True, False)
        out["stochastic_top_p_plain_ms"] = run(ones * 0.8, ones * 0.9, True,
                                               True)
    out["noise_and_draw_ms"] = out["stochastic_ms"] - out["greedy_ms"]
    log(f"  masked_sample_inner {out['shape']}: greedy "
        f"{out['greedy_ms']:.4f} ms, stochastic {out['stochastic_ms']:.4f} "
        f"ms (plain draw {out['stochastic_plain_ms']:.4f}), stochastic + "
        f"top-p {out['stochastic_top_p_ms']:.4f} ms (plain draw "
        f"{out['stochastic_top_p_plain_ms']:.4f}) a step")
    return out


def time_decode(torch, dec, F, **shape):
    """Decode at a serving shape, the text one unless ``shape`` gives
    :func:`decode_case` others (see :func:`time_kernels`)."""
    dtype = torch.bfloat16
    # decode: q [8,14,64], K/V [8,2048,2,64], ragged lengths
    (q, k, v, _), _ = decode_case(torch, dtype, **shape)
    n_sets = max(2, 2 * L2_BYTES // nbytes(k, v) + 1)
    sets = [decode_case(torch, dtype, seed=i, **shape)[0]
            for i in range(n_sets)]
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
    kern = lambda i: dec.decode_attention_cuda(*sets[i])  # noqa: E731
    lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
        enable_gqa=True)
    return {
        "ms": time_ms(torch, kern, n_sets),
        "plain_ms": time_ms(torch, lambda i: dec.decode_attention_plain(
            *sets[i]), n_sets, cycles=1),
        "library_ms": time_ms(torch, lib, n_sets),
        "device_ms": device_ms(torch, kern, n_sets),
        "library_device_ms": device_ms(torch, lib, n_sets),
        **bound(byts / n_sets, flops / n_sets),
        "shape": f"B{b} S{k.shape[1]} H{h} Hkv{hkv} D{d} bf16, {n_sets} sets",
    }


def time_flash(torch, fla, F, form="engine"):
    """Flash at a resume-prefill shape, the text one unless ``form`` names
    another engine form of :func:`flash_case` (see :func:`time_kernels`)."""
    dtype = torch.bfloat16
    # flash, engine form: 8 rows x 512-token bucket over a 2048 cache
    (q, k, v), _ = flash_case(torch, dtype, form)
    n_sets = max(2, 2 * L2_BYTES // nbytes(q, k, v) + 1)
    sets = [flash_case(torch, dtype, form, seed=i) for i in range(n_sets)]
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
    kern = lambda i: fla.flash_attention_cuda(  # noqa: E731
        *sets[i][0], **sets[i][1])
    lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
        enable_gqa=True)
    return {
        "ms": time_ms(torch, kern, n_sets),
        "plain_ms": time_ms(torch, lambda i: fla.flash_attention_plain(
            *sets[i][0], **sets[i][1]), n_sets, cycles=1),
        "library_ms": time_ms(torch, lib, n_sets),
        "device_ms": device_ms(torch, kern, n_sets),
        "library_device_ms": device_ms(torch, lib, n_sets),
        **bound(byts / n_sets, flops / n_sets),
        "shape": (f"B{b} Sq{sq} Skv{skv} H{h} Hkv{hkv} D{d} bf16 (engine "
                  f"form), {n_sets} sets"),
    }


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
        run = lambda i: kern(*sets[i][0], **sets[i][1])  # noqa: E731
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
            enable_gqa=True)
        out[name] = {
            "cross_ms": time_ms(torch, run, n_sets),
            "cross_plain_ms": time_ms(torch, lambda i: plain(
                *sets[i][0], **sets[i][1]), n_sets, cycles=1),
            "cross_library_ms": time_ms(torch, lib, n_sets),
            "cross_device_ms": device_ms(torch, run, n_sets),
            "cross_library_device_ms": device_ms(torch, lib, n_sets),
            "cross_bound_ms": b["bound_ms"], "cross_bound_by": b["bound_by"],
            "cross_shape": (f"q {tuple(first[0].shape)} over "
                            f"{tuple(first[1].shape)} bf16, "
                            f"{'non-causal, ' if name == 'flash_attention' else ''}"
                            f"{n_sets} sets"),
        }
        del sets, sdpa
        torch.cuda.empty_cache()
    return out


def split_sweep(torch, dec) -> dict:
    """Decode at both serving shapes against its number of splits: 1, two
    and four blocks per SM (the wrapper's plan is the latter) and the most
    the 64-key floor allows, through the wrapper's own launch with each
    count, over rotating sets larger than L2: ms a call and device ms
    (:func:`device_ms`; both kernels).  Not counted as launches."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, case in (
            ("text", lambda i: decode_case(torch, torch.bfloat16, seed=i)),
            ("cross", lambda i: cross_decode_case(torch, torch.bfloat16,
                                                  seed=i))):
        first = case(0)[0]
        n_sets = max(2, 2 * L2_BYTES // nbytes(*first[1:3]) + 1)
        sets = [case(i)[0] for i in range(n_sets)]
        b, s, hkv = first[1].shape[:3]
        most = max(1, s // dec.MIN_SPLIT_KEYS)
        counts = sorted({1, most, *(min(most, -(-w * sms // (b * hkv)))
                                    for w in (2, 4))})
        res = out[label] = {"plan": dec.plan_splits(s, b * hkv, sms)}
        for n in counts:
            run = lambda i, n=n: dec._launch(*sets[i], n)  # noqa: E731
            res[n] = {"ms": time_ms(torch, run, n_sets),
                      "device_ms": device_ms(torch, run, n_sets)}
            log(f"  decode_attention {label} splits {n:3d}: "
                f"{res[n]['ms']:.4f} ms a call, device "
                f"{res[n]['device_ms']:.4f} ms"
                f"{' (the plan)' if n == res['plan'] else ''}")
        del sets
        torch.cuda.empty_cache()
    return out


def paged_split_sweep(torch, pag, sets) -> dict:
    """The paged kernel at the serving arena (bf16 pages) against its
    number of splits: 1, two and four blocks per SM (the wrapper's plan is
    the latter) and the most the 64-cell floor allows, through the
    wrapper's own launch with each count: ms a call and device ms.  Not
    counted as launches."""
    from repro_torch.kernels.decode_attention import MIN_SPLIT_KEYS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q, k, _, table, _ = sets[0][0]
    s, bh = table.shape[1] * k.shape[1], q.shape[0] * k.shape[2]
    most = max(1, s // MIN_SPLIT_KEYS)
    res = {"plan": pag.plan_splits(s, bh, sms)}
    for n in sorted({1, most, *(min(most, -(-w * sms // bh))
                                for w in (2, 4))}):
        run = lambda i, n=n: pag._launch(  # noqa: E731
            *sets[i][0], None, None, n)
        res[n] = {"ms": time_ms(torch, run, len(sets)),
                  "device_ms": device_ms(torch, run, len(sets))}
        log(f"  paged_attention text splits {n:3d}: {res[n]['ms']:.4f} ms a "
            f"call, device {res[n]['device_ms']:.4f} ms"
            f"{' (the plan)' if n == res['plan'] else ''}")
    return res


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
            kern = lambda i: qm.quant_matmul_cuda(*sets[i])  # noqa: E731
            row = {
                "ms": time_ms(torch, kern, n_sets),
                "device_ms": device_ms(torch, kern, n_sets),
                "plain_ms": time_ms(torch, lambda i: qm.quant_matmul_plain(
                    *sets[i]), n_sets, cycles=1),
                "library_ms": time_ms(torch, library, n_sets),
                "library_device_ms": device_ms(torch, library, n_sets),
                "library": lib_name,
                **bound(nbytes(x, w_q, sc) + m * n * x.element_size(),
                        2 * m * k * n),
            }
            shapes[f"{m}x{k}x{n}"] = row
            log(f"  quant_matmul {m}x{k}x{n} bf16: kernel {row['ms']:.4f} "
                f"ms (device alone {row['device_ms']:.4f}), plain "
                f"{row['plain_ms']:.4f} ms, {lib_name} "
                f"{row['library_ms']:.4f} ms (device alone "
                f"{row['library_device_ms']:.4f}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            del sets, lib_sets
            torch.cuda.empty_cache()
    main = dict(shapes[f"8x{MLP_SHAPES[0][0]}x{MLP_SHAPES[0][1]}"])
    main["shape"] = (f"x [8, {MLP_SHAPES[0][0]}] bf16 @ int8 "
                     f"[{MLP_SHAPES[0][0]}, {MLP_SHAPES[0][1]}], 2 sets")
    main["shapes"] = shapes
    return main


def time_paged(torch, pag, F, extras=True, **shape):
    """The paged kernel at the serving arena (bf16 pages; with ``extras``,
    int8 pages and the split sweep as extra columns), the text shape unless
    ``shape`` gives :func:`paged_case` others.  ``bound_ms`` counts each
    row's live cells only (K and V rows, plus their 4-byte scales for
    int8), the live page-table entries, positions, q and the output.  No PyTorch call takes a page table, so
    ``library_ms`` is null; SDPA over a dense copy gathered beforehand (the
    gather untimed) is recorded beside it, labelled as such."""
    def live_cells(table, pos, ps):
        total = table.shape[1] * ps
        return [total if int(x) >= total else int(x) + 1 for x in pos]

    def sets_of(int8):
        args, kw = paged_case(torch, torch.bfloat16, int8=int8, **shape)
        per = nbytes(args[1], args[2], *kw.values())
        n_sets = max(2, 2 * L2_BYTES // per + 1)
        return [paged_case(torch, torch.bfloat16, int8=int8, seed=i, **shape)
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
    kern = lambda i: pag.paged_attention_cuda(  # noqa: E731
        *sets[i][0], **sets[i][1])
    lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        sdpa[i][0], sdpa[i][1], sdpa[i][2], attn_mask=sdpa[i][3],
        enable_gqa=True)
    out = {
        "ms": time_ms(torch, kern, n_sets),
        "device_ms": device_ms(torch, kern, n_sets),
        "plain_ms": time_ms(torch, lambda i: pag.paged_attention_plain(
            *sets[i][0], **sets[i][1]), n_sets, cycles=1),
        "library_ms": None,
        "sdpa_on_gathered_dense_copy_ms": time_ms(torch, lib, n_sets),
        "sdpa_on_gathered_dense_copy_device_ms": device_ms(torch, lib,
                                                            n_sets),
        **bound_of(sets),
    }
    del sdpa
    if extras:
        int8_sets = sets_of(True)
        int8_kern = lambda i: pag.paged_attention_cuda(  # noqa: E731
            *int8_sets[i][0], **int8_sets[i][1])
        out["int8_pages_ms"] = time_ms(torch, int8_kern, len(int8_sets))
        out["int8_pages_device_ms"] = device_ms(torch, int8_kern,
                                                len(int8_sets))
        out["int8_pages_bound_ms"] = bound_of(int8_sets)["bound_ms"]
        del int8_sets
        out["split_sweep"] = paged_split_sweep(torch, pag, sets)
    q, k = sets[0][0][0], sets[0][0][1]
    out["shape"] = (f"B{q.shape[0]} ps{k.shape[1]} P{sets[0][0][3].shape[1]} "
                    f"N{k.shape[0]} H{q.shape[1]} Hkv{k.shape[2]} "
                    f"D{k.shape[3]} bf16 pages, {n_sets} sets")
    return out


def log_kernel_times(name, t, card) -> None:
    """Phase 5's lines for one kernel with a library yardstick: a call and
    device alone, the MoE and cross-attention shapes where timed."""
    lib = ("none (SDPA on a gathered dense copy "
           f"{t['sdpa_on_gathered_dense_copy_ms']:.4f} ms)"
           if t["library_ms"] is None else f"{t['library_ms']:.4f} ms")
    ratio = ("" if t["library_ms"] is None
             else f" (kernel/library {t['ms'] / t['library_ms']:.3f})")
    log(f"  {name:17s} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, {t.get('library', 'SDPA')} {lib}"
        f"{ratio}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) on "
        f"{card}")
    lib_dev = t.get("library_device_ms",
                    t.get("sdpa_on_gathered_dense_copy_device_ms"))
    log(f"  {name:17s} device alone: kernel {t['device_ms']:.4f} ms, "
        f"{t.get('library', 'SDPA')} {lib_dev:.4f} ms (kernel/library "
        f"{t['device_ms'] / lib_dev:.3f})")
    if "moe_ms" in t:
        lib = (t["moe_library_ms"]
               or t["moe_sdpa_on_gathered_dense_copy_ms"])
        lib_dev = t.get("moe_library_device_ms",
                        t.get("moe_sdpa_on_gathered_dense_copy_device_ms"))
        log(f"  {name:17s} {MOE} {t['moe_shape']}: kernel "
            f"{t['moe_ms']:.4f} ms, plain {t['moe_plain_ms']:.4f} ms, "
            f"SDPA{'' if t['moe_library_ms'] else ' on a gathered copy'} "
            f"{lib:.4f} ms (kernel/SDPA {t['moe_ms'] / lib:.3f}), bound "
            f"{t['moe_bound_ms']:.4f} ms ({t['moe_bound_by']}); device "
            f"alone: kernel {t['moe_device_ms']:.4f} ms, SDPA "
            f"{lib_dev:.4f} ms (kernel/SDPA "
            f"{t['moe_device_ms'] / lib_dev:.3f})")
    if "cross_ms" in t:
        log(f"  {name:17s} cross {t['cross_shape']}: kernel "
            f"{t['cross_ms']:.4f} ms, plain {t['cross_plain_ms']:.4f} "
            f"ms, SDPA {t['cross_library_ms']:.4f} ms (kernel/SDPA "
            f"{t['cross_ms'] / t['cross_library_ms']:.3f}), bound "
            f"{t['cross_bound_ms']:.4f} ms ({t['cross_bound_by']}); "
            f"device alone: kernel {t['cross_device_ms']:.4f} ms, SDPA "
            f"{t['cross_library_device_ms']:.4f} ms (kernel/SDPA "
            f"{t['cross_device_ms'] / t['cross_library_device_ms']:.3f})")


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
    from repro_torch.kernels import categorical as cat
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import paged_attention as pag
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.core import sampling
    from repro_torch.core.kv_cache import slice_cache_row
    from repro_torch.core.paged_kv import PagedKVPool
    from repro_torch.core.request import Request, SamplingParams
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import layers
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.model import (Model, init_cache, tree_leaves,
                                          tree_map)
    from repro_torch.training import train_step as tts
    from repro_torch.training.checkpoint import (checkpoint_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.data import BigramDataPipeline
    from repro_torch.training.optimizer import (AdamWConfig,
                                                tree_flatten_with_path)
    from repro_torch.training.optimizer import tree_leaves as sorted_leaves
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
    mma = check_tensor_cores(build)

    log("== 2. kernels against their plain versions")
    errs = check_kernels(torch, dec, fla, pag, qm)
    errs["rmsnorm"] = check_rmsnorm(torch, rms)
    threefry = check_threefry(torch, sampling)
    cat_check = check_categorical(torch, cat, sampling)
    errs["categorical"] = cat_check["max_abs_err"]
    bwd_check = check_flash_bwd(torch, fla)
    errs["flash_attention_bwd"] = bwd_check["max_abs_err"]
    bwd_check["rmsnorm_fn_rel"] = check_rmsnorm_fn(torch, ops, rms)

    wrappers = {"decode_attention": dec.decode_attention_cuda,
                "flash_attention": fla.flash_attention_cuda,
                "flash_attention_bwd": fla.flash_attention_bwd_cuda,
                "paged_attention": pag.paged_attention_cuda,
                "quant_matmul": qm.quant_matmul_cuda,
                "rmsnorm": rms.rmsnorm_cuda,
                "categorical": cat.categorical_cuda}
    log("== 3. full-width models, float32, kernels vs plain versions")
    ns3 = types.SimpleNamespace(ops=ops, layers=layers, Model=Model,
                                init_cache=init_cache, PagedKVPool=PagedKVPool,
                                slice_cache_row=slice_cache_row)

    def f32(name, **kw):
        return dataclasses.replace(get_config(name), dtype="float32", **kw)

    check_model(torch, ns3, f32("qwen2-0.5b"), reprefill=True)
    verify3 = check_model_verify(torch, ns3, f32("qwen2-0.5b"))
    j4 = {"c_echo_f32": check_echo_f32(torch, ns3, f32("qwen2-0.5b"),
                                       wrappers, InferenceEngine, Request,
                                       SamplingParams)}
    verify3["vision"] = check_vision_model(torch, ops, get_config, Model,
                                           init_cache)
    moe3 = f32(MOE, num_layers=3)
    drops = check_model(torch, ns3, moe3, phrase_row=True)["dropped"]
    log(f"  {MOE} prefill: capacity factor {moe3.moe.capacity_factor} "
        f"dropped {drops} (token, expert) pairs over its 2 MoE layers")
    if not drops:
        raise AssertionError("the MoE prefill dropped no pair: the capacity "
                             "path did not run")
    for name in DENSE_FAMILY:
        check_model(torch, ns3, f32(name, num_layers=2))
    check_model(torch, ns3, f32("glm4-9b", num_layers=2), lengths=(600, 517),
                cache_len=256, chunk=256, window=256)
    ssm3 = {}
    for depth, tol in ((2, MAMBA_STEP_TOL_2), (None, MAMBA_STEP_TOL)):
        log(f"  -- {MAMBA}, {f'cut to {depth} layers' if depth else 'full depth'}"
            ": 256-token resume chunks and a ragged tail, decode steps "
            "against prefills, a padded row against itself alone, dense "
            "against paged, re-prefill against decode step 8")
        ssm3[f"{depth or 48}_layers"] = check_model(
            torch, ns3, f32(MAMBA, **({"num_layers": depth} if depth else {})),
            chunk=256, reprefill=True, recurrent=True, step_tol=tol)
    check_audio_model(torch, ops, get_config, Model, init_cache)

    serving = (torch, get_config, InferenceEngine, EngineClient, OpenAIServer,
               ApiServer, wrappers)
    log("== 4a. serving qwen2-0.5b (bf16) over HTTP, dense KV")
    dense_launches, dense, _, layers = check_serving(
        *serving, bodies=serve_requests())
    require_launches(dense_launches, dense, layers,
                     decode_kernel="decode_attention",
                     unused="paged_attention")
    require_rmsnorm(dense_launches, dense, layers)
    log("== 4b. serving over HTTP, paged KV (fp pages, 16-token pages)")
    paged_launches, paged, stats, _ = check_serving(
        *serving, bodies=serve_requests() + shared_prompt_chats(),
        kv_layout="paged", kv_page_size=16)
    require_launches(paged_launches, paged, layers,
                     decode_kernel="paged_attention",
                     unused="decode_attention")
    require_rmsnorm(paged_launches, paged, layers)
    if paged["profiled_round"]["decode_attention_share"] != 0:
        raise AssertionError("the paged round's profile credits device time "
                             "to decode_attention, which it never launches")
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
        ApiServer=ApiServer, media=media, init_cache=init_cache,
        Request=Request, SamplingParams=SamplingParams)
    log(f"== 4d. serving {VISION} (10 layers, bf16) over HTTP with images, "
        "dense KV, content cache")
    media_launches, media_dense, cold_tokens = check_media_serving(
        torch, ns, wrappers, layout="dense", profile=True)
    log(f"== 4e. serving {VISION} over HTTP with images, paged KV (fp)")
    media_paged_launches, media_paged, _ = check_media_serving(
        torch, ns, wrappers, layout="paged", want_tokens=cold_tokens)
    log("== 4f. ops.quant_matmul (the int8 kernel's entry point)")
    qmm_launches = check_quant_entry(torch, ops, qm, get_config)
    log(f"== 4g. serving {MOE} (28 layers, bf16) over HTTP, dense KV, then "
        "paged KV (fp pages)")
    t0 = time.perf_counter()
    moe_params = Model(get_config(MOE)).init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    moe_init_s = time.perf_counter() - t0
    log(f"  {MOE}: {sum(t.numel() for t in tree_leaves(moe_params)) / 1e9:.2f}"
        f" B parameters drawn in {moe_init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    moe_dense_launches, moe_dense, _, moe_layers = check_serving(
        *serving, bodies=serve_requests(), arch=MOE, params=moe_params,
        profile_ops=profile_moe_ops)
    require_launches(moe_dense_launches, moe_dense, moe_layers,
                     decode_kernel="decode_attention",
                     unused="paged_attention")
    moe_paged_launches, moe_paged, moe_stats, _ = check_serving(
        *serving, bodies=serve_requests() + shared_prompt_chats(), arch=MOE,
        params=moe_params, profile=False, kv_layout="paged", kv_page_size=16)
    require_launches(moe_paged_launches, moe_paged, moe_layers,
                     decode_kernel="paged_attention",
                     unused="decode_attention")
    check_paged_serving(moe_stats)
    moe_paged["kv_pages"], moe_paged["prefix_cache"] = (
        moe_stats["kv_pages"], moe_stats["prefix_cache"])
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()
    qwen_params = Model(get_config("qwen2-0.5b")).init(
        torch.Generator(device="cuda").manual_seed(0))
    log("== 4h-a. policy preemption on qwen2-0.5b (bf16, 24 layers), "
        "max_batch 1, EDF: snapshot and resume vs FIFO")
    policy_preempt = check_policy_preemption(torch, ns, wrappers,
                                             qwen_params)
    log("== 4h-b. the page-pressure ladder: the text mix on an arena below "
        "full capacity")
    pressure = check_pressure_serving(torch, serving, qwen_params)
    log("== 4i-a/b. speculative decoding (n-gram, spec_k 4) on qwen2-0.5b: "
        "the text mix + 6 repetition-heavy requests vs spec off, dense "
        "ring, then 16-token pages with the prefix cache on")
    spec = check_spec_serving(torch, serving, qwen_params)
    log("== 4i-c. draft-model speculation, the target's own weights as the "
        "draft")
    spec["c_draft"] = check_draft_engine(torch, get_config, InferenceEngine,
                                         Request, SamplingParams, wrappers,
                                         qwen_params)
    log("== 4j-a. speculative wave filling: 24 staggered prompts (300-1500 "
        "tokens) on 8 slots, fill on vs off, dense ring and fp pages")
    j4["a_spec_fill"] = check_spec_fill(torch, ns, wrappers, qwen_params)
    log("== 4j-b. shared-prefix n groups: n = 4 behind a ~600-token system "
        "prompt, dense ring and fp pages")
    j4["b_groups"] = check_groups(torch, ns, wrappers, qwen_params)
    log("== 4j-d. chaos at the prefill, decode, codec and pool sites, then "
        "a decode block that raises")
    j4["d_chaos"] = check_chaos(torch, ns, wrappers, qwen_params)
    log("== 4j-f. handoff between two engines: dense, fp pages, int8 pages")
    j4["f_handoff"] = check_handoff(torch, ns, wrappers, qwen_params)
    log("== 4l. sampled requests: 4a's 12 prompts at temperature 0.8 (top-p "
        "0.95 on half), seeded, through the categorical kernel and through "
        "its plain version")
    sampled = check_sampled_round(torch, ns, wrappers, qwen_params)
    del qwen_params
    gc.collect()
    torch.cuda.empty_cache()
    m4 = {}
    jcfg = jamba_config(get_config)
    t0 = time.perf_counter()
    jamba_params = Model(jcfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    m4["jamba_init_s"] = time.perf_counter() - t0
    log(f"== 3j. {JAMBA} at published widths, {JAMBA_LAYERS} layers, bf16 "
        f"(phase 3's check, run here to draw the weights once for 4m-c): "
        f"{sum(t.numel() for t in tree_leaves(jamba_params)) / 1e9:.2f} B "
        f"parameters drawn in {m4['jamba_init_s']:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    m4["jamba_phase3"] = check_jamba_model(torch, ns3, jcfg, jamba_params)
    log(f"== 4m-c. serving {JAMBA} ({JAMBA_LAYERS} layers, bf16) over HTTP, "
        "dense KV, then paged KV (fp pages)")
    m4["c_jamba"] = check_ssm_serving(torch, serving, JAMBA, jcfg,
                                      jamba_params, what="4m-c",
                                      require_equal=False)
    del jamba_params
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = get_config(MAMBA)
    mamba_params = Model(mcfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    log(f"== 4m-a. serving {MAMBA} (48 layers, bf16) over HTTP, dense KV, "
        "then paged KV (fp pages)")
    m4["a_mamba"] = check_ssm_serving(torch, serving, MAMBA, mcfg,
                                      mamba_params, what="4m-a",
                                      require_equal=True,
                                      profile_fn=profile_ssm_ops)
    log(f"== 4m-b. policy preemption on {MAMBA} (bf16), max_batch 1, EDF, "
        "prefix cache off: the snapshot restores conv/state")
    m4["b_preemption"] = check_ssm_preemption(torch, ns, wrappers, mcfg,
                                              mamba_params)
    del mamba_params
    gc.collect()
    torch.cuda.empty_cache()
    acfg = get_config(AUDIO)
    audio_params = Model(acfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    log(f"== 4n. serving {AUDIO} (12 + 12 layers, bf16) on the engine: one "
        "waveform shared by 8 requests, a warm repeat, dense KV then paged "
        "KV (fp pages)")
    n4 = check_audio_serving(torch, ns, wrappers, acfg, audio_params)
    del audio_params
    gc.collect()
    torch.cuda.empty_cache()
    log("== 4h-c. admission control over HTTP (launcher-built servers)")
    admission = check_admission_serving(torch, serve_mod)
    log("== 4i-d. a launcher-built server with --spec-mode ngram")
    spec["d_launcher"] = check_spec_launcher(torch, serve_mod)
    log("== 4j-e. the watchdog, echo over HTTP, drain and the drain cutoff "
        "(launcher-built servers)")
    j4["e_watchdog_drain"] = check_watchdog_drain(torch, serve_mod)
    log("== 4k-a. two replicas of qwen2-0.5b behind launch/serve.py "
        "--replicas 2 --router-policy affinity --transport asgi: sessions, "
        "shared prompts, fp pages; one replica and --router-policy random "
        "beside it")
    k4, k4_srv = check_router_serving(torch, serve_mod, wrappers)
    log("== 4k-c. the ASGI transport: SSE streams, a mid-stream disconnect, "
        "batch, lifespan, the post-drain 503")
    k4["c_asgi"] = check_asgi_4k(torch, k4_srv)
    del k4_srv
    gc.collect()
    torch.cuda.empty_cache()
    log("== 4k-b/d. Router.drain_replica(0) with 8 live and 4 queued "
        "requests, dense ring and fp pages; a seeded request on each replica "
        "and after the drain")
    k4["b_drain"] = check_router_drain(torch, ns, serve_mod, wrappers)
    ns6 = types.SimpleNamespace(
        ops=ops, layers=ns3.layers, Model=Model, tts=tts, wrappers=wrappers,
        AdamWConfig=AdamWConfig, BigramDataPipeline=BigramDataPipeline,
        save_checkpoint=save_checkpoint,
        restore_checkpoint=restore_checkpoint,
        checkpoint_step=checkpoint_step, train_launcher=train_launcher,
        tree_flatten_with_path=tree_flatten_with_path,
        tree_leaves=sorted_leaves, tree_map=tree_map)
    log("== 6a. training qwen2-0.5b at full depth: float32 kernels vs plain "
        "gradients, remat, microbatches; 30 bf16 steps, a checkpoint, the "
        "launcher")
    six = {"a_qwen": check_training_qwen(torch, ns6, get_config)}
    log(f"== 6b. training {MOE} at published widths, 3 layers, float32: "
        "kernels vs plain, the aux loss and capacity drops")
    six["b_moe"] = check_training_moe(torch, ns6, get_config)
    log(f"== 6c. training {MAMBA} at full depth, float32: kernels vs plain "
        "(the differentiable SSD)")
    six["c_mamba"] = check_training_mamba(torch, ns6, get_config)
    spec["phase3_verify"] = verify3
    # each kernel's launches in the counted round of its own path
    launches = {"decode_attention": dense_launches["decode_attention"],
                "flash_attention": paged_launches["flash_attention"],
                "paged_attention": paged_launches["paged_attention"],
                "quant_matmul": qmm_launches,
                "rmsnorm": dense_launches["rmsnorm"],
                "categorical": sampled["kernel"]["launches"]["categorical"],
                "flash_attention_bwd":
                    six["a_qwen"]["bf16_steps"]["launches"][
                        "flash_attention_bwd"]}

    log("== 5. times at the serving shapes (CUDA events)")
    times = time_kernels(torch, dec, fla, pag, qm)
    times["decode_attention"]["split_sweep"] = split_sweep(torch, dec)
    import torch.nn.functional as F
    times["rmsnorm"] = time_rmsnorm(torch, rms, F)
    times["categorical"] = time_categorical(torch, cat, sampling)
    sampler_step = time_sampler(torch, sampling, ops)
    times["flash_attention_bwd"] = time_flash_bwd(torch, fla, F)
    kernels = []
    for name in KERNEL_NAMES:
        t = times[name]
        if name == "flash_attention_bwd":
            log(f"  {name:17s} {t['shape']}: kernel {t['ms']:.4f} ms "
                f"(device alone {t['device_ms']:.4f}), plain "
                f"{t['plain_ms']:.4f} ms, SDPA backward {t['library_ms']:.4f}"
                f" ms (device alone {t['library_device_ms']:.4f}; kernel/"
                f"library {t['ms'] / t['library_ms']:.3f}), bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}) on {card}")
        elif name == "categorical":
            log(f"  {name:17s} {t['shape']}: kernel {t['ms']:.4f} ms (device "
                f"alone {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
                f"no library call (torch.argmax alone {t['argmax_ms']:.4f} "
                f"ms), bound {t['bound_ms']:.4f} ms ({t['bound_by']}) on "
                f"{card}")
        else:
            log_kernel_times(name, t, card)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            **({"replaces_note": REPLACES_NOTE[name]}
               if name in REPLACES_NOTE else {}),
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "tensor_core_instructions": mma.get(name),
            **{k: v for k, v in t.items()
               if k.startswith(("sdpa_on", "int8_pages", "cross_", "moe_",
                                "shapes", "prefill_", "argmax", "chunk",
                                "bound_parts", "library", "split_sweep",
                                "device_ms"))},
            **({"spec_round_launches": {
                    "ngram_dense": spec["a_dense"]["ngram"]["launches"][name],
                    "ngram_paged": spec["b_paged"]["ngram"]["launches"][name],
                    "draft": spec["c_draft"]["draft"]["launches"][name]},
                "media_round_launches": {"dense": media_launches[name],
                                         "paged": media_paged_launches[name]},
                "moe_round_launches": {"dense": moe_dense_launches[name],
                                       "paged": moe_paged_launches[name]},
                "pressure_round_launches":
                    pressure["pressure"]["launches"][name]}
               if name not in ("quant_matmul", "categorical",
                               "flash_attention_bwd") else {}),
            **({"train_launches": {
                    "a_f32_step": six["a_qwen"]["f32_kernels_vs_plain"][
                        "launches"].get(name, 0),
                    "a_bf16_30_steps": six["a_qwen"]["bf16_steps"][
                        "launches"].get(name, 0),
                    "b_moe_step": six["b_moe"]["launches"].get(name, 0),
                    "c_mamba_step": six["c_mamba"]["launches"].get(name, 0)}}
               if name in ("flash_attention", "flash_attention_bwd",
                           "rmsnorm") else {}),
            **({"max_rel_err": bwd_check["max_rel_err"],
                "lse_max_abs_err": bwd_check["lse_max_abs_err"],
                "rmsnorm_fn_rel": bwd_check["rmsnorm_fn_rel"]}
               if name == "flash_attention_bwd" else {}),
            "ssm_round_launches": {
                f"{m}_{layout}": m4[k][layout]["launches"][name]
                for m, k in (("mamba", "a_mamba"), ("jamba", "c_jamba"))
                for layout in ("dense", "paged")},
            "audio_round_launches": {layout: n4[layout]["launches"][name]
                                     for layout in ("dense", "paged")}})
    serve = {"dense": dense, "paged": paged, "paged_int8": int8_round,
             "media_dense": media_dense, "media_paged": media_paged,
             "moe_dense": moe_dense, "moe_paged": moe_paged,
             "moe_init_s": moe_init_s,
             "policy_preemption": policy_preempt, "pressure": pressure,
             "admission": admission, "j4": j4, "k4": k4, "m4": m4,
             "mamba_phase3": ssm3,
             "n4": n4, "train": six,
             "threefry_card_vs_cpu": threefry, "sampler_step": sampler_step,
             "categorical_check": cat_check, "sampled": sampled,
             "card": card, "smoke_s": time.perf_counter() - t_start}
    print(json.dumps({"serve": serve}))
    print(json.dumps({"spec": spec, "card": card}))
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
