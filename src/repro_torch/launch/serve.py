"""Serving launcher of the port: the OpenAI-compatible server over the
continuous-batching engine, on the CUDA card unless ``--device`` says
otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --port 8177 --max-batch 8 --cache-len 2048 [--kv-layout paged]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-90b ...   # image_url content parts
  ... --kv-layout paged --kv-num-pages 600 --sched-policy edf --preemption \\
      --tenant bulk=1:2 --max-queue-depth 64   # overload knobs
  ... --spec-mode ngram --spec-k 4    # speculative decoding (/stats
                                      # "speculation"); --spec-mode draft
                                      # --spec-draft-config NAME pairs a
                                      # draft model (reduced with --smoke)
  ... --fault-rate decode=0.05 --fault-seed 1   # chaos: injected faults
  ... --watchdog-timeout 60 --drain-timeout 30  # /readyz, POST /admin/drain
  ... --replicas 2 --router-policy affinity --transport asgi
                  # N engines behind the router on the bundled asyncio
                  # server; /stats is the v2 envelope (router, replicas[])

Admission control is on unless ``--no-admission``: per-tenant rate limits
(429), a bounded fair queue with queue-wait expiry, and load shedding (503),
each rejection with a ``Retry-After`` header.

Weights are random, drawn from ``--seed`` (nothing is downloaded), so the
text is gibberish: check the contract (finish_reason, usage, chunk framing).
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading

from repro_torch.configs import get_config
from repro_torch.core.admission import AdmissionController, TenantConfig
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.faults import FaultInjector, parse_fault_rates
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.asgi import AsgiServer
from repro_torch.serving.client import EngineClient
from repro_torch.serving.router import ROUTER_POLICIES, Router
from repro_torch.serving.server import ApiServer


def parse_tenant_spec(spec: str) -> tuple:
    """``name=weight[:rps[:tps]]`` -> (name, TenantConfig)."""
    if "=" not in spec:
        raise ValueError(f"tenant spec {spec!r} must look like "
                         "name=weight[:rps[:tps]]")
    name, _, rest = spec.partition("=")
    parts = rest.split(":")
    weight = float(parts[0]) if parts[0] else 1.0
    rps = float(parts[1]) if len(parts) > 1 and parts[1] else 0.0
    tps = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
    return name.strip(), TenantConfig(weight=weight, rps=rps, tps=tps)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the width-reduced variant of --arch")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=2048)
    ap.add_argument("--port", type=int, default=8177)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="in-process engine replicas behind the router "
                         "(1 = single engine, no router layer)")
    ap.add_argument("--router-policy", choices=ROUTER_POLICIES,
                    default="affinity",
                    help="replica placement: affinity (session pin -> "
                         "prefix-digest match -> least outstanding "
                         "tokens), least_loaded, round_robin, random")
    ap.add_argument("--transport", choices=("asgi", "threaded"),
                    default="asgi",
                    help="HTTP transport: the asyncio-native ASGI app on "
                         "the bundled asyncio server (no thread per SSE "
                         "connection), or the thread-per-connection "
                         "stdlib server")
    ap.add_argument("--max-decode-block", type=int, default=8,
                    help="decode tokens per host sync (1 = per-token loop)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="default nucleus mass for requests that omit top_p")
    ap.add_argument("--top-k", type=int, default=0,
                    help="default top-k for requests that omit top_k (0 = off)")
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="default min-p for requests that omit min_p (0 = off)")
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="prompt tokens prefilled per engine step (0 = "
                         "monolithic prefill)")
    ap.add_argument("--max-prefill-buckets", type=int, default=6,
                    help="cap on distinct prefill bucket shapes")
    ap.add_argument("--sched-policy", default="fifo",
                    choices=["fifo", "priority", "edf"],
                    help="request ordering for admission and the prefill "
                         "chunk queue: fifo (arrival), priority (request "
                         "'priority' field), edf (earliest 'deadline_ms' "
                         "first)")
    ap.add_argument("--preemption", action="store_true",
                    help="let an urgent pending request (per --sched-policy; "
                         "fifo never preempts) evict the least urgent live "
                         "slot; the evicted request resumes from its "
                         "snapshot, or re-prefills its history")
    ap.add_argument("--max-preemptions", type=int, default=2,
                    help="max times one request may be evicted by the "
                         "policy (bounds preemption churn)")
    ap.add_argument("--no-spec-fill", action="store_true",
                    help="disable speculative wave filling (prefill "
                         "padding rows carrying chunks of pending requests)")
    ap.add_argument("--watchdog-timeout", type=float, default=60.0,
                    help="seconds after which a wedged engine step flips "
                         "/readyz to 503 (0 = no watchdog)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="graceful-drain budget (SIGTERM, POST /admin/drain "
                         "without timeout_s): past it the live slots are "
                         "snapshotted and every open request aborted")
    ap.add_argument("--fault-rate", action="append", default=[],
                    metavar="SITE=RATE",
                    help="chaos: deterministic fault injection at a site "
                         "(prefill, decode, codec, slow_step, pool; "
                         "repeatable) — see core/faults.py")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault injector")
    ap.add_argument("--no-admission", action="store_true",
                    help="disable admission control (no rate limits, no "
                         "fair queue, no shedding: the engine's unbounded "
                         "pending queue)")
    ap.add_argument("--max-queue-depth", type=int, default=256,
                    help="hard bound on waiting requests; beyond it every "
                         "submit gets a 503 with Retry-After")
    ap.add_argument("--queue-timeout", type=float, default=30.0,
                    help="seconds a request may wait for admission before "
                         "it finishes with a typed 'timeout' (0 = never)")
    ap.add_argument("--shed-queue-depth", type=int, default=None,
                    help="queue depth where batch-class shedding starts "
                         "(default max-queue-depth/2)")
    ap.add_argument("--shed-wait", type=float, default=10.0,
                    help="estimated queue wait (s) that sheds batch-class "
                         "requests; twice it sheds everything (0 = depth "
                         "thresholds only)")
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME=WEIGHT[:RPS[:TPS]]",
                    help="per-tenant fair-share weight and rate limits "
                         "(repeatable); a request names its tenant in the "
                         "OpenAI 'user' field or an x-tenant header")
    ap.add_argument("--aging-s", type=float, default=None,
                    help="anti-starvation aging horizon for priority/edf "
                         "policies: a request's effective priority rises "
                         "one level per aging-s seconds waited "
                         "(default: policy-specific; 0 disables)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="dense",
                    help="KV cache layout: dense per-slot ring, or paged "
                         "global arena with copy-on-write prefix sharing")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="tokens per KV page (paged layout; default matches "
                         "the prefix-cache block size)")
    ap.add_argument("--kv-num-pages", type=int, default=None,
                    help="page-arena size (paged layout); default sizes for "
                         "full max-batch capacity + reserved pages; a "
                         "smaller arena runs the pressure ladder (evict "
                         "cache entries, preempt, fail the last holdout)")
    ap.add_argument("--kv-dtype", choices=("fp", "int8"), default="fp",
                    help="KV page storage: model dtype, or int8 with "
                         "per-(position, head) scales (paged layout only)")
    ap.add_argument("--no-content-cache", action="store_true")
    ap.add_argument("--no-vision-embed-cache", action="store_true",
                    help="content-cache ablation: keep cross-KV entries but "
                         "re-encode every frame (paper Table 4 'KV-only')")
    ap.add_argument("--no-vision-kv-cache", action="store_true",
                    help="content-cache ablation: keep frame embeddings but "
                         "re-project cross-KV (paper Table 4 "
                         "'embeddings-only')")
    ap.add_argument("--content-cache-mb", type=int, default=None,
                    help="byte budget for the content cache in MiB "
                         "(default: the prefix cache's 512 MiB figure)")
    ap.add_argument("--vision-work-iters", type=int, default=8,
                    help="vision/audio encoder work multiplier (stubbed encoder "
                         "cost; higher = heavier encode, larger cache wins)")
    ap.add_argument("--encode-wave", type=int, default=4,
                    help="unique media encodes per engine step (0 = "
                         "unbounded): batches concurrent encoder work "
                         "behind the decode block and streams large video "
                         "frame-sets across steps")
    ap.add_argument("--spec-mode", choices=("off", "ngram", "draft"),
                    default="off",
                    help="speculative decoding: off, self-speculative "
                         "n-gram drafting from the request's own history, "
                         "or a paired draft model (--spec-draft-config)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens verified per round (the "
                         "scheduler halves/zeroes it when acceptance "
                         "drops or pending work needs the batch)")
    ap.add_argument("--spec-draft-config", default=None,
                    help="registered model config name for the draft "
                         "model (--spec-mode draft); must share the "
                         "target's vocab and be text-only attention")
    return ap.parse_args(argv)


def build_server(args: argparse.Namespace):
    """The server ``args`` describe, not started: ``--replicas`` engines
    from one ``build_replica`` (the same seed, so weight-identical, which
    a drain's bit-identical handoff rests on; they share the one set of
    read-only weight tensors, each with its own arena), behind a
    :class:`Router` when there is more than one, served by the ASGI app
    (``--transport asgi``) or the threaded server."""
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    cfg = get_config(args.arch)
    rates = parse_fault_rates(args.fault_rate)
    faults = (FaultInjector(seed=args.fault_seed, rates=rates)
              if rates else None)
    spec_draft = args.spec_draft_config
    if args.smoke:
        cfg = cfg.reduced()
        if spec_draft is not None:
            # shrink the draft alongside the target, or its full-size vocab
            # can never match the reduced target's
            spec_draft = get_config(spec_draft).reduced()
    shared = {}

    def build_replica() -> EngineClient:
        """One engine, its admission controller and its client."""
        engine = InferenceEngine(
            cfg, shared.get("params"), device=args.device,
            max_batch=args.max_batch,
            cache_len=args.cache_len, seed=args.seed,
            max_decode_block=args.max_decode_block, top_p=args.top_p,
            top_k=args.top_k, min_p=args.min_p,
            prefill_chunk=args.prefill_chunk,
            max_prefill_buckets=args.max_prefill_buckets,
            sched_policy=args.sched_policy, preemption=args.preemption,
            max_preemptions=args.max_preemptions,
            speculative_fill=not args.no_spec_fill, aging_s=args.aging_s,
            faults=faults,
            enable_prefix_cache=not args.no_prefix_cache,
            kv_layout=args.kv_layout, kv_page_size=args.kv_page_size,
            kv_num_pages=args.kv_num_pages, kv_dtype=args.kv_dtype,
            enable_content_cache=not args.no_content_cache,
            cache_vision_embeddings=not args.no_vision_embed_cache,
            cache_vision_kv=not args.no_vision_kv_cache,
            content_cache_bytes=(None if args.content_cache_mb is None
                                 else args.content_cache_mb * 1024 * 1024),
            vision_work_iters=args.vision_work_iters,
            encode_wave=args.encode_wave,
            spec_mode=args.spec_mode, spec_k=args.spec_k,
            spec_draft_config=spec_draft)
        shared.setdefault("params", engine.params)
        admission = None
        if not args.no_admission:
            admission = AdmissionController(
                tenants=dict(parse_tenant_spec(s) for s in args.tenant),
                max_queue_depth=args.max_queue_depth,
                queue_timeout_s=args.queue_timeout,
                shed_queue_depth=args.shed_queue_depth,
                shed_wait_s=args.shed_wait)
        return EngineClient(
            engine, admission=admission,
            watchdog_timeout_s=(args.watchdog_timeout
                                if args.watchdog_timeout > 0 else None))

    if args.replicas > 1:
        client = Router([build_replica() for _ in range(args.replicas)],
                        policy=args.router_policy, seed=args.seed)
    else:
        client = build_replica()
    api = OpenAIServer(client, cfg.name, drain_timeout_s=args.drain_timeout)
    if args.transport == "asgi":
        return AsgiServer(api, port=args.port)
    return ApiServer(api, port=args.port)


def main(argv=None) -> None:
    args = parse_args(argv)
    server = build_server(args)
    server.start()
    eng = server.api.engine
    print(f"serving {eng.cfg.name} ({eng.cfg.param_count() / 1e6:.1f}M "
          f"params) on {eng.device} at http://127.0.0.1:{server.port} "
          f"[{args.transport}; {args.replicas} replica(s)"
          + (f", router policy {args.router_policy}" if args.replicas > 1
             else "") + "] "
          f"(chat + completions + models; stats: /stats; admission "
          f"{'off' if args.no_admission else 'on'}; drain: POST "
          f"/admin/drain or SIGTERM)", flush=True)
    if eng.faults is not None:
        print(f"chaos: fault injection {eng.faults.rates} (seed "
              f"{args.fault_seed})", flush=True)
    # SIGTERM: graceful drain (stop admitting, finish in-flight work within
    # --drain-timeout, snapshot + abort the rest), then exit 0
    drained = threading.Event()

    def _sigterm(_sig, _frm):
        print(f"SIGTERM: draining (timeout {args.drain_timeout:g}s)",
              flush=True)
        threading.Thread(target=lambda: (server.api.client.drain(
            timeout=args.drain_timeout), drained.set()), daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        while not drained.wait(timeout=1.0):
            pass
        print("drain complete; exiting", flush=True)
        server.stop()
        sys.exit(0)
    except KeyboardInterrupt:
        server.stop()
        server.api.client.stop()


if __name__ == "__main__":
    main()
