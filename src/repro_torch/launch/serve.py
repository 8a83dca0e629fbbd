"""Serving launcher of the port: the OpenAI-compatible server over the
continuous-batching engine, on the CUDA card unless ``--device`` says
otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --port 8177 --max-batch 8 --cache-len 2048 [--kv-layout paged]

Weights are random, drawn from ``--seed`` (nothing is downloaded), so the
text is gibberish: check the contract (finish_reason, usage, chunk framing).
"""
from __future__ import annotations

import argparse
import threading

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.client import EngineClient
from repro_torch.serving.server import ApiServer


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
                         "chunk queue")
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
                         "full max-batch capacity + reserved pages (smaller "
                         "arenas need preemption, not ported yet)")
    ap.add_argument("--kv-dtype", choices=("fp", "int8"), default="fp",
                    help="KV page storage: model dtype, or int8 with "
                         "per-(position, head) scales (paged layout only)")
    return ap.parse_args(argv)


def build_server(args: argparse.Namespace) -> ApiServer:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    engine = InferenceEngine(
        cfg, device=args.device, max_batch=args.max_batch,
        cache_len=args.cache_len, seed=args.seed,
        max_decode_block=args.max_decode_block, top_p=args.top_p,
        top_k=args.top_k, min_p=args.min_p, prefill_chunk=args.prefill_chunk,
        max_prefill_buckets=args.max_prefill_buckets,
        sched_policy=args.sched_policy,
        enable_prefix_cache=not args.no_prefix_cache,
        kv_layout=args.kv_layout, kv_page_size=args.kv_page_size,
        kv_num_pages=args.kv_num_pages, kv_dtype=args.kv_dtype)
    return ApiServer(OpenAIServer(EngineClient(engine), cfg.name),
                     port=args.port)


def main(argv=None) -> None:
    args = parse_args(argv)
    server = build_server(args)
    server.start()
    eng = server.api.engine
    print(f"serving {eng.cfg.name} ({eng.cfg.param_count() / 1e6:.1f}M "
          f"params) on {eng.device} at http://127.0.0.1:{server.port} "
          "(chat + completions + models; stats: /stats)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        server.api.client.stop()


if __name__ == "__main__":
    main()
