"""Content-based multimodal prefix caching: the same image in three
transport formats hits one cache entry; repeated queries skip the vision
encoder; video frames share entries — the reference's
``examples/multimodal_cache.py`` on the port.

  PYTHONPATH=src python -m repro_torch.examples.multimodal_cache \\
      [--device cpu] [--vision-work-iters 4000]

Runs on the card unless ``--device cpu`` asks for the plain versions.
``main`` returns each turn's hits and misses; :func:`check` raises unless
they keep the example's contract (the tests and ``chip_smoke.py`` call
it).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import Request, SamplingParams
from repro_torch.device import resolve_device
from repro_torch.serving.media import encode_b64, register_url
from repro_torch.serving.tokenizer import ByteTokenizer


def main(argv=None, params=None) -> dict:
    """Run the example; ``params`` (a params tree on the device) replaces
    the engine's own seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--vision-work-iters", type=int, default=4000,
                    help="the stub vision encoder's work per image")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tok = ByteTokenizer()
    cfg = get_config("qwen3-vl-toy")
    engine = InferenceEngine(cfg, params, max_batch=2, cache_len=256,
                             device=device,
                             vision_work_iters=args.vision_work_iters)

    img = np.random.default_rng(0).integers(0, 255, (96, 96, 3),
                                            dtype=np.uint8)
    register_url("demo://cat.png", img)
    formats = [("raw array", img),
               ("base64", encode_b64(img)),
               ("url", {"url": "demo://cat.png"})]

    def ask(payload, text="what is in this image, described fully?"):
        r = Request(prompt_tokens=tok.encode(text), images=[payload],
                    sampling=SamplingParams(max_tokens=6))
        t0 = time.monotonic()
        engine.generate([r])
        return r, time.monotonic() - t0

    print(f"multi-turn conversation about one image (three formats) on "
          f"{device}:")
    turns = []
    for i, (name, payload) in enumerate(formats):
        r, dt = ask(payload)
        kind = "MISS (encoded)" if r.vision_cache_misses else "HIT  (cached) "
        turns.append({"format": name, "hits": r.vision_cache_hits,
                      "misses": r.vision_cache_misses, "s": dt,
                      "entries": len(engine.content_cache),
                      "tokens": list(r.output_tokens)})
        print(f"  turn {i+1} [{name:10s}] {kind} latency={dt*1e3:7.1f}ms "
              f"output={r.output_tokens}")
    cache = engine.content_cache
    print(f"\ncache: {len(cache)} entries, {cache.nbytes/1e6:.2f} MB, "
          f"hit-rate {cache.stats.hit_rate:.0%}")

    # --- video: per-frame entries are shared across clips ----------------- #
    frames = [np.random.default_rng(i).integers(0, 255, (48, 48, 3),
                                                dtype=np.uint8)
              for i in range(4)]
    r1 = Request(prompt_tokens=tok.encode("summarize the following video"),
                 video_frames=frames, sampling=SamplingParams(max_tokens=4))
    t0 = time.monotonic()
    engine.generate([r1])
    cold = time.monotonic() - t0
    n1 = len(engine.content_cache)
    # a second clip reusing 3 of the 4 frames
    clip2 = frames[1:] + [np.random.default_rng(9).integers(
        0, 255, (48, 48, 3), dtype=np.uint8)]
    r2 = Request(prompt_tokens=tok.encode("summarize the following video"),
                 video_frames=clip2, sampling=SamplingParams(max_tokens=4))
    t0 = time.monotonic()
    engine.generate([r2])
    warm = time.monotonic() - t0
    print(f"\nvideo clip 1 (cold): {cold*1e3:.0f}ms "
          f"({r1.vision_cache_misses} frames encoded)")
    print(f"video clip 2 (3/4 frames shared): {warm*1e3:.0f}ms "
          f"({r2.vision_cache_hits} hits, {r2.vision_cache_misses} encoded)")
    return {"device": str(device), "turns": turns,
            "clip1": {"hits": r1.vision_cache_hits,
                      "misses": r1.vision_cache_misses, "s": cold,
                      "entries": n1, "tokens": list(r1.output_tokens)},
            "clip2": {"hits": r2.vision_cache_hits,
                      "misses": r2.vision_cache_misses, "s": warm,
                      "entries": len(engine.content_cache),
                      "tokens": list(r2.output_tokens)}}


def check(res: dict) -> None:
    """The first format misses and the other two hit its entries (none
    added); the first clip encodes its 4 frames, the second hits the 3 it
    shares and encodes 1."""
    t = res["turns"]
    if not (t[0]["misses"] and not t[0]["hits"]
            and all(x["hits"] and not x["misses"] for x in t[1:])
            and t[0]["entries"] == t[1]["entries"] == t[2]["entries"]):
        raise AssertionError(f"multimodal_cache: image turns {t}")
    if (res["clip1"]["misses"], res["clip2"]["hits"],
            res["clip2"]["misses"]) != (4, 3, 1):
        raise AssertionError(f"multimodal_cache: video {res}")


if __name__ == "__main__":
    check(main())
