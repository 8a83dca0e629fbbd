"""Media input pipeline: format decoding + the stubbed modality frontends (a
copy of the reference package's ``serving/media.py``: host numpy, so
embeddings and content hashes are bit-identical to the reference's; the
synthetic URL store is this package's own).

Format independence (paper Alg.3): an image may arrive as a raw array, a
base64 string, a synthetic ``url``, or a file path — all are decoded to pixel
values *before* hashing, so the content cache hits regardless of transport.

The vision/audio encoders are stubs per the assignment carve-out (we are not
training a ViT), but they are *real compute*: a deterministic patchify +
fixed-projection pipeline whose cost scales with resolution / frame count,
so the cache-speedup benchmarks (paper Tables 2-6) measure genuine work
elimination.  ``work_iters`` tunes the encoder weight to mimic the paper's
1.5-4 s encoder share."""
from __future__ import annotations

import base64
import io
from typing import Any, Dict

import numpy as np

# synthetic URL store: tests/benchmarks register arrays under fake URLs
_URL_STORE: Dict[str, np.ndarray] = {}


def register_url(url: str, pixels: np.ndarray) -> None:
    _URL_STORE[url] = pixels


def decode_media(payload: Any) -> np.ndarray:
    """Decode any supported transport format to a pixel array (H, W, 3)."""
    if isinstance(payload, np.ndarray):
        return payload
    if isinstance(payload, dict):
        if "array" in payload:
            return np.asarray(payload["array"])
        if "base64" in payload:
            raw = base64.b64decode(payload["base64"])
            return np.load(io.BytesIO(raw), allow_pickle=False)
        if "url" in payload:
            url = payload["url"]
            if url not in _URL_STORE:
                raise KeyError(f"unknown media url {url!r}")
            return _URL_STORE[url]
        if "path" in payload:
            return np.load(payload["path"], allow_pickle=False)
    raise TypeError(f"unsupported media payload: {type(payload)}")


def encode_b64(pixels: np.ndarray) -> Dict[str, str]:
    buf = io.BytesIO()
    np.save(buf, pixels)
    return {"base64": base64.b64encode(buf.getvalue()).decode()}


class VisionEncoderStub:
    """Deterministic pixels -> patch embeddings [T, De].

    Patchify to a fixed token grid, project with a fixed-seed random matrix,
    then burn ``work_iters`` extra projection rounds (the knob that stands in
    for the real ViT's 1.5-4 s cost — all real FLOPs, so caching it away is a
    measured saving, not a simulated one)."""

    def __init__(self, num_tokens: int, embed_dim: int, *,
                 work_iters: int = 8, seed: int = 0):
        self.num_tokens = num_tokens
        self.embed_dim = embed_dim
        self.work_iters = work_iters
        # invocation counter: the allocator-counter-style proof that
        # in-flight dedup collapsed N identical media to ONE encode
        self.calls = 0
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((256, embed_dim)).astype(np.float32) / 16.0
        self._mix = rng.standard_normal((embed_dim, embed_dim)).astype(np.float32) \
            / np.sqrt(embed_dim)

    def __call__(self, pixels: np.ndarray) -> np.ndarray:
        self.calls += 1
        arr = np.asarray(pixels, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        flat = arr.reshape(-1)
        # bucket pixels into num_tokens patches of 256 features
        want = self.num_tokens * 256
        reps = -(-want // max(flat.size, 1))
        flat = np.tile(flat, reps)[:want].reshape(self.num_tokens, 256)
        emb = flat @ self._proj
        # work burn scales with input resolution (more pixels = more mixing
        # rounds), mirroring resolution-dependent encoder cost (Table 5)
        iters = max(1, int(self.work_iters * arr.size / (64 * 64 * 3)))
        for _ in range(iters):
            emb = np.tanh(emb @ self._mix)
        return emb.astype(np.float32)


class AudioEncoderStub:
    """Deterministic waveform -> frame embeddings [F, De] (conv-codec stand-in)."""

    def __init__(self, num_frames: int, embed_dim: int, *,
                 work_iters: int = 4, seed: int = 1):
        self.num_frames = num_frames
        self.embed_dim = embed_dim
        self.work_iters = work_iters
        self.calls = 0
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((64, embed_dim)).astype(np.float32) / 8.0
        self._mix = rng.standard_normal((embed_dim, embed_dim)).astype(np.float32) \
            / np.sqrt(embed_dim)

    def __call__(self, waveform: np.ndarray) -> np.ndarray:
        self.calls += 1
        arr = np.asarray(waveform, np.float32).reshape(-1)
        want = self.num_frames * 64
        reps = -(-want // max(arr.size, 1))
        arr = np.tile(arr, reps)[:want].reshape(self.num_frames, 64)
        emb = arr @ self._proj
        for _ in range(self.work_iters):
            emb = np.tanh(emb @ self._mix)
        return emb.astype(np.float32)
