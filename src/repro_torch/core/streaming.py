"""UTF-8-safe incremental detokenisation (paper §3.2 Streaming).

Byte-level tokens can split multi-byte UTF-8 sequences across steps; the
paper emphasises emitting only complete code points.  ``StreamDecoder`` holds
back incomplete trailing sequences and emits them once completed."""
from __future__ import annotations

from typing import List


def _incomplete_suffix_len(buf: bytes) -> int:
    """Number of trailing bytes that form an incomplete UTF-8 sequence."""
    n = len(buf)
    for back in range(1, min(4, n) + 1):
        b = buf[n - back]
        if b < 0x80:                    # ascii — complete
            return 0 if back == 1 else 0
        if b >= 0xC0:                   # leader byte
            need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            return back if back < need else 0
        # continuation byte: keep looking backwards
    return 0


class StreamDecoder:
    """Incremental bytes → str decoder that never splits a code point."""

    def __init__(self) -> None:
        self._pending = b""

    def push(self, data: bytes) -> str:
        buf = self._pending + data
        keep = _incomplete_suffix_len(buf)
        emit, self._pending = (buf[:-keep], buf[-keep:]) if keep else (buf, b"")
        return emit.decode("utf-8", errors="replace")

    def flush(self) -> str:
        out = self._pending.decode("utf-8", errors="replace")
        self._pending = b""
        return out


class StopSequenceChecker:
    """Host-side stop-*sequence* enforcement at block emit.

    Streaming text must never show a stop sequence (or a prefix of one that
    later completes), so the checker buffers the longest tail that could
    still become a match and releases it only once it provably cannot.
    ``push`` returns ``(safe_text, stopped)``; on a match the text *before*
    the match is released and the match itself (plus anything after it) is
    discarded — OpenAI truncation semantics."""

    def __init__(self, stops: List[str]) -> None:
        assert stops and all(stops), "empty stop sequence"
        self._stops = list(stops)
        self._maxlen = max(len(s) for s in stops)
        self._buf = ""

    def push(self, text: str) -> "tuple[str, bool]":
        self._buf += text
        # the winning match is the one that *completes* first (min end
        # position, then min start) — start position alone would make the
        # outcome depend on chunk boundaries when matches overlap
        best = None
        for s in self._stops:
            idx = self._buf.find(s)
            if idx != -1 and (best is None or (idx + len(s), idx) < best):
                best = (idx + len(s), idx)
        if best is not None:
            emit, self._buf = self._buf[:best[1]], ""
            return emit, True
        # hold back the longest suffix that is a prefix of any stop sequence
        keep = 0
        for back in range(1, min(self._maxlen - 1, len(self._buf)) + 1):
            tail = self._buf[-back:]
            if any(s.startswith(tail) for s in self._stops):
                keep = back
        if keep:
            emit, self._buf = self._buf[:-keep], self._buf[-keep:]
        else:
            emit, self._buf = self._buf, ""
        return emit, False

    def flush(self) -> str:
        """Release held-back text (generation ended without a match)."""
        out, self._buf = self._buf, ""
        return out


class TokenStreamDecoder:
    """Per-request token → text streamer on top of a byte-level tokenizer."""

    def __init__(self, tokenizer) -> None:
        self._tok = tokenizer
        self._dec = StreamDecoder()

    def push_token(self, token: int) -> str:
        data = self._tok.token_bytes(token)
        return self._dec.push(data)

    def push_tokens(self, tokens: List[int]) -> str:
        return "".join(self.push_token(t) for t in tokens)

    def flush(self) -> str:
        return self._dec.flush()
