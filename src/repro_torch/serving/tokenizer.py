"""Byte-level tokenizer (vocab = 256 bytes + specials).

Self-contained so the serving stack has a real end-to-end text path without
external tokenizer assets; byte-level tokens also exercise the paper's
UTF-8-safe streaming requirement (multi-byte code points split across
tokens) for real."""
from __future__ import annotations

from typing import List


class ByteTokenizer:
    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259

    def encode(self, text: str, *, add_bos: bool = True) -> List[int]:
        toks = list(text.encode("utf-8"))
        return ([self.BOS] + toks) if add_bos else toks

    def decode(self, tokens: List[int]) -> str:
        return bytes(t for t in tokens if t < 256).decode("utf-8",
                                                          errors="replace")

    def token_bytes(self, token: int) -> bytes:
        return bytes([token]) if token < 256 else b""
