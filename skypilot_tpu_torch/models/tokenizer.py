"""Tokenizers of the port (mirrors `skypilot_tpu/models/tokenizer.py`).

This slice carries the interface, the dependency-free byte-level
tokenizer (UTF-8 bytes are the ids, NUL is EOS) and the UTF-8-safe
stream decoder.  HF tokenizer.json and SentencePiece readers come with
checkpoint loading in a later slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


class Tokenizer:
    """Interface: ids are plain ints; decode ignores ids it cannot map."""

    eos_id: Optional[int] = None
    bos_id: Optional[int] = None
    extra_stop_ids: frozenset = frozenset()

    @property
    def eos_ids(self) -> frozenset:
        """Every id generation should stop at: the model-level EOS plus
        chat turn-end markers."""
        base = frozenset() if self.eos_id is None else {self.eos_id}
        return frozenset(base) | self.extra_stop_ids

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError

    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError


class ByteTokenizer(Tokenizer):
    """UTF-8 bytes as ids; NUL (0) is EOS.  The hermetic fallback."""

    eos_id = 0

    @property
    def vocab_size(self) -> int:
        return 256

    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        del add_bos
        return list(text.encode('utf-8'))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(t for t in ids if 0 < t < 256).decode(
            'utf-8', errors='replace')


class StreamDecoder:
    """Incremental UTF-8-safe decoding for text streaming: push(token)
    returns the NEW text that token produced ('' while a multi-byte
    sequence is incomplete).  Only the ids since the last emitted
    boundary are re-decoded, with a one-token prefix window."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._tok = tokenizer
        self._ids: List[int] = []
        self._prefix = 0
        self._read = 0

    def push(self, token: int) -> str:
        self._ids.append(token)
        emitted = self._tok.decode(self._ids[self._prefix:self._read])
        text = self._tok.decode(self._ids[self._prefix:])
        if text.endswith('�'):
            return ''
        delta = (text[len(emitted):] if text.startswith(emitted)
                 else text)
        self._read = len(self._ids)
        self._prefix = max(0, self._read - 1)
        return delta

    def finish(self) -> str:
        """Remaining text (invalid bytes surface as replacement chars)."""
        emitted = self._tok.decode(self._ids[self._prefix:self._read])
        text = self._tok.decode(self._ids[self._prefix:])
        delta = (text[len(emitted):] if text.startswith(emitted)
                 else text)
        self._read = len(self._ids)
        self._prefix = max(0, self._read - 1)
        return delta


def load_tokenizer(path: Optional[str]) -> Tokenizer:
    """The byte tokenizer for path=None; checkpoint tokenizers come with
    a later slice of the port."""
    if path is None:
        return ByteTokenizer()
    raise NotImplementedError(
        'tokenizer files (HF tokenizer.json, SentencePiece .model) come '
        'with checkpoint loading in a later slice of the port')
