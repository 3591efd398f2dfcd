"""Tokenizers of the port (mirrors `skypilot_tpu/models/tokenizer.py`).

Three backends behind one interface (encode/decode/eos_id/vocab_size):

- HFTokenizer: HF `tokenizer.json` through the `tokenizers` library,
  imported inside its constructor only, when it is installed.
- SentencePieceTokenizer: a pure-Python reader of SentencePiece
  `.model` protobufs (no sentencepiece package): score-based Viterbi
  for unigram models, merge-rank BPE for BPE models, byte fallback;
  control and unknown pieces are never matched against input text.
- ByteTokenizer: UTF-8 bytes are the ids, NUL is EOS (the
  dependency-free fallback).

`load_tokenizer(dir)` picks the best available for a checkpoint
directory (models/import_weights.py copies the tokenizer files next to
the converted checkpoint): tokenizer.json, else tokenizer.model (also
when tokenizer.json is there but `tokenizers` is not installed, as on
a machine without it), else bytes.  StreamDecoder turns a token
stream into UTF-8-safe text deltas.
"""
from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


# Chat-template turn-end markers: an instruct checkpoint's effective
# stop token (Llama-3-Instruct emits '<|eot_id|>', ChatML models
# '<|im_end|>') — a BASE model never emits them, so including them in
# the stop set is always safe and lets instruct checkpoints shipped
# without tokenizer_config.json stop at turn ends instead of streaming
# to max_new_tokens.
CHAT_TURN_END_TOKENS = ('<|eot_id|>', '<|im_end|>')


class Tokenizer:
    """Interface: ids are plain ints; decode ignores ids it cannot map."""

    eos_id: Optional[int] = None
    bos_id: Optional[int] = None
    # Additional stop ids beyond eos_id (chat turn-end markers).
    extra_stop_ids: frozenset = frozenset()

    @property
    def eos_ids(self) -> frozenset:
        """Every id generation should stop at: the model-level EOS plus
        chat turn-end markers present in the vocab.  The serve layer
        checks membership here instead of `== eos_id`."""
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


class HFTokenizer(Tokenizer):
    """tokenizer.json via the `tokenizers` library (exact HF fidelity)."""

    def __init__(self, tokenizer_json: str,
                 tokenizer_config: Optional[str] = None) -> None:
        import tokenizers  # pylint: disable=import-outside-toplevel
        self._tok = tokenizers.Tokenizer.from_file(tokenizer_json)
        self.bos_token = None
        self.eos_token = None
        if tokenizer_config and os.path.exists(tokenizer_config):
            with open(tokenizer_config, encoding='utf-8') as f:
                cfg = json.load(f)
            self.bos_token = _token_str(cfg.get('bos_token'))
            self.eos_token = _token_str(cfg.get('eos_token'))
        self.bos_id = (self._tok.token_to_id(self.bos_token)
                       if self.bos_token else None)
        self.eos_id = (self._tok.token_to_id(self.eos_token)
                       if self.eos_token else None)
        # Chat turn-end markers present in the vocab join the stop set
        # (eos_ids) unconditionally: a base model never emits them, and
        # an instruct checkpoint's effective stop IS one of them — with
        # only the model-level EOS, Llama-3-Instruct-style checkpoints
        # stream past turn ends to max_new_tokens.
        chat_markers = {
            cand: tid for cand in CHAT_TURN_END_TOKENS
            if (tid := self._tok.token_to_id(cand)) is not None
        }
        if self.eos_id is None:
            # No tokenizer_config.json (or no eos in it): without an
            # EOS id generation never stops early, holding batching
            # slots to max_new_tokens.  Fall back to the conventional
            # EOS names in the vocab/added-tokens table — model-level
            # EOS names first ('<|end_of_text|>' etc.), chat turn-end
            # markers last.  This is a guess; the warning stays so
            # operators know to ship tokenizer_config.json.
            for cand in ('<|end_of_text|>', '<|endoftext|>', '</s>',
                         '<eos>', '<|end|>', *CHAT_TURN_END_TOKENS):
                tid = self._tok.token_to_id(cand)
                if tid is not None:
                    self.eos_token, self.eos_id = cand, tid
                    extra = ''
                    if chat_markers and cand not in chat_markers:
                        extra = (
                            '; chat turn-end markers '
                            f'{sorted(chat_markers)} also found in the '
                            'vocab and added to the stop set (an '
                            'instruct checkpoint stops there, not at '
                            f'{cand!r})')
                    logger.warning(
                        f'No eos_token in tokenizer_config; falling '
                        f'back to {cand!r} (id {tid}) from the '
                        f'vocab{extra}.')
                    break
        self.extra_stop_ids = frozenset(
            tid for tid in chat_markers.values() if tid != self.eos_id)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_id is not None:
            return [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def _token_str(token: Any) -> Optional[str]:
    """tokenizer_config.json stores tokens as str or AddedToken dicts."""
    if token is None:
        return None
    if isinstance(token, dict):
        return token.get('content')
    return str(token)


# --------------------------------------------------------------------------
# SentencePiece .model (pure-Python protobuf subset)
# --------------------------------------------------------------------------

_SP_NORMAL, _SP_UNKNOWN, _SP_CONTROL, _SP_USER_DEFINED, _SP_BYTE = \
    1, 2, 3, 4, 6
_SP_SPACE = '▁'  # '▁'


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_sp_model(data: bytes):
    """(pieces, model_type): pieces = [(text, score, type)], from the
    SentencePiece ModelProto (field 1 = repeated SentencePiece, field 2
    = TrainerSpec whose field 3 is model_type: 1 unigram, 2 bpe)."""
    pieces: List[Tuple[str, float, int]] = []
    model_type = 1
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # SentencePiece message
            size, pos = _read_varint(data, pos)
            end = pos + size
            text, score, ptype = '', 0.0, _SP_NORMAL
            while pos < end:
                t, pos = _read_varint(data, pos)
                f, w = t >> 3, t & 7
                if f == 1 and w == 2:
                    n, pos = _read_varint(data, pos)
                    text = data[pos:pos + n].decode('utf-8')
                    pos += n
                elif f == 2 and w == 5:
                    score = struct.unpack('<f', data[pos:pos + 4])[0]
                    pos += 4
                elif f == 3 and w == 0:
                    ptype, pos = _read_varint(data, pos)
                else:
                    pos = _skip_field(data, pos, w)
            pieces.append((text, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            size, pos = _read_varint(data, pos)
            end = pos + size
            while pos < end:
                t, pos = _read_varint(data, pos)
                f, w = t >> 3, t & 7
                if f == 3 and w == 0:
                    model_type, pos = _read_varint(data, pos)
                else:
                    pos = _skip_field(data, pos, w)
        else:
            pos = _skip_field(data, pos, wire)
    return pieces, model_type


def _skip_field(data: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(data, pos)
        return pos
    if wire == 1:
        return pos + 8
    if wire == 2:
        n, pos = _read_varint(data, pos)
        return pos + n
    if wire == 5:
        return pos + 4
    raise ValueError(f'Unsupported protobuf wire type {wire}')


class SentencePieceTokenizer(Tokenizer):
    """Pure-Python SentencePiece with both segmentation algorithms:
    Viterbi over piece scores for unigram models (model_type 1, the
    exact unigram objective) and merge-rank BPE for BPE models
    (model_type 2, e.g. Llama-2: repeatedly merge the adjacent pair
    whose merged piece scores highest — scores encode merge order in
    SP BPE models, so this reproduces the training merge sequence).
    Both use <0xNN> byte fallback for uncovered characters.  Held to
    the reference's ids and text in tests/test_torch_tokenizer.py."""

    def __init__(self, model_path: str) -> None:
        with open(model_path, 'rb') as f:
            pieces, self._model_type = _parse_sp_model(f.read())
        self._pieces = pieces
        # Encodable vocab: NORMAL + USER_DEFINED only.  Real
        # sentencepiece never matches CONTROL/UNKNOWN/BYTE pieces
        # against input text — otherwise a prompt literally containing
        # '</s>' would encode to eos_id (user-controlled EOS injection)
        # instead of being spelled out from characters/bytes.
        self._id_of: Dict[str, int] = {}
        all_ids: Dict[str, int] = {}
        self._byte_ids: Dict[int, int] = {}
        self.unk_id = 0
        for idx, (text, _, ptype) in enumerate(pieces):
            all_ids.setdefault(text, idx)
            if ptype in (_SP_NORMAL, _SP_USER_DEFINED):
                self._id_of.setdefault(text, idx)
            elif ptype == _SP_UNKNOWN:
                self.unk_id = idx
            elif ptype == _SP_BYTE:
                self._byte_ids[int(text[1:-1], 16)] = idx
        self.bos_id = all_ids.get('<s>')
        self.eos_id = all_ids.get('</s>')
        self._max_piece_len = max((len(t) for t, _, _ in pieces),
                                  default=1)

    @property
    def vocab_size(self) -> int:
        return len(self._pieces)

    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        # SP normalization subset: spaces -> ▁ with a dummy prefix.
        s = _SP_SPACE + text.replace(' ', _SP_SPACE)
        if self._model_type == 2:
            ids = self._encode_bpe(s)
        else:
            ids = self._encode_unigram(s)
        if add_bos and self.bos_id is not None:
            return [self.bos_id] + ids
        return ids

    def _encode_bpe(self, s: str) -> List[int]:
        """Merge-rank BPE: repeatedly merge the adjacent symbol pair
        whose merged piece has the highest score (ties: leftmost) —
        the same order real SP BPE applies its learned merges.  Heap
        over candidate pairs + linked symbol list (the sentencepiece
        bpe_model scheme): O(n log n), not O(n^2) rescans — encode is
        on the serving request path."""
        import heapq  # pylint: disable=import-outside-toplevel
        n = len(s)
        if n == 0:
            return []
        sym = list(s)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n
        heap: List[Tuple[float, int, str, str]] = []

        def consider(i: int) -> None:
            j = nxt[i]
            if j < 0:
                return
            pid = self._id_of.get(sym[i] + sym[j])
            if pid is not None:
                # Max-score pops first; ties pop leftmost (smaller i).
                heapq.heappush(
                    heap, (-self._pieces[pid][1], i, sym[i], sym[j]))

        for i in range(n - 1):
            consider(i)
        while heap:
            _, i, a, b = heapq.heappop(heap)
            # Lazy invalidation: stale entries name symbols that have
            # since merged away.
            if not alive[i] or sym[i] != a:
                continue
            j = nxt[i]
            if j < 0 or sym[j] != b:
                continue
            sym[i] = a + b
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] >= 0:
                prv[nxt[i]] = i
            consider(i)
            if prv[i] >= 0:
                consider(prv[i])
        ids: List[int] = []
        i = 0  # index 0 is always a merge survivor (never a right pair)
        while i >= 0:
            pid = self._id_of.get(sym[i])
            if pid is not None:
                ids.append(pid)
            else:  # unmerged char not in vocab: byte-fallback
                for b_ in sym[i].encode('utf-8'):
                    ids.append(self._byte_ids.get(b_, self.unk_id))
            i = nxt[i]
        return ids

    def _encode_unigram(self, s: str) -> List[int]:
        n = len(s)
        # Viterbi: best[i] = (score, backpointer, piece_id) for s[:i].
        neg_inf = float('-inf')
        best = [(neg_inf, -1, -1)] * (n + 1)
        best[0] = (0.0, -1, -1)
        for i in range(n):
            base = best[i][0]
            if base == neg_inf:
                continue
            upper = min(n, i + self._max_piece_len)
            for j in range(i + 1, upper + 1):
                piece = s[i:j]
                pid = self._id_of.get(piece)
                if pid is None:
                    continue
                score = base + self._pieces[pid][1]
                if score > best[j][0]:
                    best[j] = (score, i, pid)
            if best[i + 1][0] == neg_inf:
                # No piece covers s[i]: byte-fallback (or unk) for one
                # char, with a large penalty so real pieces win.
                best[i + 1] = (base - 100.0, i, -2)
        ids: List[int] = []
        segments: List[Tuple[int, int, int]] = []
        j = n
        while j > 0:
            _, i, pid = best[j]
            segments.append((i, j, pid))
            j = i
        for i, j, pid in reversed(segments):
            if pid >= 0:
                ids.append(pid)
            else:  # byte-fallback segment (single char)
                for b in s[i:j].encode('utf-8'):
                    ids.append(self._byte_ids.get(b, self.unk_id))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        pending_bytes: List[int] = []

        def flush() -> None:
            if pending_bytes:
                out.append(bytes(pending_bytes).decode(
                    'utf-8', errors='replace'))
                pending_bytes.clear()

        for i in ids:
            if not 0 <= i < len(self._pieces):
                continue
            text, _, ptype = self._pieces[i]
            if ptype == _SP_BYTE:
                pending_bytes.append(int(text[1:-1], 16))
                continue
            flush()
            if ptype in (_SP_CONTROL, _SP_UNKNOWN):
                continue
            out.append(text)
        flush()
        return ''.join(out).replace(_SP_SPACE, ' ').lstrip(' ')


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
    """Best tokenizer for a checkpoint dir (or explicit file path).

    Preference: tokenizer.json (exact, via `tokenizers`) >
    SentencePiece .model (pure-Python) > byte-level fallback.
    """
    if path is None:
        return ByteTokenizer()
    if os.path.isfile(path):
        if path.endswith('.model'):
            return SentencePieceTokenizer(path)
        # Specials (bos/eos) live in the sibling tokenizer_config.json;
        # without them generation would never stop at EOS.
        return HFTokenizer(path, os.path.join(os.path.dirname(path),
                                              'tokenizer_config.json'))
    tj = os.path.join(path, 'tokenizer.json')
    if os.path.exists(tj):
        try:
            return HFTokenizer(
                tj, os.path.join(path, 'tokenizer_config.json'))
        except ImportError:
            logger.warning('tokenizer.json present but the tokenizers '
                           'library is unavailable; trying others.')
    sp = os.path.join(path, 'tokenizer.model')
    if os.path.exists(sp):
        return SentencePieceTokenizer(sp)
    logger.warning('No tokenizer files under %s; using the byte-level '
                   'fallback.', path)
    return ByteTokenizer()
