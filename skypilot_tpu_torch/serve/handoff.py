"""KV handoff wire format (copied from `skypilot_tpu/serve/handoff.py`;
the bytes on the wire are the reference's for the same arrays).

A prefill replica ships a prompt's FULL prefilled pages in page-major
layout `[L, n_pages, h_kv, page_size, d]` with the chain hashes that
name them; the decode replica adopts them through its own prefix
cache, so a handoff is a remote prefix-cache fill.

JSON wire:

    {"version": 1, "page_size": P, "n_pages": N,
     "hashes": [h0, h1, ...],            # chain hashes, page order
     "dtype": "float32" | "int8",
     "shape": [L, N, h_kv, P, d],
     "k": "<b64>", "v": "<b64>",          # raw little-endian bytes
     "k_scale": "<b64>", "v_scale": ...}  # int8 only: f32 [L,N,h_kv,P]

Float payloads are always float32 (bf16 -> f32 is exact); int8
payloads carry the per-token scales as `models/decode._quant_kv` made
them, and requantization on a receiving int8 pool is byte-stable.  The
prompt's tail past the last full page is not shipped: the decode
replica prefills it (< one page), like a partial prefix hit.

Binary wire (`application/octet-stream`), the same fields with the
arrays raw:

    b'SKTH1\\n' | u32 header_len | header JSON | k | v [| k_scale | v_scale]

the header being the JSON payload without the blobs, the arrays
little-endian and C-contiguous in that order.
"""
from __future__ import annotations

import base64
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

WIRE_VERSION = 1

# Binary-frame magic (versioned: bump with WIRE_VERSION).
BINARY_MAGIC = b'SKTH1\n'
CONTENT_TYPE_BINARY = 'application/octet-stream'


class HandoffError(RuntimeError):
    """The handoff cannot proceed (wrong mode, mismatched geometry,
    malformed payload).  Routers treat it as 'fall back to local
    prefill' — never a failed request."""


class HandoffRejected(HandoffError):
    """The decode replica refused the import right now (chaos deny /
    shedding); the request must still complete via local prefill."""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _unb64(data: str, dtype: str, shape: Sequence[int]) -> np.ndarray:
    raw = base64.b64decode(data)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype))
    expect = int(np.prod(shape))
    if arr.size != expect:
        raise HandoffError(
            f'payload size mismatch: {arr.size} elements for shape '
            f'{list(shape)} ({expect})')
    return arr.reshape(shape)


def encode_payload(hashes: Sequence[int], page_size: int,
                   k_pages: np.ndarray, v_pages: np.ndarray,
                   k_scale: Optional[np.ndarray] = None,
                   v_scale: Optional[np.ndarray] = None
                   ) -> Dict[str, Any]:
    """Pack exported pages for the wire.  k/v are `[L, N, h_kv, ps, d]`
    — float32, or int8 with f32 scales `[L, N, h_kv, ps]`."""
    quantized = k_scale is not None
    payload: Dict[str, Any] = {
        'version': WIRE_VERSION,
        'page_size': int(page_size),
        'n_pages': int(k_pages.shape[1]),
        'hashes': [int(h) for h in hashes],
        'dtype': 'int8' if quantized else 'float32',
        'shape': [int(s) for s in k_pages.shape],
        'k': _b64(k_pages),
        'v': _b64(v_pages),
    }
    if quantized:
        payload['k_scale'] = _b64(np.asarray(k_scale, np.float32))
        payload['v_scale'] = _b64(np.asarray(v_scale, np.float32))
    return payload


def encode_binary(hashes: Sequence[int], page_size: int,
                  k_pages: np.ndarray, v_pages: np.ndarray,
                  k_scale: Optional[np.ndarray] = None,
                  v_scale: Optional[np.ndarray] = None) -> bytes:
    """Pack exported pages as the binary frame (see module docs):
    header JSON + raw little-endian arrays in fixed order.  ~25% fewer
    bytes on the wire than the base64 form of the same payload, and no
    megabyte-string json round trip on either side."""
    import json  # pylint: disable=import-outside-toplevel
    quantized = k_scale is not None
    header = {
        'version': WIRE_VERSION,
        'page_size': int(page_size),
        'n_pages': int(k_pages.shape[1]),
        'hashes': [int(h) for h in hashes],
        'dtype': 'int8' if quantized else 'float32',
        'shape': [int(s) for s in k_pages.shape],
    }
    head = json.dumps(header).encode()
    parts = [BINARY_MAGIC, len(head).to_bytes(4, 'little'), head,
             np.ascontiguousarray(k_pages).tobytes(),
             np.ascontiguousarray(v_pages).tobytes()]
    if quantized:
        parts.append(np.ascontiguousarray(
            np.asarray(k_scale, np.float32)).tobytes())
        parts.append(np.ascontiguousarray(
            np.asarray(v_scale, np.float32)).tobytes())
    return b''.join(parts)


def decode_binary(data: bytes) -> Dict[str, Any]:
    """Unpack a binary frame into the same dict `decode_payload`
    returns: {'hashes', 'page_size', 'k', 'v'[, 'k_scale', 'v_scale']}
    with k/v `[L, N, h_kv, ps, d]`."""
    import json  # pylint: disable=import-outside-toplevel
    if not data.startswith(BINARY_MAGIC):
        raise HandoffError('not a binary handoff frame (bad magic)')
    off = len(BINARY_MAGIC)
    if len(data) < off + 4:
        raise HandoffError('truncated binary handoff frame')
    head_len = int.from_bytes(data[off:off + 4], 'little')
    off += 4
    if len(data) < off + head_len:
        raise HandoffError('truncated binary handoff header')
    try:
        header = json.loads(data[off:off + head_len])
    except (ValueError, UnicodeDecodeError) as e:
        raise HandoffError(f'malformed binary handoff header: {e}') \
            from e
    off += head_len
    version = header.get('version')
    if version != WIRE_VERSION:
        raise HandoffError(f'unsupported handoff wire version '
                           f'{version!r} (have {WIRE_VERSION})')
    try:
        shape = [int(s) for s in header['shape']]
        hashes = [int(h) for h in header['hashes']]
        page_size = int(header['page_size'])
        dtype = header['dtype']
    except (KeyError, ValueError, TypeError) as e:
        raise HandoffError(f'malformed binary handoff header: {e}') \
            from e
    if len(shape) != 5 or shape[3] != page_size or \
            shape[1] != len(hashes):
        raise HandoffError(f'bad binary handoff geometry: shape '
                           f'{shape}, page_size {page_size}, '
                           f'{len(hashes)} hashes')
    if dtype not in ('float32', 'int8'):
        raise HandoffError(f'unsupported handoff dtype {dtype!r}')
    count = int(np.prod(shape))
    itemsize = 1 if dtype == 'int8' else 4

    def take(n_bytes: int, np_dtype, arr_shape) -> np.ndarray:
        nonlocal off
        if len(data) < off + n_bytes:
            raise HandoffError('truncated binary handoff arrays')
        arr = np.frombuffer(data, dtype=np_dtype, count=int(
            np.prod(arr_shape)), offset=off).reshape(arr_shape)
        off += n_bytes
        return arr

    k = take(count * itemsize, dtype, shape)
    v = take(count * itemsize, dtype, shape)
    out = {'hashes': hashes, 'page_size': page_size, 'k': k, 'v': v}
    if dtype == 'int8':
        scale_count = int(np.prod(shape[:4]))
        out['k_scale'] = take(scale_count * 4, np.float32, shape[:4])
        out['v_scale'] = take(scale_count * 4, np.float32, shape[:4])
    if off != len(data):
        raise HandoffError(
            f'binary handoff frame has {len(data) - off} trailing '
            f'bytes')
    return out


def decode_payload(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Unpack a wire payload into page arrays ready for pool adoption:
    `{'hashes', 'page_size', 'k', 'v'}` with k/v
    `[L, N, h_kv, ps, d]`.  float32 payloads decode as float32; int8
    payloads stay int8 WITH their scales (`k_scale`/`v_scale`,
    `[L, N, h_kv, ps]` f32) — an int8 pool adopts them byte-for-byte
    without a dequantize/requantize round trip (the engine dequantizes
    only when the receiving pool is float)."""
    try:
        version = int(payload.get('version', 0))
    except (TypeError, ValueError):
        version = 0
    if version != WIRE_VERSION:
        raise HandoffError(
            f'unsupported handoff wire version '
            f'{payload.get("version")!r} (have {WIRE_VERSION})')
    try:
        shape = [int(s) for s in payload['shape']]
        hashes: List[int] = [int(h) for h in payload['hashes']]
        page_size = int(payload['page_size'])
        dtype = payload['dtype']
        if len(shape) != 5:
            raise HandoffError(f'bad page shape {shape}')
        if shape[3] != page_size:
            raise HandoffError(
                f'shape page dim {shape[3]} != page_size {page_size}')
        if shape[1] != len(hashes):
            raise HandoffError(
                f'{shape[1]} pages but {len(hashes)} chain hashes')
        scales = {}
        if dtype == 'int8':
            k = _unb64(payload['k'], 'int8', shape)
            v = _unb64(payload['v'], 'int8', shape)
            scales = {
                'k_scale': _unb64(payload['k_scale'], 'float32',
                                  shape[:4]),
                'v_scale': _unb64(payload['v_scale'], 'float32',
                                  shape[:4]),
            }
        elif dtype == 'float32':
            k = _unb64(payload['k'], 'float32', shape)
            v = _unb64(payload['v'], 'float32', shape)
        else:
            raise HandoffError(f'unsupported handoff dtype {dtype!r}')
    except HandoffError:
        raise
    except (KeyError, ValueError, TypeError) as e:
        raise HandoffError(f'malformed handoff payload: {e}') from e
    return {'hashes': hashes, 'page_size': page_size, 'k': k, 'v': v,
            **scales}
