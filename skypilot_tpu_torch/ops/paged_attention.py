"""Paged decode attention: block-table reads in-kernel (CUDA) and the
plain PyTorch version.

Mirrors `skypilot_tpu/ops/paged_attention.py`.  Shapes: q [B, h_q, S, d]
(query token j of slot b at absolute position lengths[b] + j, already
written into the pool); pool leaves [n_pages, h_kv, ps, d], or int8
{'q': int8 [n_pages, h_kv, ps, d], 'scale': f32 [n_pages, h_kv, ps]};
tables [B, P] int32; lengths [B] int32 (pre-write depths).  Returns
[B, h_q, S, d] in q's dtype.

- On CUDA tensors, `paged_attention` launches `csrc/paged_attention.cu`
  (skyt_paged_attention for native pools, skyt_paged_attention_int8
  for int8 pools; they replace the Pallas `_paged_decode_kernel` and
  `_paged_decode_kernel_int8`) or raises; there is no fallback.  Both
  are one split-context kernel: each slot's page walk is cut into spans
  of SPLIT_PAGES pages, one block each, merged in split order; the
  wrapper allocates its f32 workspace and keeps its ticket counters
  (zero between launches, reset by the kernel).
- Ticket counters are kept per (device, stream): launches that overlap
  on two streams of one device (two engines, a capture stream) each
  count in their own int32 array.  A stream's array grows when a
  launch needs more counters than it holds (b * h_kv), and only after
  that stream has synchronised: until then a launch in flight on it
  may still hold the array, and no other stream ever uses it.  Growing
  after a sync was chosen over one array sized up front because the
  wrapper cannot know the largest batch a stream will see; an engine's
  slot count fixes it, so a stream grows at most once in practice.
- On CPU tensors it runs `_paged_attention_reference`: gather the pool
  rows each table names, dequantize in f32, masked softmax.
"""
from __future__ import annotations

import ctypes
from typing import Any, Optional

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops.attention import HEAD_DIMS
from skypilot_tpu_torch.ops.attention import NEG_INF

# Launches of each kernel of this module (plain integers).
LAUNCHES = {'paged_attention': 0, 'paged_attention_int8': 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Pages per split of both kernels (kSplitPages in the source; the
# binding checks that the two agree).
SPLIT_PAGES = 4

# The kernels' ticket counters by (device, stream handle), shared by
# both kernels: int32, zero between launches (the last block of a
# slot's splits resets its counter).
_TICKETS = {}


def _paged_attention_reference(q, k_leaf: Any, v_leaf: Any, tables,
                               lengths, *, sm_scale: float):
    """Plain version with the kernel's masking math: gather the pool
    rows each table names, dequant (f32), attend."""
    b, h_q, s_q, d = q.shape
    tables = tables.long()

    def gather(leaf):
        if isinstance(leaf, dict):
            vals = leaf['q'][tables].to(torch.float32)
            scale = leaf['scale'][tables].to(torch.float32)
            arr = vals * scale[..., None]
        else:
            arr = leaf[tables].to(torch.float32)
        bb, p, h, s, dd = arr.shape
        return arr.permute(0, 2, 1, 3, 4).reshape(bb, h, p * s, dd)

    k = gather(k_leaf)                              # [B, h_kv, P*ps, d]
    v = gather(v_leaf)
    h_kv = k.shape[1]
    rep = h_q // h_kv
    qg = q.reshape(b, h_kv, rep, s_q, d).to(torch.float32)
    s = torch.einsum('bgrqd,bgkd->bgrqk', qg, k) * sm_scale
    kpos = torch.arange(k.shape[2], device=q.device)
    qpos = (lengths.long()[:, None] +
            torch.arange(s_q, device=q.device)[None, :])       # [B, S]
    mask = (kpos[None, None, None, None, :] <=
            qpos[:, None, None, :, None])
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bgrqk,bgkd->bgrqd', p, v)
    return out.reshape(b, h_q, s_q, d).to(q.dtype)


def _bind(int8: bool):
    lib = _build.library('paged_attention')
    fn = lib.skyt_paged_attention_int8 if int8 else lib.skyt_paged_attention
    if fn.argtypes is None:
        if lib.skyt_paged_split_pages() != SPLIT_PAGES:
            raise RuntimeError(
                'paged_attention: the library splits every '
                f'{lib.skyt_paged_split_pages()} pages, the wrapper sizes '
                f'its workspace for {SPLIT_PAGES}')
        n_ptrs = 10 if int8 else 8
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 +
                       [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _require(t: torch.Tensor, name: str, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f'paged_attention: {name} on {t.device}, '
                         f'expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'paged_attention: {name} dtype {t.dtype}, '
                         f'expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'paged_attention: {name} shape '
                         f'{tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'paged_attention: {name} must be contiguous')


def _tickets(dev, stream: int, n: int, synchronize) -> torch.Tensor:
    """At least n zeroed int32 ticket counters for launches on `stream`
    of `dev`, kept across launches.  A larger array replaces the
    stream's old one only after `synchronize()` (that stream's sync):
    no launch in flight still counts in the old array."""
    key = (dev, stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < n:
        if tickets is not None:
            synchronize()
        tickets = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _TICKETS[key] = tickets
    return tickets


def _paged_attention_cuda(q, k_leaf, v_leaf, tables, lengths, *,
                          sm_scale: float):
    b, h_q, s_q, d = q.shape
    quantized = isinstance(k_leaf, dict)
    pool = k_leaf['q'] if quantized else k_leaf
    if pool.dim() != 4:
        raise ValueError(f'paged_attention: pool must be [n_pages, h_kv, '
                         f'ps, d], got {tuple(pool.shape)}')
    n_pages, h_kv, ps, _ = pool.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'paged_attention: q dtype {q.dtype} not '
                         'supported; have float32, bfloat16')
    if d not in HEAD_DIMS:
        raise ValueError(f'paged_attention: head_dim {d} not in '
                         f'{HEAD_DIMS}')
    if h_q % h_kv:
        raise ValueError(f'paged_attention: {h_q} q-heads not a multiple '
                         f'of {h_kv} kv-heads')
    dev = q.device
    _require(q, 'q', dev, q.dtype, (b, h_q, s_q, d))
    kv_shape = (n_pages, h_kv, ps, d)
    if quantized:
        for name, leaf in (('k', k_leaf), ('v', v_leaf)):
            _require(leaf['q'], f'{name}.q', dev, torch.int8, kv_shape)
            _require(leaf['scale'], f'{name}.scale', dev, torch.float32,
                     kv_shape[:-1])
    else:
        _require(k_leaf, 'k', dev, q.dtype, kv_shape)
        _require(v_leaf, 'v', dev, q.dtype, kv_shape)
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f'paged_attention: tables must be [{b}, P], got '
                         f'{tuple(tables.shape)}')
    _require(tables, 'tables', dev, torch.int32, tables.shape)
    _require(lengths, 'lengths', dev, torch.int32, (b,))
    rep = h_q // h_kv
    out = torch.empty_like(q)
    current = torch.cuda.current_stream(dev)
    stream = current.cuda_stream
    args = (b, h_kv, rep * s_q, s_q, tables.shape[1], ps, d,
            float(sm_scale), stream)
    # q [B, h_q, S, d] is [B, h_kv, rep * S, d] in memory: row r of
    # group g is q-head g * rep + r // S at token r % S.
    pools = ((k_leaf['q'], v_leaf['q']) if quantized else (k_leaf, v_leaf))
    for name, t in (('q', q), ('k', pools[0]), ('v', pools[1])):
        if t.data_ptr() % 16:
            raise ValueError(f'paged_attention: {name} must be 16-byte '
                             'aligned')
    splits = -(-tables.shape[1] // SPLIT_PAGES)
    work = torch.empty(b * h_kv * splits * rep * s_q * (d + 2),
                       dtype=torch.float32, device=dev)
    tickets = _tickets(dev, stream, b * h_kv, current.synchronize)
    if quantized:
        rc = _bind(True)(q.data_ptr(), k_leaf['q'].data_ptr(),
                         k_leaf['scale'].data_ptr(), v_leaf['q'].data_ptr(),
                         v_leaf['scale'].data_ptr(), out.data_ptr(),
                         work.data_ptr(), tickets.data_ptr(),
                         tables.data_ptr(), lengths.data_ptr(),
                         _DTYPE_CODES[q.dtype], *args)
        _build.check(rc, 'paged_attention_int8')
        LAUNCHES['paged_attention_int8'] += 1
    else:
        rc = _bind(False)(q.data_ptr(), k_leaf.data_ptr(),
                          v_leaf.data_ptr(), out.data_ptr(),
                          work.data_ptr(), tickets.data_ptr(),
                          tables.data_ptr(), lengths.data_ptr(),
                          _DTYPE_CODES[q.dtype], *args)
        _build.check(rc, 'paged_attention')
        LAUNCHES['paged_attention'] += 1
    return out


def paged_attention(q, k_leaf: Any, v_leaf: Any, tables, lengths, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention over one layer's page pool (see module
    docstring).  CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if q.device.type == 'cuda':
        return _paged_attention_cuda(q, k_leaf, v_leaf, tables, lengths,
                                     sm_scale=float(sm_scale))
    if q.device.type != 'cpu':
        raise ValueError(f'paged_attention: unsupported device {q.device}')
    return _paged_attention_reference(q, k_leaf, v_leaf, tables, lengths,
                                      sm_scale=float(sm_scale))
