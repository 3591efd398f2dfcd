"""Causal multi-head attention: the flash forward kernel (CUDA) and its
plain PyTorch version.

Mirrors `skypilot_tpu/ops/attention.py`'s forward.  Shapes follow
[batch, heads, seq, head_dim]; GQA maps q-head hh to kv-head
hh // (h / h_kv).

- On a CUDA tensor, `flash_attention_with_lse` launches the kernel in
  `csrc/flash_fwd.cu` (which replaces the Pallas `_flash_fwd_kernel`)
  or raises; there is no fallback.
- On a CPU tensor it runs `_blockwise_attention`: the reference's
  online-softmax scan over k-blocks with the same masks,
  NEG_INF = -1e30 (finite) and l floored at 1e-30.

Forward only: the backward kernels come with training, in a later
slice, together with an autograd.Function around this op.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

NEG_INF = -1e30

# Launches of each kernel of this module (plain integers; a run reads
# them to show the main path went through the kernel).
LAUNCHES = {'flash_fwd': 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def _repeat_kv(q, k, v):
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _blockwise_attention(q, k, v, *, causal: bool, sm_scale: float,
                         block_k: int = 128, return_lse: bool = False):
    """Plain version: online-softmax attention scanning over k blocks
    (f32 accumulation; out in q's dtype, lse [b, h, q_len] f32)."""
    k, v = _repeat_kv(q, k, v)
    b, h, q_len, d = q.shape
    k_len = k.shape[2]
    q32 = q.to(torch.float32)
    qpos = torch.arange(q_len, device=q.device) + (k_len - q_len)
    o = torch.zeros((b, h, q_len, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, q_len), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, q_len), dtype=torch.float32, device=q.device)
    for start in range(0, max(k_len, 1), block_k):
        k_blk = k[:, :, start:start + block_k].to(torch.float32)
        v_blk = v[:, :, start:start + block_k].to(torch.float32)
        s = torch.einsum('bhqd,bhkd->bhqk', q32, k_blk) * sm_scale
        kpos = start + torch.arange(k_blk.shape[2], device=q.device)
        mask = kpos[None, :] < k_len
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = s.masked_fill(~mask[None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum('bhqk,bhkd->bhqd', p, v_blk)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (o / l_safe[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l_safe)
    return out


def _check_cuda_inputs(q, k, v) -> None:
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError(f'flash_fwd: {name} on {t.device}, expected '
                             f'{q.device}')
        if t.dtype != q.dtype:
            raise ValueError(f'flash_fwd: {name} dtype {t.dtype} != '
                             f'{q.dtype}')
        if t.dim() != 4:
            raise ValueError(f'flash_fwd: {name} must be [b, h, s, d], '
                             f'got {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'flash_fwd: {name} must be contiguous')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'flash_fwd: dtype {q.dtype} not supported; '
                         f'have {sorted(map(str, _DTYPE_CODES))}')
    b, h, q_len, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f'flash_fwd: k {tuple(k.shape)} / v '
                         f'{tuple(v.shape)} do not match q {tuple(q.shape)}')
    if h % k.shape[1]:
        raise ValueError(f'flash_fwd: {h} q-heads not a multiple of '
                         f'{k.shape[1]} kv-heads')
    if d not in HEAD_DIMS:
        raise ValueError(f'flash_fwd: head_dim {d} not in {HEAD_DIMS}')
    if q_len == 0 or q_len > k.shape[2]:
        raise ValueError(f'flash_fwd: needs 0 < q_len ({q_len}) <= k_len '
                         f'({k.shape[2]})')


def _flash_fwd_cuda(q, k, v, *, causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(q, k, v)
    b, h, q_len, d = q.shape
    h_kv, k_len = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=q.device)
    fn = _bind()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, h_kv, q_len,
            k_len, d, float(sm_scale), int(bool(causal)), stream)
    _build.check(rc, 'flash_fwd')
    LAUNCHES['flash_fwd'] += 1
    return out, lse


def _bind():
    lib = _build.library('flash_fwd')
    fn = lib.skyt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [b, h, q_len, d] in q's dtype, lse [b, h, q_len] f32).
    CUDA tensors run the kernel; CPU tensors the plain version."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if q.device.type == 'cuda':
        return _flash_fwd_cuda(q, k, v, causal=causal,
                               sm_scale=float(sm_scale))
    if q.device.type != 'cpu':
        raise ValueError(f'flash_attention: unsupported device {q.device}')
    return _blockwise_attention(q, k, v, causal=causal,
                                sm_scale=float(sm_scale), return_lse=True)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [batch, heads, seq, head_dim] tensors."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale)[0]
