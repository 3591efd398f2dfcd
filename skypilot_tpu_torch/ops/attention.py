"""Causal multi-head attention: the flash forward and backward kernels
(CUDA) and their plain PyTorch versions.

Mirrors `skypilot_tpu/ops/attention.py`.  Shapes follow
[batch, heads, seq, head_dim]; GQA maps q-head hh to kv-head
hh // (h / h_kv).

- `flash_attention` / `flash_attention_with_lse` are differentiable
  through both outputs (`_FlashLSE`, the counterpart of the reference's
  `jax.custom_vjp`): the forward saves (q, k, v, out, lse) and the
  backward is recompute-style, folding the LSE cotangent into
  delta = rowsum(dO * O) - g_lse as the reference does.
- On CUDA tensors the forward launches `csrc/flash_fwd.cu` (replaces the
  Pallas `_flash_fwd_kernel`) and the backward `csrc/flash_bwd.cu` (dQ
  and fused dK/dV, replacing `_flash_bwd_dq_kernel` and
  `_flash_bwd_dkv_kernel`), or they raise; there is no fallback.
- On CPU tensors the forward runs `_blockwise_attention` (the
  reference's online-softmax scan over k-blocks with the same masks,
  NEG_INF = -1e30, finite, and l floored at 1e-30) and the backward
  `_flash_bwd_reference` (the Pallas kernels' blockwise math).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

NEG_INF = -1e30

# Launches of each kernel of this module (plain integers; a run reads
# them to show the main path went through the kernel).
LAUNCHES = {'flash_fwd': 0, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0}

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


def _flash_bwd_reference(q, k, v, out, lse, g, g_lse, *, causal: bool,
                         sm_scale: float):
    """Plain version of the backward kernels: the Pallas dQ and dK/dV
    math, 128 keys at a time, with p = exp(s - lse) recomputed (not
    autograd of `_blockwise_attention`).  -> (dq, dk, dv) in the input
    dtypes.  GQA partials are summed over the group in f32 before the
    one cast, as the dK/dV kernel accumulates them (the reference casts
    each q-head's partial first, which only bf16 can tell apart)."""
    b, h, q_len, d = q.shape
    h_kv, k_len = k.shape[1], k.shape[2]
    delta = _delta(out, g, g_lse)
    k_rep, v_rep = _repeat_kv(q, k, v)
    q32, do32 = q.to(torch.float32), g.to(torch.float32)
    qpos = torch.arange(q_len, device=q.device) + (k_len - q_len)
    dq = torch.zeros_like(q32)
    dk = torch.empty((b, h, k_len, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for start in range(0, k_len, 128):
        blk = slice(start, start + 128)
        k_blk = k_rep[:, :, blk].to(torch.float32)
        v_blk = v_rep[:, :, blk].to(torch.float32)
        s = torch.einsum('bhqd,bhkd->bhqk', q32, k_blk) * sm_scale
        p = torch.exp(s - lse[..., None])
        if causal:
            kpos = start + torch.arange(k_blk.shape[2], device=q.device)
            p = p.masked_fill(kpos[None, :] > qpos[:, None], 0.0)
        dp = torch.einsum('bhqd,bhkd->bhqk', do32, v_blk)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum('bhqk,bhkd->bhqd', ds, k_blk)
        dv[:, :, blk] = torch.einsum('bhqk,bhqd->bhkd', p, do32)
        dk[:, :, blk] = torch.einsum('bhqk,bhqd->bhkd', ds, q32)
    group = (b, h_kv, h // h_kv, k_len, d)
    dk = dk.reshape(group).sum(dim=2) * sm_scale
    dv = dv.reshape(group).sum(dim=2)
    return ((dq * sm_scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _delta(out, g, g_lse):
    """rowsum(dO * O) - g_lse in f32 ([b, h, q_len]).  The LSE
    cotangent folds in here: dS = P * (dP - delta + g_lse), since
    d lse / dS = P."""
    delta = torch.sum(g.to(torch.float32) * out.to(torch.float32), dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.to(torch.float32)
    return delta


def _check_cuda_inputs(q, k, v, what: str = 'flash_fwd') -> None:
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError(f'{what}: {name} on {t.device}, expected '
                             f'{q.device}')
        if t.dtype != q.dtype:
            raise ValueError(f'{what}: {name} dtype {t.dtype} != '
                             f'{q.dtype}')
        if t.dim() != 4:
            raise ValueError(f'{what}: {name} must be [b, h, s, d], '
                             f'got {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'{what}: dtype {q.dtype} not supported; '
                         f'have {sorted(map(str, _DTYPE_CODES))}')
    b, h, q_len, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f'{what}: k {tuple(k.shape)} / v '
                         f'{tuple(v.shape)} do not match q {tuple(q.shape)}')
    if h % k.shape[1]:
        raise ValueError(f'{what}: {h} q-heads not a multiple of '
                         f'{k.shape[1]} kv-heads')
    if d not in HEAD_DIMS:
        raise ValueError(f'{what}: head_dim {d} not in {HEAD_DIMS}')
    if q_len == 0 or q_len > k.shape[2]:
        raise ValueError(f'{what}: needs 0 < q_len ({q_len}) <= k_len '
                         f'({k.shape[2]})')


def _flash_fwd_cuda(q, k, v, *, causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(q, k, v)
    b, h, q_len, d = q.shape
    h_kv, k_len = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=q.device)
    fn = _bind('flash_fwd', 'skyt_flash_fwd', 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):   # the launch's device is q's
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, h_kv, q_len,
                k_len, d, float(sm_scale), int(bool(causal)), stream)
    _build.check(rc, 'flash_fwd')
    LAUNCHES['flash_fwd'] += 1
    return out, lse


def _check_bwd_inputs(q, k, v, g, lse, delta) -> None:
    _check_cuda_inputs(q, k, v, 'flash_bwd')
    if (g.device != q.device or g.dtype != q.dtype or g.shape != q.shape
            or not g.is_contiguous()):
        raise ValueError(
            f'flash_bwd: the output gradient must be a contiguous '
            f'{q.dtype} {tuple(q.shape)} tensor on {q.device}, got '
            f'{g.dtype} {tuple(g.shape)} on {g.device}')
    rows = tuple(q.shape[:3])
    for name, t in (('lse', lse), ('delta', delta)):
        if (t.device != q.device or t.dtype != torch.float32 or
                tuple(t.shape) != rows or not t.is_contiguous()):
            raise ValueError(f'flash_bwd: {name} must be a contiguous '
                             f'float32 {rows} tensor on {q.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')


def _bwd_args(q, k, v, g, lse, delta, causal: bool, sm_scale: float):
    """(input pointers, trailing scalars) of both backward kernels."""
    b, h, q_len, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (_DTYPE_CODES[q.dtype], b, h, k.shape[1], q_len, k.shape[2], d,
             float(sm_scale), int(bool(causal)), stream))


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, *, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """The dQ kernel (B4) alone, delta given."""
    _check_bwd_inputs(q, k, v, g, lse, delta)
    ptrs, scalars = _bwd_args(q, k, v, g, lse, delta, causal, sm_scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _bind('flash_bwd', 'skyt_flash_bwd_dq', 7)(
            *ptrs, dq.data_ptr(), *scalars)
    _build.check(rc, 'flash_bwd_dq')
    LAUNCHES['flash_bwd_dq'] += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, *, causal: bool,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused dK/dV kernel (B5) alone, delta given."""
    _check_bwd_inputs(q, k, v, g, lse, delta)
    ptrs, scalars = _bwd_args(q, k, v, g, lse, delta, causal, sm_scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _bind('flash_bwd', 'skyt_flash_bwd_dkv', 8)(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *scalars)
    _build.check(rc, 'flash_bwd_dkv')
    LAUNCHES['flash_bwd_dkv'] += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, out, lse, g, g_lse, *, causal: bool,
                    sm_scale: float):
    """delta as a PyTorch expression (as in the reference), then the dQ
    kernel and the fused dK/dV kernel on the current stream."""
    if (out.device != q.device or out.dtype != q.dtype or
            out.shape != q.shape):
        raise ValueError(f'flash_bwd: out must be a {q.dtype} '
                         f'{tuple(q.shape)} tensor on {q.device}')
    delta = _delta(out, g, g_lse).contiguous()
    dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal=causal,
                            sm_scale=sm_scale)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal=causal,
                                 sm_scale=sm_scale)
    return dq, dk, dv


def _bind(source: str, symbol: str, n_ptrs: int):
    """The C entry point `symbol` of csrc/<source>.cu: n_ptrs pointers,
    then dtype, b, h, h_kv, q_len, k_len, d, sm_scale, causal, stream."""
    fn = getattr(_build.library(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


class _FlashLSE(torch.autograd.Function):
    """(q, k, v) -> (out, lse), differentiable through both outputs.
    A cotangent that autograd leaves as None counts as zero."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        # pylint: disable=arguments-differ
        if q.device.type == 'cuda':
            out, lse = _flash_fwd_cuda(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
        else:
            out, lse = _blockwise_attention(q, k, v, causal=causal,
                                            sm_scale=sm_scale,
                                            return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        # pylint: disable=arguments-differ
        q, k, v, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g.contiguous()
        bwd = (_flash_bwd_cuda if q.device.type == 'cuda'
               else _flash_bwd_reference)
        dq, dk, dv = bwd(q, k, v, out, lse, g, g_lse, causal=ctx.causal,
                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [b, h, q_len, d] in q's dtype, lse [b, h, q_len] f32),
    differentiable through both.  CUDA tensors run the kernels; CPU
    tensors the plain versions."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if q.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'flash_attention: unsupported device {q.device}')
    return _FlashLSE.apply(q, k, v, bool(causal), float(sm_scale))


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [batch, heads, seq, head_dim] tensors."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale)[0]
