"""The port's attention ops against the JAX reference kernels.

On the CPU each op runs its plain PyTorch version; the JAX side runs
the Pallas kernels in interpret mode (SKYTPU_PALLAS_INTERPRET=1, read
at call time), the backward included (`jax.grad` through
`flash_attention_with_lse` reaches `_flash_bwd_pallas`).  Inputs and
cotangents come from numpy with a seed.  Tolerance: 1e-5 absolute and
relative, f32 on both sides (the two accumulate in different orders).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_gpu.py.  Also here: a plain model of the bf16
roundings the tensor-core kernels add (held to the card's tolerances),
a plain model of the paged kernels' split-and-merge order, for native
(f32, bf16) and int8 pools (held to both references, and bit-equal
across S and batch), and the build's hashing of sources and shared
headers.
"""
from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu.ops import paged_attention as jax_paged
from skypilot_tpu_torch import profile_paged
from skypilot_tpu_torch.models import decode as torch_decode
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import paged_attention

ATOL = RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv('SKYTPU_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('SKYTPU_DECODE_KERNEL', 'pallas')


def _qkv(rng, b, h, h_kv, q_len, k_len, d):
    q = rng.standard_normal((b, h, q_len, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, k_len, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, k_len, d)).astype(np.float32)
    return q, k, v


# (q_len, k_len, causal): ragged lengths, a q_len < k_len suffix
# (decode-style), one multi-block case, and a non-causal case.
FLASH_CASES = [(7, 7, True), (16, 16, True), (5, 13, True), (1, 9, True),
               (33, 70, True), (12, 12, False)]


@pytest.mark.parametrize('q_len,k_len,causal', FLASH_CASES)
def test_flash_plain_matches_pallas(interpret, q_len, k_len, causal):
    rng = np.random.default_rng(q_len * 100 + k_len)
    q, k, v = _qkv(rng, 2, 4, 2, q_len, k_len, 16)   # GQA rep 2
    sm_scale = 16 ** -0.5
    jo, jl = jax_attention._flash_fwd_pallas(  # pylint: disable=protected-access
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=sm_scale, block_q=32, block_k=32)
    to, tl = attention.flash_attention_with_lse(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        sm_scale=sm_scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)


def test_flash_default_scale_and_out_only():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 2, 1, 6, 6, 8)
    out = attention.flash_attention(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v))
    ref = jax_attention.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _jax_grads(q, k, v, g, g_lse, causal, sm_scale):
    """jax.grad of <out, g> + <lse, g_lse> through the reference op
    (Pallas forward and backward kernels in interpret mode)."""
    def f(q, k, v):
        out, lse = jax_attention.flash_attention_with_lse(
            q, k, v, causal=causal, sm_scale=sm_scale, block_q=32,
            block_k=32)
        total = jnp.sum(out * g) if g is not None else 0.0
        return total + jnp.sum(lse * g_lse)
    return jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _torch_grads(q, k, v, g, g_lse, causal, sm_scale):
    """Gradients through the port's differentiable op (_FlashLSE)."""
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = attention.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                                  sm_scale=sm_scale)
    total = (lse * torch.tensor(g_lse)).sum()
    if g is not None:
        total = total + (out * torch.tensor(g)).sum()
    total.backward()
    return tq.grad, tk.grad, tv.grad


# FLASH_CASES at GQA rep 2, a few at rep 3 (h 6 over 2 kv-heads), all
# with a non-zero LSE cotangent.
BWD_CASES = ([case + (4,) for case in FLASH_CASES] +
             [(7, 7, True, 6), (33, 70, True, 6), (12, 12, False, 6)])


@pytest.mark.parametrize('q_len,k_len,causal,h', BWD_CASES)
def test_flash_bwd_matches_pallas(interpret, q_len, k_len, causal, h):
    rng = np.random.default_rng(q_len * 10 + k_len + h)
    q, k, v = _qkv(rng, 2, h, 2, q_len, k_len, 16)
    g = rng.standard_normal(q.shape).astype(np.float32)
    g_lse = rng.standard_normal(q.shape[:3]).astype(np.float32)
    sm_scale = 16 ** -0.5
    ref = _jax_grads(q, k, v, g, g_lse, causal, sm_scale)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, lse = attention.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                                  sm_scale=sm_scale)
    plain = attention._flash_bwd_reference(  # pylint: disable=protected-access
        tq, tk, tv, out, lse, torch.tensor(g), torch.tensor(g_lse),
        causal=causal, sm_scale=sm_scale)
    auto = _torch_grads(q, k, v, g, g_lse, causal, sm_scale)
    for name, p, a, r in zip('qkv', plain, auto, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=f'd{name} plain')
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=f'd{name} autograd')


def test_flash_bwd_lse_only_cotangent(interpret):
    """Only the LSE feeds the loss: autograd hands the out cotangent in
    as None, which counts as zero."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 4, 2, 9, 9, 16)
    g_lse = rng.standard_normal(q.shape[:3]).astype(np.float32)
    ref = _jax_grads(q, k, v, None, g_lse, True, 0.25)
    got = _torch_grads(q, k, v, None, g_lse, True, 0.25)
    for t, r in zip(got, ref):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


def _pool(rng, n_pages, h_kv, ps, d, quantized):
    k = rng.standard_normal((n_pages, h_kv, ps, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, h_kv, ps, d)).astype(np.float32)
    if not quantized:
        return ((jnp.asarray(k), jnp.asarray(v)),
                (torch.tensor(k), torch.tensor(v)))
    out_j, out_t = [], []
    for arr in (k, v):
        q, scale = jax_decode._quant_kv(jnp.asarray(arr))  # pylint: disable=protected-access
        out_j.append({'q': q, 'scale': scale})
        out_t.append({'q': torch.tensor(np.asarray(q)),
                      'scale': torch.tensor(np.asarray(scale))})
    return tuple(out_j), tuple(out_t)


@pytest.mark.parametrize('quantized', [False, True],
                         ids=['native', 'int8'])
@pytest.mark.parametrize('s_q', [1, 4])
def test_paged_plain_matches_pallas(interpret, quantized, s_q):
    rng = np.random.default_rng(7 + s_q + 10 * quantized)
    b, h_q, h_kv, d, ps, n_pages = 4, 4, 2, 16, 8, 12
    (jk, jv), (tk, tv) = _pool(rng, n_pages, h_kv, ps, d, quantized)
    q = rng.standard_normal((b, h_q, s_q, d)).astype(np.float32)
    # Ragged lengths 1..17; tables share pages and point unused rows at
    # the null page 0.
    lengths = np.array([1, 8, 13, 17], np.int32)
    tables = np.array([[3, 0, 0, 0], [5, 6, 0, 0], [7, 2, 9, 0],
                       [1, 4, 10, 11]], np.int32)
    jo = jax_paged.paged_attention(jnp.asarray(q), jk, jv,
                                   jnp.asarray(tables),
                                   jnp.asarray(lengths), sm_scale=0.3)
    to = paged_attention.paged_attention(
        torch.tensor(q), tk, tv, torch.tensor(tables),
        torch.tensor(lengths), sm_scale=0.3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)


def test_quant_kv_bytes_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 3, 7, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # zero row: scale 1
    x[1, 1, 1, :4] = [127.0, -63.5, 0.5, 1.5]   # exact ties
    jq, js = jax_decode._quant_kv(jnp.asarray(x))  # pylint: disable=protected-access
    tq, ts = torch_decode._quant_kv(torch.tensor(x))  # pylint: disable=protected-access
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


# ---------------------------------------------------------------------
# The tensor-core kernels' roundings, modelled in plain PyTorch.
#
# The bf16 B3 (csrc/flash_fwd.cu) rounds P to bf16 before P·V; the bf16
# B5 (csrc/flash_bwd.cu) rounds P^T and dS^T to bf16 before dV += P^T dO
# and dK += dS^T Q.  Everything else accumulates in f32, as the plain
# versions do.  These models show, without a GPU, that the tolerances
# the card holds the kernels to (2e-2; 2e-2 of the largest |value| for
# gradients; 1e-3 for the LSE) are reachable by design.

def _fwd_model(q, k, v, *, causal, sm_scale, block_k=64):
    """_blockwise_attention with P rounded to bf16 before P·V."""
    k, v = attention._repeat_kv(q, k, v)  # pylint: disable=protected-access
    b, h, q_len, d = q.shape
    k_len = k.shape[2]
    q32 = q.float()
    qpos = torch.arange(q_len) + (k_len - q_len)
    o = torch.zeros((b, h, q_len, d))
    m = torch.full((b, h, q_len), attention.NEG_INF)
    l = torch.zeros((b, h, q_len))
    for start in range(0, k_len, block_k):
        k_blk = k[:, :, start:start + block_k].float()
        v_blk = v[:, :, start:start + block_k].float()
        s = torch.einsum('bhqd,bhkd->bhqk', q32, k_blk) * sm_scale
        kpos = start + torch.arange(k_blk.shape[2])
        if causal:
            s = s.masked_fill(kpos[None, :] > qpos[:, None],
                              attention.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        p16 = p.to(torch.bfloat16).float()
        o = o * corr[..., None] + torch.einsum('bhqk,bhkd->bhqd', p16, v_blk)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return (o / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def _dkv_model(q, k, v, out, lse, g, g_lse, *, causal, sm_scale):
    """dK, dV of _flash_bwd_reference with P^T and dS^T rounded to bf16
    before their products."""
    b, h, q_len, d = q.shape
    h_kv, k_len = k.shape[1], k.shape[2]
    delta = attention._delta(out, g, g_lse)  # pylint: disable=protected-access
    k_rep, v_rep = attention._repeat_kv(q, k, v)  # pylint: disable=protected-access
    q32, do32 = q.float(), g.float()
    s = torch.einsum('bhqd,bhkd->bhqk', q32, k_rep.float()) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        qpos = torch.arange(q_len) + (k_len - q_len)
        p = p.masked_fill(torch.arange(k_len)[None, :] > qpos[:, None], 0.0)
    dp = torch.einsum('bhqd,bhkd->bhqk', do32, v_rep.float())
    ds = p * (dp - delta[..., None])
    p16 = p.to(torch.bfloat16).float()
    ds16 = ds.to(torch.bfloat16).float()
    dv = torch.einsum('bhqk,bhqd->bhkd', p16, do32)
    dk = torch.einsum('bhqk,bhqd->bhkd', ds16, q32)
    group = (b, h_kv, h // h_kv, k_len, d)
    return ((dk.reshape(group).sum(dim=2) * sm_scale).to(k.dtype),
            dv.reshape(group).sum(dim=2).to(v.dtype))


# (q_len, k_len, causal) at b 1, 8/2 heads, d 64, bf16 inputs.
BF16_MODEL_CASES = [(192, 192, True), (100, 250, True), (130, 130, False)]


def _bf16_inputs(q_len, k_len, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(x).to(torch.bfloat16)
               for x in _qkv(rng, 1, 8, 2, q_len, k_len, 64))
    g = torch.tensor(rng.standard_normal(q.shape).astype(np.float32)
                     ).to(torch.bfloat16)
    g_lse = torch.tensor(rng.standard_normal(q.shape[:3]).astype(np.float32))
    return q, k, v, g, g_lse


@pytest.mark.parametrize('q_len,k_len,causal', BF16_MODEL_CASES)
def test_bf16_p_rounding_within_forward_tolerance(q_len, k_len, causal):
    q, k, v, _, _ = _bf16_inputs(q_len, k_len, seed=q_len + k_len)
    sm_scale = 64 ** -0.5
    out, lse = _fwd_model(q, k, v, causal=causal, sm_scale=sm_scale)
    ref, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=causal, sm_scale=sm_scale, return_lse=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    # The rounding is visible: the model is not the plain version.
    assert not torch.equal(out, ref)


@pytest.mark.parametrize('q_len,k_len,causal', BF16_MODEL_CASES)
def test_bf16_pds_rounding_within_backward_tolerance(q_len, k_len, causal):
    q, k, v, g, g_lse = _bf16_inputs(q_len, k_len, seed=7 + q_len + k_len)
    sm_scale = 64 ** -0.5
    out, lse = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=causal, sm_scale=sm_scale, return_lse=True)
    kw = dict(causal=causal, sm_scale=sm_scale)
    _, dk_ref, dv_ref = attention._flash_bwd_reference(  # pylint: disable=protected-access
        q, k, v, out, lse, g, g_lse, **kw)
    dk, dv = _dkv_model(q, k, v, out, lse, g, g_lse, **kw)
    for name, got, ref in (('dk', dk, dk_ref), ('dv', dv, dv_ref)):
        rel = float((got.float() - ref.float()).abs().max() /
                    ref.float().abs().max())
        assert rel <= 2e-2, f'{name}: {rel:.3g} of max |ref|'


def _dq_model(q, k, v, out, lse, g, g_lse, *, causal, sm_scale):
    """dQ of _flash_bwd_reference with dS rounded to bf16 before dS·K
    (the bf16 B4 kernel's one added rounding)."""
    q_len, k_len = q.shape[2], k.shape[2]
    delta = attention._delta(out, g, g_lse)  # pylint: disable=protected-access
    k_rep, v_rep = attention._repeat_kv(q, k, v)  # pylint: disable=protected-access
    k32 = k_rep.float()
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k32) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        qpos = torch.arange(q_len) + (k_len - q_len)
        p = p.masked_fill(torch.arange(k_len)[None, :] > qpos[:, None], 0.0)
    dp = torch.einsum('bhqd,bhkd->bhqk', g.float(), v_rep.float())
    ds16 = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
    dq = torch.einsum('bhqk,bhkd->bhqd', ds16, k32) * sm_scale
    return dq.to(q.dtype)


@pytest.mark.parametrize('q_len,k_len,causal', BF16_MODEL_CASES)
def test_bf16_ds_rounding_within_dq_tolerance(q_len, k_len, causal):
    q, k, v, g, g_lse = _bf16_inputs(q_len, k_len, seed=11 + q_len + k_len)
    sm_scale = 64 ** -0.5
    out, lse = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=causal, sm_scale=sm_scale, return_lse=True)
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq_ref, _, _ = attention._flash_bwd_reference(  # pylint: disable=protected-access
        q, k, v, out, lse, g, g_lse, **kw)
    dq = _dq_model(q, k, v, out, lse, g, g_lse, **kw)
    assert dq.dtype == torch.bfloat16
    rel = float((dq.float() - dq_ref.float()).abs().max() /
                dq_ref.float().abs().max())
    assert rel <= 2e-2, f'dq: {rel:.3g} of max |ref|'
    # The rounding is visible: the model is not the plain version.
    assert not torch.equal(dq, dq_ref)


# ---------------------------------------------------------------------
# The split-context design of B1 and B2 (csrc/paged_attention.cu, one
# templated kernel), modelled in plain PyTorch: each slot's pages in
# splits of SPLIT_PAGES, every split its own (m, l, acc) over a fixed
# span of C * ps positions (unloaded and masked positions p = 0), merged
# in split order; a slot that fits in one split is divided directly.
# Native pages widen to f32 exactly, int8 pages are dequantized in f32.
# Every product has a shape fixed by (C, ps, d), as the kernel's lane
# mapping is fixed, so a row's bits can be compared across calls.

def _split_model(q, k_leaf, v_leaf, tables, lengths, *, sm_scale):
    b, h_q, s_q, d = q.shape
    quantized = isinstance(k_leaf, dict)
    h_kv, ps = (k_leaf['q'] if quantized else k_leaf).shape[1:3]
    c = paged_attention.SPLIT_PAGES
    n_rows, span = h_q // h_kv * s_q, c * ps
    qg = q.reshape(b, h_kv, n_rows, d).float() * sm_scale
    out = torch.empty_like(qg)
    for bi in range(b):
        length = int(lengths[bi])
        n_pages = min(tables.shape[1], -(-(length + s_q) // ps))
        n_split = -(-n_pages // c)
        for g in range(h_kv):
            parts = []
            for sp in range(n_split):
                pages = tables[bi, sp * c:min((sp + 1) * c, n_pages)].long()
                kv = []
                for leaf in (k_leaf, v_leaf):
                    x = torch.zeros((span, d))
                    if quantized:
                        vals = leaf['q'][pages, g].float() * \
                            leaf['scale'][pages, g][..., None]
                    else:
                        vals = leaf[pages, g].float()
                    x[:vals.shape[0] * ps] = vals.reshape(-1, d)
                    kv.append(x)
                loaded = torch.arange(span) < len(pages) * ps
                kpos = sp * span + torch.arange(span)
                row_parts = []
                for r in range(n_rows):
                    ok = loaded & (kpos <= length + r % s_q)
                    s = kv[0] @ qg[bi, g, r]
                    m = (s[ok].max() if bool(ok.any())
                         else torch.tensor(attention.NEG_INF))
                    p = torch.where(ok, torch.exp(s - m), torch.zeros(()))
                    row_parts.append((m, p.sum(), p @ kv[1]))
                parts.append(row_parts)
            for r in range(n_rows):
                if n_split == 1:
                    _, l, acc = parts[0][r]
                    out[bi, g, r] = acc / torch.clamp(l, min=1e-30)
                    continue
                big = max(parts[sp][r][0] for sp in range(n_split))
                l_sum, o = torch.zeros(()), torch.zeros(d)
                for sp in range(n_split):
                    m, l, acc = parts[sp][r]
                    w = torch.exp(m - big)
                    l_sum = l_sum + l * w
                    o = o + acc * w
                out[bi, g, r] = o / torch.clamp(l_sum, min=1e-30)
    return out.reshape(b, h_q, s_q, d).to(q.dtype)


def _split_case(rng, s_q, lengths, pool):
    """A pool (JAX and torch leaves; `pool` 'f32', 'bf16' or 'int8')
    with tables for `lengths`: ps 4, so a split of 4 pages spans 16
    positions; every slot's rows of the table name distinct pages,
    unused entries the null page."""
    b, h_q, h_kv, d, ps, rows = len(lengths), 4, 2, 16, 4, 12
    n_pages = 1 + b * rows
    (jk, jv), (tk, tv) = _pool(rng, n_pages, h_kv, ps, d, pool == 'int8')
    if pool == 'bf16':
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    tables = np.zeros((b, rows), np.int32)
    perm = rng.permutation(n_pages - 1) + 1
    for i, n in enumerate(lengths):
        need = min(rows, -(-(n + s_q) // ps))
        tables[i, :need] = perm[i * rows:i * rows + need]
    q = rng.standard_normal((b, h_q, s_q, d)).astype(np.float32)
    return (jk, jv), (tk, tv), q, tables, np.array(lengths, np.int32)


# Native pools in f32 and in bf16 (q in f32: the model and both
# references widen the pool exactly), and int8 pools.
SPLIT_POOLS = ['f32', 'bf16', 'int8']
SPLIT_POOL_IDS = ['native-f32', 'native-bf16', 'int8']


@pytest.mark.parametrize('pool', SPLIT_POOLS, ids=SPLIT_POOL_IDS)
@pytest.mark.parametrize('s_q', [1, 5])
def test_split_model_matches_references(s_q, pool):
    """Splits of 16 positions against the port's and the JAX package's
    plain versions; lengths cross 0, 1, 2 and 3 split boundaries."""
    rng = np.random.default_rng(31 + s_q)
    (jk, jv), (tk, tv), q, tables, lengths = _split_case(
        rng, s_q, [1, 15, 16, 40], pool)
    got = _split_model(torch.tensor(q), tk, tv, torch.tensor(tables),
                       torch.tensor(lengths), sm_scale=0.3)
    plain = paged_attention._paged_attention_reference(  # pylint: disable=protected-access
        torch.tensor(q), tk, tv, torch.tensor(tables), torch.tensor(lengths),
        sm_scale=0.3)
    ref = jax_paged._paged_attention_reference(  # pylint: disable=protected-access
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
        sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize('pool', SPLIT_POOLS, ids=SPLIT_POOL_IDS)
def test_split_model_rows_do_not_depend_on_s_or_batch(pool):
    """The row at qpos of an S = 5 call with lengths qpos - j equals, bit
    for bit, the S = 1 call at lengths qpos (the S = 5 call may reach one
    split further, wholly masked for that row); a slot alone equals the
    same slot among four."""
    rng = np.random.default_rng(5)
    qpos = [15, 16, 31, 44]          # 31: S = 5 reaches a third split
    _, (tk, tv), q1, tables, _ = _split_case(rng, 5, qpos, pool)
    q1 = torch.tensor(q1[:, :, :1])
    tables = torch.tensor(tables)
    one = _split_model(q1, tk, tv, tables, torch.tensor(qpos), sm_scale=0.3)
    q5 = q1.expand(-1, -1, 5, -1).contiguous()
    for j in range(5):
        five = _split_model(q5, tk, tv, tables,
                            torch.tensor(qpos) - j, sm_scale=0.3)
        assert torch.equal(five[:, :, j], one[:, :, 0]), j
    for i in range(len(qpos)):
        alone = _split_model(q1[i:i + 1], tk, tv, tables[i:i + 1],
                             torch.tensor(qpos[i:i + 1]), sm_scale=0.3)
        assert torch.equal(alone[0], one[i])


# ---------------------------------------------------------------------
# The build: a library's name hashes its source and the shared headers.

def _fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'kern.cu').write_text('#include "shared.cuh"\n')
    (csrc / 'shared.cuh').write_text('// v1\n')
    monkeypatch.setattr(_build, 'CSRC_DIR', str(csrc))
    monkeypatch.setenv('SKYTPU_TORCH_BUILD_DIR', str(tmp_path / 'build'))
    return csrc


@pytest.mark.parametrize('edit', ['header', 'source', 'new_header'])
def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch,
                                                  edit):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    before = _build.library_path('kern')
    assert before == _build.library_path('kern')     # stable
    assert before.startswith(str(tmp_path / 'build' / 'kern-'))
    if edit == 'header':
        (csrc / 'shared.cuh').write_text('// v2\n')
    elif edit == 'source':
        (csrc / 'kern.cu').write_text('#include "shared.cuh"\n// edit\n')
    else:
        (csrc / 'more.cuh').write_text('// another header\n')
    assert _build.library_path('kern') != before
    assert _build.build_log('kern') == ''            # nothing built here


def test_profile_paged_anchors_each_phase_once():
    """`python -m skypilot_tpu_torch.profile_paged` cuts the split
    kernel, one templated body for B1 and B2, after each phase at anchors
    in its source: each must occur once (a second body would double
    them), and the full variant is the source itself; the split span
    can be set for the sweep."""
    with open(os.path.join(_build.CSRC_DIR, 'paged_attention.cu'),
              encoding='utf-8') as f:
        source = f.read()
    variants = profile_paged.variant_sources(source)
    assert list(variants) == [p[0] for p in profile_paged.PHASES] + ['full']
    assert variants['full'] == source
    for name, text in variants.items():
        assert text.count(profile_paged._EXIT) == (name != 'full'), name  # pylint: disable=protected-access
    swept = profile_paged.split_source(source, 8)
    assert 'constexpr int kSplitPages = 8;' in swept
    assert profile_paged.split_source(
        swept, paged_attention.SPLIT_PAGES) == source


def test_every_quoted_include_is_a_hashed_header():
    """A kernel source includes only csrc/*.cuh by quotes, so the hash
    of `library_path` covers everything it is built from."""
    for name in _build.SOURCES:
        with open(os.path.join(_build.CSRC_DIR, f'{name}.cu'),
                  encoding='utf-8') as f:
            for inc in re.findall(r'#include "([^"]+)"', f.read()):
                assert inc.endswith('.cuh'), (name, inc)
                assert os.path.exists(os.path.join(_build.CSRC_DIR, inc))
