"""The port's attention ops against the JAX reference kernels.

On the CPU each op runs its plain PyTorch version; the JAX side runs
the Pallas kernels in interpret mode (SKYTPU_PALLAS_INTERPRET=1, read
at call time), the backward included (`jax.grad` through
`flash_attention_with_lse` reaches `_flash_bwd_pallas`).  Inputs and
cotangents come from numpy with a seed.  Tolerance: 1e-5 absolute and
relative, f32 on both sides (the two accumulate in different orders).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_gpu.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu.ops import paged_attention as jax_paged
from skypilot_tpu_torch.models import decode as torch_decode
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
