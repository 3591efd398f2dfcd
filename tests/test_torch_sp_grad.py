"""The backward of the port's sequence-parallel attention (A17e) against
`jax.grad` of the reference's, on the CPU.

Ring and Ulysses attention over meshes of 'cpu' entries (the port) and
of the conftest's virtual devices (the reference), at sequence 2 and 4,
with and without GQA, on the reference's cases
(tests/unit/test_compute.py: loss sum(out ** 2), ring at sequence 4 x
tensor 2, Ulysses at data 2 x sequence 2 x tensor 2).  Autograd runs
through the ring's hops (the k/v moves transpose into reverse hops;
every hop's flash op gets an out and an lse cotangent from the f32
merge) and through Ulysses' regroups.  Also `flash_attention_with_lse`
under a loss that reads the lse, causal and not: the lse cotangent that
the merge feeds each hop.  Tolerance atol 2e-4 / rtol 2e-3 (f32, the
CPU plain versions on the port's side).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.attention import flash_attention_with_lse as ref_fa
from skypilot_tpu.ops.ring_attention import ring_attention as ref_ring
from skypilot_tpu.ops.ulysses_attention import ulysses_attention as ref_uly
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu_torch.ops.attention import flash_attention_with_lse
from skypilot_tpu_torch.ops.ring_attention import ring_attention
from skypilot_tpu_torch.ops.ulysses_attention import ulysses_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib

ATOL, RTOL = 2e-4, 2e-3


def _meshes(**axes):
    n = int(np.prod(list(axes.values())))
    return (jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n]),
            mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n))


def _qkv(b, h, h_kv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d))]


def _grads(port_fn, ref_fn, arrays):
    """(port's dq/dk/dv, reference's) of sum(fn(q, k, v) ** 2)."""
    want = jax.jit(jax.grad(lambda *a: jnp.sum(ref_fn(*a) ** 2),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    (port_fn(*leaves) ** 2).sum().backward()
    return [t.grad.numpy() for t in leaves], [np.asarray(g) for g in want]


def _assert_close(got, want):
    for name, a, b in zip('qkv', got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f'd{name}')


# (mesh axes, (b, h, h_kv, s, d)); the first is the reference's case.
RING_CASES = {
    'seq4-tensor2': (dict(data=1, sequence=4, tensor=2), (1, 2, 2, 64, 16)),
    'seq2': (dict(data=1, sequence=2), (1, 2, 2, 64, 16)),
    'seq4-gqa': (dict(data=1, sequence=4), (2, 4, 2, 64, 16)),
    'seq2-gqa': (dict(data=1, sequence=2), (1, 8, 2, 96, 16)),
}


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('case', sorted(RING_CASES))
def test_ring_gradients_match_reference(case, causal):
    axes, shape = RING_CASES[case]
    jmesh, mesh = _meshes(**axes)
    got, want = _grads(
        lambda q, k, v: ring_attention(q, k, v, mesh=mesh,
                                                      causal=causal),
        lambda q, k, v: ref_ring(q, k, v, mesh=jmesh,
                                                causal=causal),
        _qkv(*shape, seed=len(case) + causal))
    _assert_close(got, want)


ULYSSES_CASES = {
    'data2-seq2-tensor2': (dict(data=2, sequence=2, tensor=2),
                           (2, 4, 4, 64, 16)),
    'seq2': (dict(data=1, sequence=2), (1, 4, 4, 64, 16)),
    'seq4-gqa': (dict(data=2, sequence=4), (2, 8, 4, 128, 16)),
    'seq4-gqa-broadcast': (dict(data=1, sequence=4), (1, 4, 2, 64, 16)),
}


@pytest.mark.parametrize('case', sorted(ULYSSES_CASES))
def test_ulysses_gradients_match_reference(case):
    axes, shape = ULYSSES_CASES[case]
    jmesh, mesh = _meshes(**axes)
    got, want = _grads(
        lambda q, k, v: ulysses_attention(q, k, v,
                                                            mesh=mesh),
        lambda q, k, v: ref_uly(q, k, v, mesh=jmesh),
        _qkv(*shape, seed=len(case)))
    _assert_close(got, want)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('h_kv', [4, 2])
def test_lse_cotangent_matches_reference(h_kv, causal):
    """A loss that reads the lse: what the ring's merge feeds each hop."""
    arrays = _qkv(2, 4, h_kv, 80, 16, seed=h_kv + 10 * causal)
    w = np.random.default_rng(3).standard_normal((2, 4, 80)).astype(
        np.float32)

    def ref_loss(q, k, v):
        out, lse = ref_fa(q, k, v,
                                                          causal=causal)
        return jnp.sum(out ** 2) + jnp.sum(lse * w)
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, lse = flash_attention_with_lse(*leaves, causal=causal)
    ((out ** 2).sum() + (lse * torch.tensor(w)).sum()).backward()
    _assert_close([t.grad.numpy() for t in leaves],
                  [np.asarray(g) for g in want])


def test_ring_merge_gradient_is_finite_for_masked_rows():
    """The merge starts from lse = NEG_INF (finite): with every hop's
    rows fully masked but the diagonal's, no NaN reaches a gradient."""
    _, mesh = _meshes(data=1, sequence=4)
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv(1, 2, 2, 8, 16, seed=5))
    out = ring_attention(q * 1e3, k, v, mesh=mesh)
    out.sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
