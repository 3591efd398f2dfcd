"""The port's streaming and fused cross-entropy against
`skypilot_tpu/models/losses.py`, on the CPU.

Logits, hidden states, kernels, targets and masks come from numpy with
a seed; the vocab (100) is not a multiple of the chunk (32), so the
ragged tail runs.  Values and gradients within 1e-5 absolute and
relative: f32 on both sides, summed in different orders.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import losses as jax_losses
from skypilot_tpu.models import train as jax_train
from skypilot_tpu_torch.models import losses
from skypilot_tpu_torch.models import train

ATOL = RTOL = 1e-5
B, S, D, V, CHUNK = 2, 5, 8, 100, 32


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    kernel = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    logits = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    targets[0, 0] = V - 1          # a target in the ragged tail
    mask = (rng.random((B, S)) > 0.3).astype(np.float32) if masked else None
    return hidden, kernel, logits, targets, mask


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.tensor(x)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('reduction', ['mean', 'sum'])
@pytest.mark.parametrize('masked', [False, True], ids=['unmasked', 'mask'])
def test_streaming_matches_reference(masked, reduction):
    _, _, logits, targets, mask = _inputs(1, masked)
    ref, ref_g = jax.value_and_grad(
        lambda lg: jax_losses.streaming_cross_entropy(
            lg, _j(targets), _j(mask), vocab_chunk=CHUNK,
            reduction=reduction))(jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    got = losses.streaming_cross_entropy(tl, _t(targets), _t(mask),
                                         vocab_chunk=CHUNK,
                                         reduction=reduction)
    got.backward()
    _close(got, ref)
    _close(tl.grad, ref_g)


@pytest.mark.parametrize('tied', [False, True], ids=['head', 'tied'])
@pytest.mark.parametrize('reduction', ['mean', 'sum'])
@pytest.mark.parametrize('masked', [False, True], ids=['unmasked', 'mask'])
def test_fused_matches_reference(masked, reduction, tied):
    hidden, kernel, _, targets, mask = _inputs(2, masked)
    ref, (ref_gh, ref_gk) = jax.value_and_grad(
        lambda h, w: jax_losses.fused_linear_cross_entropy(
            h, w, _j(targets), _j(mask), vocab_chunk=CHUNK,
            reduction=reduction), argnums=(0, 1))(
                jnp.asarray(hidden), jnp.asarray(kernel))
    th = torch.tensor(hidden, requires_grad=True)
    # Tied embeddings hand in the embedding's transpose (a strided view).
    leaf = torch.tensor(kernel.T.copy() if tied else kernel,
                        requires_grad=True)
    tk = leaf.t() if tied else leaf
    got = losses.fused_linear_cross_entropy(th, tk, _t(targets), _t(mask),
                                            vocab_chunk=CHUNK,
                                            reduction=reduction)
    got.backward()
    _close(got, ref)
    _close(th.grad, ref_gh)
    _close(leaf.grad.t() if tied else leaf.grad, ref_gk)


@pytest.mark.parametrize('masked', [False, True], ids=['unmasked', 'mask'])
def test_loss_fn_matches_reference_and_fused(masked):
    hidden, kernel, _, targets, mask = _inputs(3, masked)
    logits = hidden @ kernel
    ref = jax_train.loss_fn(jnp.asarray(logits), _j(targets), _j(mask))
    got = train.loss_fn(torch.tensor(logits), _t(targets), _t(mask))
    _close(got, ref)
    fused = losses.fused_linear_cross_entropy(
        torch.tensor(hidden), torch.tensor(kernel), _t(targets), _t(mask),
        vocab_chunk=CHUNK)
    _close(fused, ref)


def test_bad_reduction_and_kernel_shape_raise():
    hidden, kernel, logits, targets, _ = _inputs(4, False)
    with pytest.raises(ValueError, match='reduction'):
        losses.streaming_cross_entropy(torch.tensor(logits),
                                       torch.tensor(targets),
                                       reduction='max')
    with pytest.raises(ValueError, match='kernel rows'):
        losses.fused_linear_cross_entropy(torch.tensor(hidden),
                                          torch.tensor(kernel.T.copy()),
                                          torch.tensor(targets))
