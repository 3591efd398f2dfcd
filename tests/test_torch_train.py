"""The port's training path against `skypilot_tpu/models/train.py`, on
the CPU.

Both sides start from the reference's initial parameters (carried over
with `convert.from_jax_params(..., trainable=True)`) and take three
steps on the same numpy batches, for tiny, tiny-gemma and tiny-qwen and
three TrainConfigs: plain ({'tokens'} batches), fused CE and
accum_steps=2 (both with {'inputs', 'targets', 'mask'}).  The reference
runs its CPU path (jit, blockwise attention and its autodiff); the
flash backward's Pallas parity is tests/test_torch_ops.py's.

Tolerances (f32 on both sides, summed in different orders):
- loss and grad_norm of every step: rtol 1e-5;
- the clipped gradients of step 1: atol 1e-5 / rtol 1e-4;
- parameters after 3 steps: atol 2 * lr * 3.  Adam's first updates are
  about lr * sign(g) per step, so a near-zero gradient whose sign
  differs between the two sides moves a parameter by up to 2 * lr per
  step; the bound is that noise, not a loosened check.
"""
from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu_torch import train_llama
from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.models.transformer import init_params

PRESETS = ('tiny', 'tiny-gemma', 'tiny-qwen')
TRAIN_CONFIGS = {'plain': {}, 'fused': {'fused_ce': True, 'vocab_chunk': 96},
                 'accum': {'accum_steps': 2}}
B, S, STEPS = 4, 12, 3


def _batches(name: str, masked: bool):
    rng = np.random.default_rng(sum(map(ord, name)))
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
        if not masked:
            out.append({'tokens': tokens})
            continue
        mask = (rng.random((B, S)) > 0.25).astype(np.float32)
        out.append({'inputs': tokens[:, :-1], 'targets': tokens[:, 1:],
                    'mask': mask})
    return out


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, ref, **tol):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for key, leaf in ref.items():
        np.testing.assert_allclose(got[key], leaf, err_msg=key, **tol)


def _grad_tree(model):
    """The model's .grad leaves in the reference tree layout."""
    shadow = convert.from_jax_params(model.cfg, convert.to_jax_params(model),
                                     device='cpu', trainable=True)
    with torch.no_grad():
        for p, g in zip(shadow.parameters(), model.parameters()):
            p.copy_(g.grad)
    return convert.to_jax_params(shadow)


@functools.lru_cache(maxsize=None)
def _jax_params(name: str):
    """The reference's initial parameters (numpy leaves)."""
    params = JaxTransformer(jax_configs.get_config(name)).init(
        jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))['params']
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _jax_step1_grads(jcfg, params, batch, grad_clip):
    """Reference gradients of the step-1 loss, clipped as optax does."""
    if 'tokens' in batch:
        inputs, targets = batch['tokens'][:, :-1], batch['tokens'][:, 1:]
    else:
        inputs, targets = batch['inputs'], batch['targets']
    model = JaxTransformer(jcfg)

    @jax.jit
    def clipped_grads(p, inputs, targets, mask):
        grads = jax.grad(lambda p: jax_train.loss_fn(
            model.apply({'params': p}, inputs), targets, mask))(p)
        norm = optax.global_norm(grads)
        scale = jnp.where(norm < grad_clip, 1.0, grad_clip / norm)
        return jax.tree.map(lambda g: g * scale, grads)
    return clipped_grads(params, inputs, targets, batch.get('mask'))


@pytest.mark.parametrize('tc', sorted(TRAIN_CONFIGS))
@pytest.mark.parametrize('name', PRESETS)
def test_train_steps_match_reference(name, tc):
    kw = TRAIN_CONFIGS[tc]
    jcfg = jax_configs.get_config(name)
    jtcfg = jax_train.TrainConfig(**kw)
    params0 = _jax_params(name)
    jstate = jax_train.TrainState.create(
        apply_fn=JaxTransformer(jcfg).apply, params=params0,
        tx=jax_train.make_optimizer(jtcfg))
    tcfg = train.TrainConfig(**kw)
    model = convert.from_jax_params(configs.get_config(name), params0,
                                    device='cpu', trainable=True)
    state = train.TrainState(
        step=0, model=model, optimizer=train.make_optimizer(
            model.parameters(), tcfg), grad_clip=tcfg.grad_clip)
    jstep = jax.jit(functools.partial(jax_train.train_step, tcfg=jtcfg))
    batches = _batches(name, masked=tc != 'plain')
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = train.train_step(
            state, {k: torch.tensor(v) for k, v in batch.items()}, tcfg)
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f'step {i} {key}')
        if i == 0:
            _assert_trees_close(
                _grad_tree(model),
                _jax_step1_grads(jcfg, params0, batch, tcfg.grad_clip),
                atol=1e-5, rtol=1e-4)
    assert state.step == STEPS
    _assert_trees_close(convert.to_jax_params(model), jstate.params,
                        atol=2 * tcfg.learning_rate * STEPS, rtol=0)


@pytest.mark.parametrize('name', ['tiny', 'tiny-gemma'])
def test_return_hidden_matches_reference(name):
    jcfg = jax_configs.get_config(name)
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))['params'])
    model = convert.from_jax_params(configs.get_config(name),
                                    jax.tree.map(np.asarray, params),
                                    device='cpu', trainable=True)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 9))
    jh, jk = JaxTransformer(jcfg).apply({'params': params},
                                        jnp.asarray(tokens),
                                        return_hidden=True)
    th, tk = model(torch.tensor(tokens), return_hidden=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk))


def _grads_with_remat(remat: bool, policy: str):
    cfg = configs.get_config('tiny', remat=remat, remat_policy=policy)
    model = init_params(cfg, seed=3, device='cpu', trainable=True)
    tokens = torch.tensor(np.random.default_rng(6).integers(0, 256, (2, 17)))
    train.loss_fn(model(tokens[:, :-1]), tokens[:, 1:]).backward()
    return [p.grad for p in model.parameters()]


def test_remat_policies_give_equal_gradients():
    """Rematerialisation replays the same ops on the same inputs, so
    'full', 'dots' and no remat give the same bits."""
    ref = _grads_with_remat(False, 'full')
    for policy in ('full', 'dots'):
        for got, want in zip(_grads_with_remat(True, policy), ref):
            assert torch.equal(got, want), policy
    with pytest.raises(ValueError, match='remat_policy'):
        _grads_with_remat(True, 'bogus')


def test_trainable_storage():
    cfg = configs.get_config('tiny', dtype=torch.bfloat16)
    serving = init_params(cfg, seed=0, device='cpu')
    trainable = init_params(cfg, seed=0, device='cpu', trainable=True)
    assert serving.layers[0].mlp.up_proj.kernel.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serving.parameters())
    for p in trainable.parameters():
        assert p.dtype == cfg.param_dtype and p.requires_grad
    # The same draws, stored at two precisions.
    torch.testing.assert_close(
        trainable.layers[0].mlp.up_proj.kernel.to(torch.bfloat16),
        serving.layers[0].mlp.up_proj.kernel, atol=0, rtol=0)


def test_cli_loss_falls_on_the_repeated_batch(capsys, monkeypatch,
                                              tmp_path):
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path))
    monkeypatch.setattr(callbacks, '_instance', None)
    history = train_llama.main(['--model', 'tiny', '--device', 'cpu',
                                '--steps', '12', '--batch-size', '4',
                                '--seq-len', '16', '--fused-ce',
                                '--accum-steps', '2', '--vocab-chunk',
                                '100'])
    losses = [h['loss'] for h in history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5
    out = capsys.readouterr().out
    assert 'step 0: loss=' in out and 'step 11: loss=' in out


@pytest.mark.parametrize('flags', [['--fsdp', '2'], ['--tensor', '2'],
                                   ['--sequence', '2'], ['--preflight']])
def test_cli_refuses_later_slice_flags(flags):
    with pytest.raises(NotImplementedError, match='later slice'):
        train_llama.main(['--device', 'cpu', '--steps', '1', *flags])


def test_create_train_state_device_and_mesh(monkeypatch):
    cfg = configs.get_config('tiny')
    with pytest.raises(NotImplementedError, match='later slice'):
        train.create_train_state(cfg, device='cpu', mesh=object())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train.create_train_state(cfg)
    state, shardings = train.create_train_state(cfg, device='cpu')
    assert shardings is None and state.step == 0
    assert train.peak_memory_bytes('cpu') is None
