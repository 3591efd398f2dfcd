"""The port's dense serving mode (slot cache) and legacy loop, on the CPU.

- Greedy output is byte-identical to the JAX engine at kv_pages=None,
  pipelined and with pipelined=False, on misaligned prompt lengths, with
  a prefill chunk that does not divide max_len, and for concurrent
  requests against sequential ones.
- A slot that finishes exactly at max_len while another slot keeps
  decoding: the frozen slot's writes neither raise nor touch the live
  slot (the reference's dynamic_update_slice clamps them).
- `batched_step` logits within atol 2e-4 / rtol 2e-3 of JAX's,
  `insert_prefill` exactly, and the engine's validation errors.
"""
from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import batching_engine as jax_engine
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.serve import batching_engine

# Misaligned against chunk 8; a one-token prompt is the empty-prefill
# edge; the 62-token prompt fills the window (62 + 2 = max_len).
PROMPTS = (([3, 1, 4, 1, 5, 9, 2, 6], 6),
           ([7], 4),
           ([2, 7, 1, 8, 2, 8, 1], 7),
           (list(range(5, 18)), 5),
           (list(range(1, 25)), 5),
           (list(range(1, 63)), 2))
MAX_LEN = 64
# name -> (pipelined, prefill_chunk); 20 does not divide max_len 64, so
# the 62-token prompt's last chunk is cut at max_len - start.
MODES = {'pipelined': (True, 8), 'legacy': (False, 8),
         'chunk20': (True, 20)}


@pytest.fixture(scope='module')
def setup():
    jcfg = jax_configs.get_config('tiny')
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    tcfg = configs.get_config('tiny')
    model = convert.from_jax_params(
        tcfg, jax.tree.map(np.asarray, params), device='cpu')
    return jcfg, params, tcfg, model


def _jax_engine(jcfg, params, pipelined=True, prefill_chunk=8, **kw):
    return jax_engine.ContinuousBatchingEngine(
        jcfg, params, max_len=kw.pop('max_len', MAX_LEN), slots=2,
        prefill_chunk=prefill_chunk, pipelined=pipelined, **kw)


def _port_engine(tcfg, model, pipelined=True, prefill_chunk=8, **kw):
    return batching_engine.ContinuousBatchingEngine(
        tcfg, model, max_len=kw.pop('max_len', MAX_LEN), slots=2,
        prefill_chunk=prefill_chunk, pipelined=pipelined, device='cpu',
        **kw)


def _sequential(engine, prompts):
    try:
        return [engine.generate(p, n, timeout=120) for p, n in prompts]
    finally:
        engine.stop()


@pytest.fixture(scope='module')
def jax_ref(setup):
    jcfg, params, _, _ = setup
    return {name: _sequential(_jax_engine(jcfg, params, *mode), PROMPTS)
            for name, mode in MODES.items()}


@pytest.mark.parametrize('mode', list(MODES))
def test_dense_greedy_byte_identical_to_jax_engine(setup, jax_ref, mode):
    _, _, tcfg, model = setup
    engine = _port_engine(tcfg, model, *MODES[mode])
    stats = engine.stats()
    assert _sequential(engine, PROMPTS) == jax_ref[mode]
    assert stats['decode_kernel'] == 'dense' and not stats['paged']
    assert stats['pipelined'] == MODES[mode][0]
    assert 'kv_pages_total' not in stats


@pytest.mark.parametrize('mode', ['pipelined', 'legacy'])
def test_dense_concurrent_requests_match_sequential(setup, jax_ref, mode):
    _, _, tcfg, model = setup
    engine = _port_engine(tcfg, model, *MODES[mode])
    try:
        handles = [engine.submit(p, n) for p, n in PROMPTS]
        got = [h.result(timeout=120) for h in handles]
        assert engine.stats()['failed'] is False
    finally:
        engine.stop()
    assert got == jax_ref[mode]


@pytest.mark.parametrize('pipelined', [True, False],
                         ids=['pipelined', 'legacy'])
def test_slot_finishing_at_max_len_while_another_decodes(setup, pipelined):
    """Slot A's request uses the whole window (20 + 12 = max_len 32);
    slot B keeps decoding for 14 more ticks.  The legacy loop advances
    A's frozen length past max_len, so its writes land at max_len - 1
    of A's own row; neither engine raises, and both requests equal the
    JAX engine's."""
    jcfg, params, tcfg, model = setup
    pair = ((list(range(40, 60)), 12), ([9, 8, 7], 26))
    ref = _sequential(_jax_engine(jcfg, params, pipelined, max_len=32),
                      pair)
    engine = _port_engine(tcfg, model, pipelined, max_len=32)
    try:
        handles = [engine.submit(p, n) for p, n in pair]
        got = [h.result(timeout=120) for h in handles]
        lengths = engine._cache['lengths'].tolist()  # pylint: disable=protected-access
        assert engine.stats()['failed'] is False
    finally:
        engine.stop()
    assert got == ref
    assert [len(t) for t in got] == [12, 26]
    if not pipelined:
        assert max(lengths) > 32      # a frozen slot ran past max_len


def _slot_caches(tcfg, lengths, seed):
    rng = np.random.default_rng(seed)
    shape = (tcfg.n_layers, len(lengths), tcfg.n_kv_heads, 16,
             tcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    ours = {'k': torch.tensor(k), 'v': torch.tensor(v),
            'lengths': torch.tensor(lens)}
    ref = {'k': jnp.asarray(k), 'v': jnp.asarray(v),
           'lengths': jnp.asarray(lens)}
    return ours, ref


@pytest.mark.parametrize('name', ['tiny', 'tiny-gemma', 'tiny-qwen'])
def test_batched_step_logits_match_jax(name):
    jcfg = jax_configs.get_config(name)
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))['params'])
    tcfg = configs.get_config(name)
    model = convert.from_jax_params(
        tcfg, jax.tree.map(np.asarray, params), device='cpu')
    # Slot 2 sits at max_len 16 and is inactive: its write is clamped.
    ours, ref = _slot_caches(tcfg, [0, 5, 16, 11], seed=3)
    tokens = np.asarray([[3], [17], [0], [250]], np.int32)
    active = np.asarray([True, True, False, True])
    for _ in range(2):
        logits, ours = decode.batched_step(
            tcfg, model, torch.tensor(tokens), ours, torch.tensor(active))
        ref_logits, ref = jax_decode.batched_step(
            jcfg, params, jnp.asarray(tokens), ref, jnp.asarray(active))
        live = active.nonzero()[0]
        np.testing.assert_allclose(logits.numpy()[live],
                                   np.asarray(ref_logits)[live],
                                   atol=2e-4, rtol=2e-3)
        np.testing.assert_array_equal(ours['lengths'].numpy(),
                                      np.asarray(ref['lengths']))
        np.testing.assert_allclose(ours['k'].numpy(), np.asarray(ref['k']),
                                   atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(ours['v'].numpy(), np.asarray(ref['v']),
                                   atol=2e-4, rtol=2e-3)
    # Without `active` every slot advances, as the legacy loop does.
    _, ours = decode.batched_step(tcfg, model, torch.tensor(tokens), ours)
    assert ours['lengths'].tolist() == [3, 8, 17, 14]


def test_engine_step_state_matches_jax(setup):
    jcfg, params, tcfg, model = setup
    ours, ref = _slot_caches(tcfg, [4, 9], seed=5)
    state = decode.init_engine_state(2, device='cpu')
    ref_state = jax_decode.init_engine_state(2)
    for slot, (token, remaining) in enumerate(((11, 3), (40, 1))):
        state = decode.admit_slot_state(state, slot, token, remaining,
                                        [-1] * 16, [slot, 0], 0.0, 0)
        ref_state = jax_decode.admit_slot_state(
            ref_state, slot, token, remaining, [-1] * 16,
            jax.random.PRNGKey(slot), 0.0, 0)
    for _ in range(3):
        state, ours, fin = decode.engine_step(tcfg, model, state, ours)
        ref_state, ref, ref_fin = jax_decode.engine_step(
            jcfg, params, ref_state, ref)
        for key in ('tokens', 'active', 'remaining'):
            np.testing.assert_array_equal(state[key].numpy(),
                                          np.asarray(ref_state[key]), key)
        np.testing.assert_array_equal(fin.numpy(), np.asarray(ref_fin))
        np.testing.assert_array_equal(ours['lengths'].numpy(),
                                      np.asarray(ref['lengths']))


def test_insert_prefill_exact(setup):
    jcfg, params, tcfg, model = setup
    ours, ref = _slot_caches(tcfg, [0, 0, 0], seed=7)
    prompt = np.asarray([[5, 6, 7, 8, 9]], np.int32)
    _, pre = decode.prefill(tcfg, model, torch.tensor(prompt), max_len=16)
    _, ref_pre = jax_decode.prefill(jcfg, params, jnp.asarray(prompt),
                                    max_len=16)
    # The same prefill cache into both: the copy itself is exact.
    pre_np = {k: pre[k].numpy() for k in ('k', 'v')}
    ours = decode.insert_prefill(ours, 1, pre, 4)
    ref = jax_decode.insert_prefill(
        ref, 1, {k: jnp.asarray(v) for k, v in pre_np.items()}, 4)
    for key in ('k', 'v', 'lengths'):
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(ref[key]), key)
    np.testing.assert_allclose(pre_np['k'], np.asarray(ref_pre['k']),
                               atol=2e-4, rtol=2e-3)


def test_dense_validation_errors(setup):
    _, _, tcfg, model = setup
    with pytest.raises(ValueError, match='paged KV engine'):
        _port_engine(tcfg, model, spec_tokens=2)
    with pytest.raises(ValueError, match='pipelined'):
        _port_engine(tcfg, model, pipelined=False, kv_pages=16, page_size=8)
    engine = _port_engine(tcfg, model, pipelined=False)
    try:
        with pytest.raises(ValueError, match='greedy'):
            engine.submit([1, 2], 3, sampling=decode.SamplingConfig(
                temperature=0.7, top_k=5))
        # Greedy sampling configs pass.
        assert len(engine.generate([1, 2], 3, sampling=decode.SamplingConfig(
            temperature=0.0))) == 3
    finally:
        engine.stop()


def test_legacy_mode_rejects_sampling(setup):
    jcfg, params, tcfg, model = setup
    sampling = decode.SamplingConfig(temperature=0.5, top_k=3, seed=1)
    for build, cfg, weights in ((_port_engine, tcfg, model),
                                (_jax_engine, jcfg, params)):
        engine = build(cfg, weights, pipelined=False)
        try:
            with pytest.raises(ValueError, match='greedy'):
                engine.submit([4, 5, 6], 2, sampling=sampling)
        finally:
            engine.stop()


def test_dense_sampled_seed_deterministic(setup):
    _, _, tcfg, model = setup
    sampling = decode.SamplingConfig(temperature=0.8, top_k=20, seed=4)
    runs = []
    for _ in range(2):
        engine = _port_engine(tcfg, model)
        try:
            runs.append([engine.generate(p, n + 3, sampling=sampling)
                         for p, n in PROMPTS[:3]])
        finally:
            engine.stop()
    assert runs[0] == runs[1]
    assert all(0 <= t < tcfg.vocab_size for row in runs[0] for t in row)
