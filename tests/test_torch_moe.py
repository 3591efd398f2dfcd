"""MoE (`tiny-moe`, f32) in the port against the JAX package, on the CPU.

Inputs come from numpy seeds; the JAX side runs as its own tests run it
on the CPU, its paged path pinned to the Pallas kernel in interpret
mode (SKYTPU_DECODE_KERNEL=pallas).

- `moe.moe_apply` (out and aux), `decode._tp_moe_mlp` over one rank at
  s == 1 (the dense gather) and s > 1 (the capacity dispatch), float
  and int8 stacks, and
  `Transformer.forward` within atol 2e-4 / rtol 2e-3 of the JAX
  functions; one moe_apply case where the reference drops tokens past
  an expert's capacity (asserted), one where it drops none.
- Greedy tokens byte-equal to the JAX engine: paged, dense, legacy,
  int8 KV, int8 weights (`quantize_params`) and spec_tokens=2, on a
  burst that mixes active and inactive slots, a one-token prompt and a
  max_new_tokens=1 request (finished from the prefill's logits).
- No prefix reuse (pages still pool); KV handoff refused.
- A tiny Mixtral HF source converted by both importers serves the same
  tokens through `ModelServer('auto')`, plain and int8.
- `tiny-moe` serves over both HTTP fronts and statically, with the
  tokens of `decode.generate`.
- The port's trainer on tiny-moe against the JAX trainer (the
  tolerance of tests/test_torch_train.py).
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.models import quantize as jax_quantize
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import batching_engine as jax_engine
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.serve import async_server
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import model_server

TOL = dict(atol=2e-4, rtol=2e-3)
# (prompt, max_new_tokens): a one-token prompt, and one request that
# ends with the token its prefill selects.
REQUESTS = (([3, 1, 4, 1, 5, 9, 2, 6], 6),
            ([7], 4),
            ([2, 7, 1, 8, 2, 8, 1], 1),
            (list(range(5, 18)), 5),
            (list(range(1, 25)), 7))
PAGED = dict(kv_pages=48, page_size=8)
# mode -> (engine kwargs, int8 weights)
MODES = {'paged': (PAGED, False),
         'dense': ({}, False),
         'legacy': ({'pipelined': False}, False),
         'int8_kv': (dict(PAGED, quantize_kv=True), False),
         'int8_weights': (PAGED, True),
         'spec': (dict(PAGED, spec_tokens=2), False)}


@contextlib.contextmanager
def _pallas_env():
    saved = {k: os.environ.get(k) for k in
             ('SKYTPU_DECODE_KERNEL', 'SKYTPU_PALLAS_INTERPRET')}
    os.environ['SKYTPU_DECODE_KERNEL'] = 'pallas'
    os.environ['SKYTPU_PALLAS_INTERPRET'] = '1'
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@functools.lru_cache(maxsize=None)
def _jax_params(quantized: bool = False):
    """The reference's tiny-moe init (numpy leaves), int8 through its
    quantize_params."""
    params = nn.meta.unbox(JaxTransformer(jax_configs.get_config(
        'tiny-moe')).init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))['params'])
    if quantized:
        params = jax_quantize.quantize_params(params)
    return jax.tree.map(np.asarray, params)


def _port_model(quantized: bool = False):
    return convert.from_jax_params(configs.get_config('tiny-moe'),
                                   _jax_params(quantized), device='cpu')


def _jax_dropped(logits: np.ndarray, cfg) -> int:
    """Assignments the reference's dispatch drops: its top-k choices per
    expert past the capacity it computes."""
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.expert_top_k)
    counts = np.bincount(np.asarray(idx).reshape(-1),
                         minlength=cfg.n_experts)
    cap = max(1, int(cfg.expert_capacity_factor * logits.shape[0] *
                     cfg.expert_top_k / cfg.n_experts))
    return int(np.maximum(counts - cap, 0).sum())


# ------------------------------------------------------------ the math


@pytest.mark.parametrize('case', ['no_drop', 'drop'])
def test_moe_apply_matches_jax(case):
    overrides = ({'expert_capacity_factor': 4.0} if case == 'no_drop'
                 else {})
    jcfg = jax_configs.get_config('tiny-moe', **overrides)
    tcfg = configs.get_config('tiny-moe', **overrides)
    rng = np.random.RandomState(7)
    n, d, e, f = 24, tcfg.d_model, tcfg.n_experts, tcfg.d_ff
    tokens = rng.randn(n, d).astype(np.float32)
    logits = rng.randn(n, e).astype(np.float32)
    if case == 'drop':
        logits[:, 0] += 2.0      # expert 0 is chosen past its capacity
    stacks = [(rng.randn(*shape) * 0.1).astype(np.float32)
              for shape in ((e, d, f), (e, d, f), (e, f, d))]
    dropped = _jax_dropped(logits, jcfg)
    assert (dropped == 0) if case == 'no_drop' else (dropped >= 1)
    assert moe.dropped_tokens(torch.from_numpy(logits), tcfg) == dropped
    jout, jaux = jax_moe.moe_apply(
        *[jnp.asarray(a) for a in (tokens, logits, *stacks)], jcfg)
    tout, taux = moe.moe_apply(
        *[torch.from_numpy(a) for a in (tokens, logits, *stacks)], tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_top_k_breaks_ties_as_jax():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.5, 0.2, 0.5, 0.1],
                      [0.25, 0.25, 0.25, 0.25]], np.float32)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    tvals, tidx = moe.top_k(torch.from_numpy(probs), 2)
    assert tidx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize('quantized', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('s', [1, 5])
def test_moe_mlp_matches_jax(s, quantized):
    jcfg = jax_configs.get_config('tiny-moe')
    params = _jax_params(quantized)
    mp = jax.tree.map(lambda a: a[0],
                      params['layers']['layer']['moe_mlp'])
    x = np.random.RandomState(s).randn(3, s, jcfg.d_model).astype(
        np.float32)
    want = jax_decode._moe_mlp(jnp.asarray(x), mp, jcfg)  # pylint: disable=protected-access
    model = _port_model(quantized)
    got = decode._tp_moe_mlp(  # pylint: disable=protected-access
        model.cfg, [model.layers[0].moe_mlp], [torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_jax():
    jcfg = jax_configs.get_config('tiny-moe')
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    params = _jax_params()
    want = JaxTransformer(jcfg).apply({'params': params},
                                      jnp.asarray(tokens))
    with torch.no_grad():
        got = _port_model()(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------- the engine


def _burst(engine):
    """REQUESTS submitted at once to a 3-slot engine: the first
    admission takes three of them (one ends there), the others join as
    slots free.  Returns every request's tokens; stops the engine."""
    try:
        # The queue's (re-entrant) lock held: the worker pops nothing
        # until every request is queued.  (The reference's legacy loop
        # runs no host ops, so a host op that waits cannot hold it.)
        with engine._cond:  # pylint: disable=protected-access
            handles = [engine.submit(p, n) for p, n in REQUESTS]
        out = [list(h.result(timeout=300)) for h in handles]
        assert engine.stats()['failed'] is False
        return out, engine.stats()
    finally:
        engine.stop()


@pytest.fixture(scope='module')
def jax_tokens():
    jcfg = jax_configs.get_config('tiny-moe')
    out = {}
    with _pallas_env():
        for mode, (kw, quantized) in MODES.items():
            engine = jax_engine.ContinuousBatchingEngine(
                jcfg, jax.tree.map(jnp.asarray, _jax_params(quantized)),
                max_len=64, slots=3, prefill_chunk=8, **kw)
            out[mode] = _burst(engine)[0]
    return out


@pytest.mark.parametrize('mode', list(MODES))
def test_greedy_tokens_equal_jax_engine(jax_tokens, mode):
    kw, quantized = MODES[mode]
    model = _port_model(quantized)
    engine = batching_engine.ContinuousBatchingEngine(
        model.cfg, model, max_len=64, slots=3, prefill_chunk=8,
        device='cpu', **kw)
    got, stats = _burst(engine)
    assert got == jax_tokens[mode]
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    if 'kv_pages' in kw:
        assert stats['prefix_cache_entries'] == 0
        assert stats['kv_pages_used'] == 0      # every page came back
    if kw.get('spec_tokens'):
        assert stats['spec_ticks'] > 0


def test_no_prefix_reuse_and_no_handoff():
    model = _port_model()
    engine = batching_engine.ContinuousBatchingEngine(
        model.cfg, model, max_len=64, slots=2, device='cpu', **PAGED)
    try:
        prompt = list(range(30, 50))
        first = engine.generate(prompt, 4)
        assert engine.generate(prompt, 4) == first
        stats = engine.stats()
        assert stats['prefix_cache_entries'] == 0
        assert stats['prefix_cache_hits'] == 0
        with pytest.raises(batching_engine.HandoffError, match='MoE'):
            engine.export_prefill(prompt)
        pages = np.zeros((2, 1, 2, 8, 16), np.float32)
        with pytest.raises(batching_engine.HandoffError, match='MoE'):
            engine.import_pages([1], 8, pages, pages)
    finally:
        engine.stop()


# ------------------------------------------------------------ serving


def _post(port, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate',
        data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())['tokens']


@pytest.mark.parametrize('front', ['threaded', 'async', 'static'])
def test_tiny_moe_serves_like_generate(front):
    """`--model tiny-moe`: each front (and the static server without an
    engine) answers /generate with decode.generate's greedy tokens."""
    server = model_server.ModelServer(
        'tiny-moe', device='cpu', max_len=64, max_batch=2,
        continuous_batching=front != 'static', kv_pages=32, page_size=8)
    start = (async_server.start_background if front == 'async'
             else model_server.start_background)
    port, stop = start(server)
    try:
        prompt = [[5, 6, 7, 8, 9, 10, 11]]
        got = _post(port, {'prompt_ids': prompt, 'max_new_tokens': 6})
        _, want = decode.generate(server.cfg, server.params,
                                  torch.tensor(prompt), max_new_tokens=6,
                                  max_len=64)
        assert got == want.tolist()
    finally:
        stop()
        server.close()


@pytest.fixture(scope='module')
def mixtral_source(tmp_path_factory):
    """A tiny HF Mixtral converted by the port's and the reference's
    importers, both set to f32 compute."""
    transformers = pytest.importorskip('transformers')
    from skypilot_tpu.models import import_weights as ref_iw
    from skypilot_tpu_torch.models import import_weights
    root = tmp_path_factory.mktemp('mixtral')
    src = root / 'hf'
    torch.manual_seed(0)
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, tie_word_embeddings=False)
    transformers.MixtralForCausalLM(cfg).eval().save_pretrained(
        src, safe_serialization=True)
    (src / 'config.json').write_text(json.dumps(cfg.to_dict()))
    for name, fn in (('port', import_weights.convert),
                     ('reference', ref_iw.convert)):
        fn(str(src), str(root / name))
        path = root / name / 'model_config.json'
        d = json.loads(path.read_text())
        d['dtype'] = 'float32'
        path.write_text(json.dumps(d))
    return root


@pytest.mark.parametrize('quantize', [None, 'int8'], ids=['f32', 'int8'])
def test_mixtral_checkpoint_serves_like_reference(mixtral_source, quantize):
    from skypilot_tpu.serve import model_server as ref_server
    kw = dict(max_len=64, max_batch=2, continuous_batching=True,
              kv_pages=32, page_size=8, quantize=quantize)
    prompts = [[[3, 1, 4, 1, 5, 9, 2]], [[7]]]
    ours = model_server.ModelServer(
        'auto', checkpoint_dir=str(mixtral_source / 'port'), device='cpu',
        **kw)
    try:
        assert ours.cfg.n_experts == 4 and ours.params.quantized == bool(
            quantize)
        got = [ours.generate(p, 6) for p in prompts]
    finally:
        ours.close()
    with _pallas_env():
        ref = ref_server.ModelServer(
            'auto', checkpoint_dir=str(mixtral_source / 'reference'), **kw)
        try:
            want = [ref.generate(p, 6) for p in prompts]
        finally:
            ref.close()
    assert got == [[list(r) for r in w] for w in want]


# ------------------------------------------------------------ training


def test_train_steps_match_reference():
    jcfg = jax_configs.get_config('tiny-moe')
    params0 = _jax_params()
    jtcfg = jax_train.TrainConfig()
    jstate = jax_train.TrainState.create(
        apply_fn=JaxTransformer(jcfg).apply, params=params0,
        tx=jax_train.make_optimizer(jtcfg))
    tcfg = train.TrainConfig()
    model = convert.from_jax_params(configs.get_config('tiny-moe'), params0,
                                    device='cpu', trainable=True)
    state = train.TrainState(
        step=0, model=model, optimizer=train.make_optimizer(
            model.parameters(), tcfg), grad_clip=tcfg.grad_clip)
    jstep = jax.jit(functools.partial(jax_train.train_step, tcfg=jtcfg))
    rng = np.random.default_rng(11)
    for i in range(3):
        batch = {'tokens': rng.integers(0, 256, (4, 13)).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = train.train_step(
            state, {k: torch.tensor(v) for k, v in batch.items()}, tcfg)
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f'step {i} {key}')
