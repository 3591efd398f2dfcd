"""The port's paged continuous-batching engine and HTTP front, on the CPU.

- Greedy output is byte-identical to the JAX engine (pinned to its
  paged-kernel path in interpret mode) for paged, int8, speculative and
  prefix-hit runs, on misaligned prompt lengths.
- Seeded sampling is deterministic within the port, and speculative
  decoding does not change it.
- ModelServer's HTTP contract: /health and /generate, 400 on a bad body.
"""
from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import batching_engine as jax_engine
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import model_server

# Misaligned on purpose against page 8 / chunk 8; 24 spans three pages;
# a one-token prompt is the empty-prefill edge.
PROMPTS = (([3, 1, 4, 1, 5, 9, 2, 6], 6),
           ([7], 4),
           ([2, 7, 1, 8, 2, 8, 1], 7),
           (list(range(5, 18)), 5),
           (list(range(1, 25)), 5))
# Prefix-cache pair: the second prompt shares the first's two full
# prefilled pages (16 tokens) and diverges after.
SHARED = list(range(30, 46))
PREFIX_PROMPTS = ((SHARED + [1, 2, 3, 4], 5), (SHARED + [9, 8, 7], 6))
ENGINE_KW = dict(max_len=64, slots=2, prefill_chunk=8, kv_pages=48,
                 page_size=8)


@pytest.fixture(scope='module')
def setup():
    jcfg = jax_configs.get_config('tiny')
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    tcfg = configs.get_config('tiny')
    model = convert.from_jax_params(
        tcfg, jax.tree.map(np.asarray, params), device='cpu')
    return jcfg, params, tcfg, model


def _jax_outputs(jcfg, params, quantize_kv):
    """Greedy tokens of the JAX engine on its paged-kernel path."""
    saved = {k: os.environ.get(k) for k in
             ('SKYTPU_DECODE_KERNEL', 'SKYTPU_PALLAS_INTERPRET')}
    os.environ['SKYTPU_DECODE_KERNEL'] = 'pallas'
    os.environ['SKYTPU_PALLAS_INTERPRET'] = '1'
    try:
        engine = jax_engine.ContinuousBatchingEngine(
            jcfg, params, quantize_kv=quantize_kv, **ENGINE_KW)
        try:
            assert engine.decode_kernel == 'pallas'
            plain = [engine.generate(p, n) for p, n in PROMPTS]
            prefix = [engine.generate(p, n) for p, n in PREFIX_PROMPTS]
            assert engine.stats()['prefix_cache_hits'] >= 2
        finally:
            engine.stop()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return plain, prefix


@pytest.fixture(scope='module')
def jax_ref(setup):
    jcfg, params, _, _ = setup
    return {False: _jax_outputs(jcfg, params, False),
            True: _jax_outputs(jcfg, params, True)}


def _port_outputs(tcfg, model, **kw):
    engine = batching_engine.ContinuousBatchingEngine(
        tcfg, model, device='cpu', **ENGINE_KW, **kw)
    try:
        plain = [engine.generate(p, n) for p, n in PROMPTS]
        prefix = [engine.generate(p, n) for p, n in PREFIX_PROMPTS]
        stats = engine.stats()
    finally:
        engine.stop()
    return plain, prefix, stats


@pytest.mark.parametrize('quantize_kv,spec_tokens', [
    (False, 0), (True, 0), (False, 3), (True, 4)],
    ids=['paged', 'int8', 'spec', 'int8-spec'])
def test_greedy_byte_identical_to_jax_engine(setup, jax_ref, quantize_kv,
                                             spec_tokens):
    _, _, tcfg, model = setup
    plain, prefix, stats = _port_outputs(tcfg, model,
                                         quantize_kv=quantize_kv,
                                         spec_tokens=spec_tokens)
    ref_plain, ref_prefix = jax_ref[quantize_kv]
    assert plain == ref_plain
    assert prefix == ref_prefix
    # The second prefix prompt adopted the first's two cached pages.
    assert stats['prefix_cache_hits'] >= 2
    assert stats['failed'] is False
    assert stats['kv_pages_used'] == stats['kv_pages_pinned']
    if spec_tokens:
        assert stats['spec_ticks'] > 0


def test_concurrent_requests_match_sequential(setup, jax_ref):
    _, _, tcfg, model = setup
    engine = batching_engine.ContinuousBatchingEngine(
        tcfg, model, device='cpu', **ENGINE_KW)
    try:
        handles = [engine.submit(p, n) for p, n in PROMPTS]
        got = [h.result(timeout=120) for h in handles]
    finally:
        engine.stop()
    assert got == jax_ref[False][0]


def _sampled(tcfg, model, spec_tokens, seed):
    engine = batching_engine.ContinuousBatchingEngine(
        tcfg, model, device='cpu', spec_tokens=spec_tokens, **ENGINE_KW)
    sampling = decode.SamplingConfig(temperature=0.8, top_k=20, seed=seed)
    try:
        return [engine.generate(p, n + 4, sampling=sampling)
                for p, n in PROMPTS[:3]]
    finally:
        engine.stop()


def test_sampled_seed_deterministic_and_spec_invariant(setup):
    _, _, tcfg, model = setup
    a = _sampled(tcfg, model, 0, seed=5)
    assert a == _sampled(tcfg, model, 0, seed=5)
    assert a == _sampled(tcfg, model, 3, seed=5)
    assert a != _sampled(tcfg, model, 0, seed=6)
    assert all(0 <= t < tcfg.vocab_size for row in a for t in row)


def test_stop_tokens_and_validation(setup):
    _, _, tcfg, model = setup
    engine = batching_engine.ContinuousBatchingEngine(
        tcfg, model, device='cpu', max_queue=4, **ENGINE_KW)
    try:
        full = engine.generate([3, 1, 4, 1, 5], 6)
        stop_at = full[2]
        cut = engine.generate([3, 1, 4, 1, 5], 6, stop_token=[stop_at])
        assert cut == full[:full.index(stop_at) + 1]
        with pytest.raises(ValueError, match='max_len'):
            engine.submit(list(range(60)), 10)
        with pytest.raises(ValueError, match='empty prompt'):
            engine.submit([], 3)
        with pytest.raises(ValueError, match='top_k'):
            engine.submit([1], 3, sampling=decode.SamplingConfig(
                temperature=1.0, top_k=1000))
        with pytest.raises(ValueError, match='prompt ids'):
            engine.submit([tcfg.vocab_size], 3)
        stats = engine.stats()
        assert stats['admitted_requests'] == 2
        assert stats['tokens_generated'] == len(full) + len(cut)
    finally:
        engine.stop()


def test_queue_full_is_backpressure(setup):
    _, _, tcfg, model = setup
    queue = batching_engine.scheduler.AdmissionQueue(max_queue=1)
    queue.submit(batching_engine.scheduler.Request([1], 1, None))
    with pytest.raises(batching_engine.QueueFull):
        queue.submit(batching_engine.scheduler.Request([1], 1, None))
    assert queue.stats()['queue_full_rejections'] == 1


# ------------------------------------------------------------------ HTTP


def _post(port, path, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data, method='POST',
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize('continuous', [True, False],
                         ids=['engine', 'dense'])
def test_http_health_and_generate(continuous):
    kw = (dict(continuous_batching=True, kv_pages=32, page_size=8)
          if continuous else {})
    server = model_server.ModelServer('tiny', max_len=64, max_batch=4,
                                      device='cpu', **kw)
    port, stop = model_server.start_background(server)
    try:
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/health',
                                    timeout=30) as resp:
            health = json.loads(resp.read())
            assert resp.status == 200
        assert health['status'] == 'ok'
        assert health['device'] == 'cpu'
        assert ('engine' in health) == continuous
        code, out = _post(port, '/generate', {
            'prompt_ids': [[1, 2, 3, 4], [5, 6, 7, 8]],
            'max_new_tokens': 5})
        assert code == 200
        assert [len(t) for t in out['tokens']] == [5, 5]
        assert all(0 <= t < 256 for row in out['tokens'] for t in row)
        assert out['weight_version'] == 0 and out['latency_ms'] >= 0
        code, again = _post(port, '/generate', {
            'prompt_ids': [[1, 2, 3, 4]], 'max_new_tokens': 5,
            'temperature': 0.7, 'top_k': 5, 'seed': 3})
        assert code == 200 and len(again['tokens'][0]) == 5
        assert _post(port, '/generate', {'prompt_ids': [[1, 2, 3, 4]],
                                          'max_new_tokens': 5, 'seed': 3,
                                          'temperature': 0.7,
                                          'top_k': 5})[1]['tokens'] == \
            again['tokens']
        for bad in ({'max_new_tokens': 5},               # no prompt_ids
                    {'prompt_ids': 'abc'},
                    {'prompt_ids': [[1, 2], [3]]},       # ragged
                    {'prompt_ids': [[1]], 'max_new_tokens': 500}):
            code, err = _post(port, '/generate', bad)
            assert code == 400, bad
            assert 'error' in err
        assert _post(port, '/generate', None, raw=b'{not json')[0] == 400
        assert _post(port, '/nope', {})[0] == 404
    finally:
        stop()
        server.close()


# --------------------------------------------- host-side pieces vs JAX


def test_page_manager_matches_reference():
    from skypilot_tpu.serve import cache_manager as jax_cm
    from skypilot_tpu_torch.serve import cache_manager
    ours = cache_manager.PagedKVManager(12, 4)
    ref = jax_cm.PagedKVManager(12, 4, slots=2)
    prompts = [(list(range(10)), 3), (list(range(9)) + [50], 2),
               ([7, 7, 7], 5)]
    for slot, (prompt, new) in enumerate(prompts[:2]):
        a = ours.plan_admission(prompt, new)
        b = ref.plan_admission(prompt, new)
        assert (a.row, a.reuse_pages, a.n_reuse_tokens, a.page_hashes) == \
            (b.row, b.reuse_pages, b.n_reuse_tokens, b.page_hashes)
        ours.commit(slot, a)
        ref.commit(slot, b)
        ours.register_prefix(a)
        ref.register_prefix(b)
    # The second prompt hit the first's two registered full pages.
    assert ours.stats()['prefix_cache_hits'] == 2
    ours.release(0)
    ref.release(0)
    with pytest.raises(cache_manager.PagesExhausted):
        ours.plan_admission(list(range(100, 140)), 1)
    with pytest.raises(jax_cm.PagesExhausted):
        ref.plan_admission(list(range(100, 140)), 1)
    for name in ('kv_pages_used', 'kv_pages_free', 'kv_pages_pinned',
                 'prefix_cache_entries', 'prefix_cache_hits'):
        assert ours.stats()[name] == ref.stats()[name], name
    # Eviction under pressure frees idle pinned prefix pages.
    c = ours.plan_admission(*prompts[2])
    assert len(c.row) == ours.pages_needed(3, 5)
    ours.commit(0, c)
    ours.release_all()
    assert ours.pool.used_count == 0 and len(ours.prefix) == 0


def test_page_pool_refcounts_pins_cow():
    from skypilot_tpu_torch.serve import cache_manager
    pool = cache_manager.PagePool(4, 8)
    assert pool.capacity == 3
    pages = pool.alloc(2)
    assert cache_manager.NULL_PAGE not in pages
    assert pool.cow(pages[0]) == (pages[0], False)   # private: as-is
    pool.incref([pages[0]])
    fresh, copy = pool.cow(pages[0])                 # shared: fresh page
    assert copy and fresh not in pages and pool.refcount(pages[0]) == 1
    pool.pin(pages[1])
    pool.decref([pages[1]])
    assert pool.pinned_count == 1 and pool.free_count == 0
    pool.unpin(pages[1])
    assert pool.free_count == 1
    with pytest.raises(ValueError):
        pool.decref([pages[1]])
    with pytest.raises(cache_manager.PagesExhausted):
        pool.alloc(2)
    with pytest.raises(ValueError):
        cache_manager.PagePool(1, 8)


def test_byte_tokenizer_and_stream_decoder_match_reference():
    from skypilot_tpu.models import tokenizer as jax_tok
    from skypilot_tpu_torch.models import tokenizer
    text = 'héllo → wörld ✓'
    ours, ref = tokenizer.load_tokenizer(None), jax_tok.ByteTokenizer()
    ids = ours.encode(text)
    assert ids == ref.encode(text) and ours.decode(ids) == text
    assert ours.eos_ids == ref.eos_ids == frozenset({0})
    a, b = tokenizer.StreamDecoder(ours), jax_tok.StreamDecoder(ref)
    deltas = [a.push(t) for t in ids]
    assert deltas == [b.push(t) for t in ids]
    assert ''.join(deltas) + a.finish() == text
    # A path with no tokenizer files: the byte fallback, as the
    # reference (checkpoint tokenizers: tests/test_torch_tokenizer.py).
    assert isinstance(tokenizer.load_tokenizer('/nonexistent'),
                      tokenizer.ByteTokenizer)
    assert isinstance(jax_tok.load_tokenizer('/nonexistent'),
                      jax_tok.ByteTokenizer)


def test_request_stream_and_deadline(setup):
    _, _, tcfg, model = setup
    engine = batching_engine.ContinuousBatchingEngine(
        tcfg, model, device='cpu', **ENGINE_KW)
    try:
        request = engine.submit([3, 1, 4], 5)
        assert list(request.stream(timeout=60)) == request.result()
        assert len(request.tokens) == 5 and request.ttft_s >= 0
        late = engine.submit([3, 1, 4], 5, deadline_ms=1e-6)
        with pytest.raises(batching_engine.DeadlineExceeded):
            late.result(timeout=60)
    finally:
        engine.stop()
    with pytest.raises(RuntimeError, match='stopped'):
        engine.submit([1], 1)
