"""KV handoff, streaming routes and live weight swaps of the port, on the
CPU, against the JAX package.

- The wire codec's bytes equal the reference's for the same arrays, and
  each side decodes the other's frames.
- Cross-framework handoff: the JAX engine (paged, its Pallas kernels in
  interpret mode) exports a prompt and the port's engine imports it,
  and the reverse; greedy tokens after the import equal single-replica
  serving on either side, for f32 and int8 pools.  A float payload
  landing in an int8 pool quantizes to JAX's bytes (`write_pages`; in
  the engines, int8 values byte for byte and scales within 1e-6, as
  every pool is pinned).
- Repeat imports dedupe; page-size mismatch, a missing prefix cache
  and pool exhaustion (the 429 class) raise as in the reference.
- HTTP: /prefill_export -> /kv_import between two port servers,
  /prefix_export, /weights_swap, and /generate_stream and
  /generate_text answering the reference server's frames.
- `swap_params` bumps the weight epoch between ticks without dropping
  an in-flight request, and, unlike the reference, no request after a
  swap adopts cached pages the old weights computed.
"""
from __future__ import annotations

import contextlib
import http.client
import json
import os
import threading

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
from skypilot_tpu.serve import handoff as jax_handoff
from skypilot_tpu.serve import model_server as jax_server
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import handoff
from skypilot_tpu_torch.serve import model_server

PROMPT = list(range(1, 42))           # 40 prefilled tokens: 5 full pages
TAIL_PROMPT = list(range(60, 105))    # 44 prefilled: 5 pages + 4 tokens
ENGINE_KW = dict(max_len=64, slots=2, prefill_chunk=16, kv_pages=48,
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


@contextlib.contextmanager
def _pallas():
    """The JAX engine on its paged-kernel path, in interpret mode."""
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


def _engines(setup, framework, quantize_kv, n, **kw):
    jcfg, params, tcfg, model = setup
    args = dict(ENGINE_KW, quantize_kv=quantize_kv, **kw)
    if framework == 'jax':
        return [jax_engine.ContinuousBatchingEngine(jcfg, params, **args)
                for _ in range(n)]
    return [batching_engine.ContinuousBatchingEngine(
        tcfg, model, device='cpu', **args) for _ in range(n)]


def _stop(*engines):
    for engine in engines:
        engine.stop()


def _import(dst, decoded):
    return dst.import_pages(decoded['hashes'], decoded['page_size'],
                            decoded['k'], decoded['v'],
                            k_scale=decoded.get('k_scale'),
                            v_scale=decoded.get('v_scale'))


# ------------------------------------------------------------ the wire


def _arrays(quantized, seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, 3, 2, 8, 4)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        scales = [rng.random(shape[:4]).astype(np.float32) for _ in range(2)]
        return [k, v] + scales
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
def test_wire_bytes_equal_reference(quantized):
    arrays = _arrays(quantized)
    hashes = [11, -22, 2 ** 62]
    ours = handoff.encode_payload(hashes, 8, *arrays)
    ref = jax_handoff.encode_payload(hashes, 8, *arrays)
    assert json.dumps(ours) == json.dumps(ref)
    frame = handoff.encode_binary(hashes, 8, *arrays)
    assert frame == jax_handoff.encode_binary(hashes, 8, *arrays)
    assert frame.startswith(b'SKTH1\n')
    names = ['k', 'v', 'k_scale', 'v_scale'][:len(arrays)]
    for decoded in (handoff.decode_payload(ref),
                    handoff.decode_binary(jax_handoff.encode_binary(
                        hashes, 8, *arrays)),
                    jax_handoff.decode_payload(ours),
                    jax_handoff.decode_binary(frame)):
        assert decoded['hashes'] == hashes and decoded['page_size'] == 8
        for name, arr in zip(names, arrays):
            np.testing.assert_array_equal(decoded[name], arr)
    assert handoff.WIRE_VERSION == jax_handoff.WIRE_VERSION


def test_wire_validation():
    k, v = _arrays(False)
    payload = handoff.encode_payload([1, 2, 3], 8, k, v)
    with pytest.raises(handoff.HandoffError, match='version'):
        handoff.decode_payload(dict(payload, version=99))
    with pytest.raises(handoff.HandoffError):
        handoff.decode_payload(dict(payload, hashes=[1]))
    with pytest.raises(handoff.HandoffError):
        handoff.decode_payload(dict(payload, k=payload['k'][:-8]))
    frame = handoff.encode_binary([1, 2, 3], 8, k, v)
    for bad in (b'XXXXX\n' + frame[6:], frame[:-4], frame + b'\0',
                frame[:8]):
        with pytest.raises(handoff.HandoffError):
            handoff.decode_binary(bad)
    assert issubclass(handoff.HandoffRejected, handoff.HandoffError)


def test_write_pages_quantizes_like_jax(setup):
    """A float payload into an int8 pool: the bytes of JAX's
    write_pages; int8 payloads land verbatim; exports slice the same
    pages (bf16 exports as exact f32)."""
    jcfg, _, tcfg, _ = setup
    rng = np.random.default_rng(4)
    shape = (tcfg.n_layers, 3, tcfg.n_kv_heads, 8, tcfg.head_dim)
    k = (rng.standard_normal(shape) * 3).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    ids = [5, 2, 9]
    ours = decode.init_paged_cache(tcfg, 12, 8, 2, 8, quantize_kv=True,
                                   device='cpu')
    ref = jax_decode.init_paged_cache(jcfg, 12, 8, 2, 8, quantize_kv=True)
    decode.write_pages(ours, torch.tensor(k), torch.tensor(v), ids)
    ref = jax_decode.write_pages(ref, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(ids))
    for name in ('k', 'v'):
        for leaf in ('q', 'scale'):
            assert (ours[name][leaf].numpy().tobytes() ==
                    np.asarray(ref[name][leaf]).tobytes()), (name, leaf)
    # Verbatim int8: the JAX pool's bytes copied into a fresh port pool.
    fresh = decode.init_paged_cache(tcfg, 12, 8, 2, 8, quantize_kv=True,
                                    device='cpu')
    sel = np.asarray(ids)
    decode.write_pages_quantized(
        fresh, *(torch.tensor(np.asarray(ref[n][leaf])[:, sel])
                 for leaf in ('q', 'scale') for n in ('k', 'v')), ids)
    for name in ('k', 'v'):
        assert torch.equal(fresh[name]['q'], ours[name]['q'])
        assert torch.equal(fresh[name]['scale'], ours[name]['scale'])
    # Export of a private cache: the same page-major slices as JAX.
    private = rng.standard_normal(
        (tcfg.n_layers, 1, tcfg.n_kv_heads, 32, tcfg.head_dim)).astype(
            np.float32)
    cache = {'k': torch.tensor(private), 'v': torch.tensor(-private)}
    jcache = {'k': jnp.asarray(private), 'v': jnp.asarray(-private)}
    for quantize in (False, True):
        got = decode.export_private_pages(cache, 3, 8, quantize=quantize)
        want = jax_decode.export_private_pages(jcache, 3, 8,
                                               quantize=quantize)
        for a, b in zip(got, want):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    bf16 = {n: t.to(torch.bfloat16) for n, t in cache.items()}
    k32, _ = decode.export_private_pages(bf16, 3, 8)
    assert k32.dtype == torch.float32
    assert torch.equal(k32.to(torch.bfloat16).float(), k32)


def test_handoff_page_helpers_match_reference():
    """What the import and export paths ask the page manager, against
    the reference's PagedKVManager."""
    from skypilot_tpu.serve import cache_manager as jax_cm
    from skypilot_tpu_torch.serve import cache_manager
    ours = cache_manager.PagedKVManager(12, 4)
    ref = jax_cm.PagedKVManager(12, 4, slots=2)
    prompt = list(range(13))                     # 3 full pages in [0, 12)
    for mgr in (ours, ref):
        plan = mgr.plan_admission(prompt, 2)
        mgr.commit(0, plan)
        mgr.register_prefix(plan)
    hashes = cache_manager.chunk_hashes(prompt[:12], 4)
    assert hashes == jax_cm.chunk_hashes(prompt[:12], 4)
    probe = hashes[:2] + [12345] + hashes[2:]
    for mgr in (ours, ref):
        assert mgr.import_prefix_depth(probe) == 2
        assert mgr.import_prefix_depth(hashes) == 3
        assert mgr.prefix.contains(hashes[1])
        assert not mgr.prefix.contains(12345)
    assert ours.slot_row(0) == ref.slot_row(0)
    assert ours.slot_row(1) is None and ref.slot_row(1) is None
    assert ours.prefix.hot_entries(2) == ref.prefix.hot_entries(2)
    assert ours.prefix.hot_entries(0) == ref.prefix.hot_entries(0) == []
    assert ours.alloc_pages(4) == ref.alloc_pages(4)
    with pytest.raises(cache_manager.PagesExhausted):
        ours.alloc_pages(8)
    plan = ours.plan_admission([90, 91, 92], 1)
    used = ours.pool.used_count
    ours.abandon(plan)
    assert ours.pool.used_count == used - len(plan.row)


# ------------------------------------------------- cross-framework handoff


@pytest.mark.parametrize('quantize_kv', [False, True], ids=['f32', 'int8'])
@pytest.mark.parametrize('src,dst', [('jax', 'port'), ('port', 'jax')],
                         ids=['jax-to-port', 'port-to-jax'])
def test_cross_framework_handoff_token_exact(setup, src, dst, quantize_kv):
    with _pallas():
        (exporter,) = _engines(setup, src, quantize_kv, 1)
        importer, single = _engines(setup, dst, quantize_kv, 2)
        (other,) = _engines(setup, src, quantize_kv, 1)
        try:
            results = []
            for prompt in (PROMPT, TAIL_PROMPT):
                # JAX exports JSON, the port the binary frame: both
                # codecs cross the framework boundary.
                if src == 'jax':
                    decoded = handoff.decode_payload(
                        exporter.export_prefill(prompt, page_size=8))
                else:
                    decoded = jax_handoff.decode_binary(
                        exporter.export_prefill(prompt, page_size=8,
                                                binary=True))
                assert _import(importer, decoded) == (5, 0)
                results.append((importer.generate(prompt, 8, timeout=300),
                                single.generate(prompt, 8, timeout=300),
                                other.generate(prompt, 8, timeout=300)))
            stats = importer.stats()
            assert stats['prefix_cache_hits'] >= 10
        finally:
            _stop(exporter, importer, single, other)
    for via_handoff, same_side, other_side in results:
        assert via_handoff == same_side == other_side


def test_cross_precision_import_matches_jax_bytes(setup):
    """An f32 export (the port's) into int8 pools of both frameworks:
    the imported pages hold the same bytes; and an int8 export into a
    float pool dequantizes and serves."""
    with _pallas():
        (exporter,) = _engines(setup, 'port', False, 1)
        (port_int8,) = _engines(setup, 'port', True, 1)
        (jax_int8,) = _engines(setup, 'jax', True, 1)
        (int8_src,) = _engines(setup, 'jax', True, 1)
        (port_f32,) = _engines(setup, 'port', False, 1)
        try:
            decoded = handoff.decode_payload(
                exporter.export_prefill(PROMPT, page_size=8))
            assert decoded['k'].dtype == np.float32
            assert _import(port_int8, decoded) == (5, 0)
            assert _import(jax_int8, decoded) == (5, 0)
            pages = [p for _, p in port_int8._kv.prefix.hot_entries(5)]  # pylint: disable=protected-access
            assert pages == [p for _, p in jax_int8._kv.prefix.hot_entries(5)]  # pylint: disable=protected-access
            # int8 values byte for byte; the scales to 1e-6 relative, as
            # for every pool (the JAX engine's jit multiplies absmax by
            # 1/127 where `_quant_kv` divides, one ulp apart at most).
            for name in ('k', 'v'):
                ours = port_int8._cache[name]  # pylint: disable=protected-access
                ref = jax_int8._cache[name]  # pylint: disable=protected-access
                assert (ours['q'][:, pages].numpy().tobytes() ==
                        np.asarray(ref['q'])[:, pages].tobytes()), name
                np.testing.assert_allclose(
                    ours['scale'][:, pages].numpy(),
                    np.asarray(ref['scale'])[:, pages], rtol=1e-6, atol=0)
            assert (port_int8.generate(PROMPT, 6, timeout=300) ==
                    jax_int8.generate(PROMPT, 6, timeout=300))
            quantized = handoff.decode_payload(
                int8_src.export_prefill(PROMPT, page_size=8))
            assert quantized['k'].dtype == np.int8
            assert _import(port_f32, quantized) == (5, 0)
            assert len(port_f32.generate(PROMPT, 6, timeout=300)) == 6
        finally:
            _stop(exporter, port_int8, jax_int8, int8_src, port_f32)


# ------------------------------------------------ the import's failure modes


def test_repeat_import_dedupes(setup):
    src, dst = _engines(setup, 'port', False, 2)
    try:
        decoded = handoff.decode_payload(src.export_prefill(PROMPT,
                                                            page_size=8))
        assert _import(dst, decoded) == (5, 0)
        assert _import(dst, decoded) == (0, 5)
        assert dst._kv.pool.used_count == 5  # pylint: disable=protected-access
    finally:
        _stop(src, dst)


def test_import_rejections(setup):
    (src,) = _engines(setup, 'port', False, 1)
    (other_ps,) = _engines(setup, 'port', False, 1, page_size=16)
    (no_prefix,) = _engines(setup, 'port', False, 1, prefix_caching=False)
    (tiny_pool,) = _engines(setup, 'port', False, 1, kv_pages=4)
    (held,) = _engines(setup, 'port', False, 1, kv_pages=12)
    _, _, tcfg, model = setup
    dense = batching_engine.ContinuousBatchingEngine(
        tcfg, model, max_len=64, slots=2, prefill_chunk=16, device='cpu')
    try:
        decoded = handoff.decode_payload(src.export_prefill(PROMPT,
                                                            page_size=8))
        with pytest.raises(handoff.HandoffError, match='page_size'):
            _import(other_ps, decoded)
        with pytest.raises(handoff.HandoffError, match='prefix'):
            _import(no_prefix, decoded)
        with pytest.raises(handoff.HandoffError, match='capacity'):
            _import(tiny_pool, decoded)
        with pytest.raises(handoff.HandoffError, match='paged'):
            _import(dense, decoded)
        with pytest.raises(handoff.HandoffError, match='fit'):
            _import(held, dict(decoded, k=decoded['k'][:, :, :1],
                               v=decoded['v'][:, :, :1]))
        with pytest.raises(handoff.HandoffError, match='scales'):
            _import(held, dict(decoded, k=decoded['k'].astype(np.int8),
                               v=decoded['v'].astype(np.int8)))
        # Capacity exists but a live decode holds the pages: 429 class.
        hold = held.submit(list(range(1, 50)), 14)       # 8 of 11 pages
        other = handoff.decode_payload(src.export_prefill(
            list(range(101, 142)), page_size=8))
        with pytest.raises(batching_engine.QueueFull) as err:
            _import(held, other)
        assert err.value.retry_after >= 1.0
        assert len(hold.result(timeout=120)) == 14
        with pytest.raises(handoff.HandoffError):
            src.export_prefill([1, 2, 3], page_size=8)   # < 1 full page
        # A dense engine exports (a private prefill) but cannot import.
        dense_payload = handoff.decode_payload(dense.export_prefill(
            PROMPT, page_size=8))
        np.testing.assert_array_equal(dense_payload['k'], decoded['k'])
        for engine in (held, tiny_pool, dense):
            assert engine.stats()['failed'] is False
        with pytest.raises(handoff.HandoffError, match='paged'):
            dense.export_prefix_pages()
    finally:
        _stop(src, other_ps, no_prefix, tiny_pool, held, dense)


def test_export_prefix_pages_round_trip(setup):
    a, b = _engines(setup, 'port', True, 2)
    try:
        with pytest.raises(handoff.HandoffError, match='no cached'):
            a.export_prefix_pages()
        first = a.generate(PROMPT, 5)        # registers 5 full pages
        frame = a.export_prefix_pages(max_pages=64)
        decoded = handoff.decode_binary(frame)
        assert len(decoded['hashes']) == 5 and decoded['k'].dtype == np.int8
        assert _import(b, decoded) == (5, 0)
        assert b.generate(PROMPT, 5) == first
        assert b.stats()['prefix_cache_hits'] == 5
        as_json = a.export_prefix_pages(max_pages=2, binary=False)
        assert as_json['n_pages'] == 2
    finally:
        _stop(a, b)


# ------------------------------------------------------------------ swap


def test_swap_params_keeps_in_flight_requests(setup):
    _, _, tcfg, model = setup
    new_model = init_params(tcfg, seed=9, device='cpu')
    for kw in ({}, dict(kv_pages=48, page_size=8),
               dict(pipelined=False)):
        engine = batching_engine.ContinuousBatchingEngine(
            tcfg, model, max_len=64, slots=2, device='cpu', **kw)
        fresh = batching_engine.ContinuousBatchingEngine(
            tcfg, new_model, max_len=64, slots=2, device='cpu', **kw)
        try:
            assert engine.weight_epoch == 0
            long = engine.submit(PROMPT[:10], 40)
            next(long.stream(timeout=60))          # decoding has begun
            assert engine.swap_params(new_model) == 1
            assert engine.weight_epoch == 1 and engine.model is new_model
            assert engine.stats()['weight_epoch'] == 1
            assert len(long.result(timeout=120)) == 40
            after = [engine.generate(p, 6) for p in (PROMPT, [4, 5, 6])]
            assert after == [fresh.generate(p, 6) for p in (PROMPT,
                                                             [4, 5, 6])]
            with pytest.raises(ValueError, match='config'):
                engine.swap_params(init_params(
                    configs.get_config('tiny-gemma'), seed=0, device='cpu'))
        finally:
            _stop(engine, fresh)
        with pytest.raises(RuntimeError, match='stopped'):
            engine.swap_params(new_model)


def test_swap_forgets_cached_prefixes_unlike_reference(setup):
    """The reference keeps its prefix cache across swap_params, so a
    request after the swap adopts pages the old weights computed, and
    its tokens differ from a fresh engine's on the new weights.  The
    port's swap forgets those entries: its tokens after the swap equal
    a fresh engine's, the reference's fresh engine included."""
    jcfg, params, tcfg, model = setup
    new_model = init_params(tcfg, seed=9, device='cpu')
    new_params = jax.tree.map(jnp.asarray, convert.to_jax_params(new_model))
    kw = dict(max_len=64, slots=2, kv_pages=48, page_size=8)
    ref, ref_fresh = (jax_engine.ContinuousBatchingEngine(jcfg, p, **kw)
                      for p in (params, new_params))
    port, port_fresh = (batching_engine.ContinuousBatchingEngine(
        tcfg, m, device='cpu', **kw) for m in (model, new_model))
    try:
        hits = {}
        for name, engine, weights in (('ref', ref, new_params),
                                      ('port', port, new_model)):
            engine.generate(PROMPT, 4)        # publishes PROMPT's pages
            hits[name] = engine.stats()['prefix_cache_hits']
            engine.swap_params(weights)
        stale = ref.generate(PROMPT, 6)
        assert ref.stats()['prefix_cache_hits'] > hits['ref']
        fresh = ref_fresh.generate(PROMPT, 6)
        assert stale != fresh
        assert port.generate(PROMPT, 6) == fresh
        assert port_fresh.generate(PROMPT, 6) == fresh
        assert port.stats()['prefix_cache_hits'] == hits['port']
    finally:
        _stop(ref, ref_fresh, port, port_fresh)


# ------------------------------------------------------------------ HTTP


def _request(port, path, body=None, raw=None, headers=None):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        data = raw if raw is not None else json.dumps(body or {}).encode()
        conn.request('POST', path, body=data, headers=dict(
            {'Content-Type': 'application/json'}, **(headers or {})))
        resp = conn.getresponse()
        return resp.status, resp.getheader('Content-Type'), resp.read()
    finally:
        conn.close()


def _sse(body: bytes):
    return [line[len(b'data: '):].decode()
            for line in body.split(b'\n') if line.startswith(b'data: ')]


@pytest.fixture(scope='module')
def servers(setup):
    _, _, tcfg, model = setup
    kw = dict(max_len=64, max_batch=2, continuous_batching=True,
              device='cpu', params=model)
    prefill = model_server.ModelServer('tiny', kv_pages=48, page_size=8,
                                       **kw)
    decode_side = model_server.ModelServer('tiny', kv_pages=48, page_size=8,
                                           **kw)
    dense = model_server.ModelServer('tiny', **kw)
    plain = model_server.ModelServer('tiny', max_len=64, device='cpu',
                                     params=model)
    ports = {}
    stops = []
    for name, server in (('prefill', prefill), ('decode', decode_side),
                         ('dense', dense), ('plain', plain)):
        ports[name], stop = model_server.start_background(server)
        stops.append((stop, server))
    yield ports
    for stop, server in stops:
        stop()
        server.close()


def test_http_prefill_export_to_kv_import(servers, setup, tmp_path):
    p, d = servers['prefill'], servers['decode']
    code, ctype, frame = _request(p, '/prefill_export',
                                  {'prompt_ids': [PROMPT], 'page_size': 8,
                                   'wire': 'binary'})
    assert code == 200 and ctype == 'application/octet-stream'
    code, _, body = _request(d, '/kv_import', raw=frame, headers={
        'Content-Type': 'application/octet-stream'})
    assert code == 200
    assert json.loads(body) == {'imported_pages': 5, 'cached_pages': 0}
    code, ctype, body = _request(p, '/prefill_export',
                                 {'prompt_ids': PROMPT, 'page_size': 8})
    assert code == 200 and ctype == 'application/json'
    code, _, again = _request(d, '/kv_import', raw=body)
    assert code == 200
    assert json.loads(again) == {'imported_pages': 0, 'cached_pages': 5}
    outs = [json.loads(_request(port, '/generate', {
        'prompt_ids': [PROMPT], 'max_new_tokens': 6})[2])
        for port in (d, p, servers['dense'])]
    assert outs[0]['tokens'] == outs[1]['tokens'] == outs[2]['tokens']
    assert outs[0]['weight_version'] == 0
    code, ctype, frame = _request(d, '/prefix_export', {'wire': 'binary'})
    assert code == 200 and ctype == 'application/octet-stream'
    assert len(handoff.decode_binary(frame)['hashes']) == 5
    assert _request(servers['dense'], '/prefix_export', {})[0] == 404
    # A dense server exports, but has no pool to import into.
    code, _, body = _request(servers['dense'], '/prefill_export',
                             {'prompt_ids': [PROMPT], 'page_size': 8})
    assert code == 200
    assert _request(servers['dense'], '/kv_import', raw=body)[0] == 400
    for port, path in ((servers['plain'], '/prefill_export'),
                       (servers['plain'], '/kv_import'),
                       (servers['plain'], '/prefix_export')):
        assert _request(port, path, {'prompt_ids': [PROMPT]})[0] == 400
    assert _request(p, '/prefill_export', {'prompt_ids': [[1, 2]]})[0] == 400
    assert _request(d, '/kv_import', raw=b'SKTH1\nxx', headers={
        'Content-Type': 'application/octet-stream'})[0] == 400
    # Pages only a later request may use: 429 with Retry-After when the
    # pool cannot take them is pinned at the engine level.
    # /weights_swap: the reference's 400 texts, then a real restore of
    # the served weights (tokens unchanged, the epoch bumped).
    for port, body, error in (
            (d, {'checkpoint_dir': '/x'}, 'no checkpoint under /x'),
            (d, {}, 'weights_swap needs a checkpoint_dir'),
            (servers['plain'], {'checkpoint_dir': '/x'},
             'live weight swap requires --continuous-batching')):
        code, _, raw = _request(port, '/weights_swap', body)
        assert (code, json.loads(raw)['error']) == (400, error)
    ckpt = str(tmp_path / 'ckpt')
    checkpoints.save_params(ckpt, 3, convert.param_tree(setup[3]))
    code, _, raw = _request(d, '/weights_swap', {'checkpoint_dir': ckpt})
    swapped = json.loads(raw)
    assert code == 200 and (swapped['weight_version'],
                            swapped['step']) == (1, 3)
    again = json.loads(_request(d, '/generate', {
        'prompt_ids': [PROMPT], 'max_new_tokens': 6})[2])
    assert again['tokens'] == outs[0]['tokens']
    assert again['weight_version'] == 1


@pytest.fixture(scope='module')
def reference_server():
    """The JAX package's server (tiny, dense continuous batching) and
    the port's on the same weights."""
    ref = jax_server.ModelServer('tiny', max_len=64, max_batch=2,
                                 continuous_batching=True)
    tcfg = configs.get_config('tiny')
    ours = model_server.ModelServer(
        'tiny', max_len=64, max_batch=2, continuous_batching=True,
        device='cpu', params=convert.from_jax_params(
            tcfg, jax.tree.map(np.asarray, ref.params), device='cpu'))
    ref_port, ref_stop = jax_server.start_background(ref)
    our_port, our_stop = model_server.start_background(ours)
    yield ref_port, our_port
    our_stop()
    ours.close()
    ref_stop()
    ref.close()


@pytest.mark.parametrize('path,body', [
    ('/generate_stream', {'prompt_ids': [[5, 6, 7, 8]],
                          'max_new_tokens': 7}),
    ('/generate_stream', {'prompt_ids': [9, 1, 2], 'max_new_tokens': 4,
                          'stop_token': 0}),
    ('/generate_text', {'prompt': 'héllo wörld', 'max_new_tokens': 12,
                        'stream': True}),
    ('/generate_text', {'prompt': 'héllo wörld', 'max_new_tokens': 12}),
], ids=['stream', 'stream-flat', 'text-stream', 'text'])
def test_streaming_routes_answer_reference_frames(reference_server, path,
                                                  body):
    ref_port, our_port = reference_server
    ours = _request(our_port, path, body)
    ref = _request(ref_port, path, body)
    assert ours[0] == ref[0] == 200
    assert ours[1] == ref[1]
    if body.get('stream') or path == '/generate_stream':
        assert _sse(ours[2]) == _sse(ref[2])
        assert _sse(ours[2])[-1] == '[DONE]'
    else:
        a, b = json.loads(ours[2]), json.loads(ref[2])
        for key in ('completion', 'tokens', 'weight_version'):
            assert a[key] == b[key], key


def test_streaming_route_errors(servers, reference_server):
    plain = servers['plain']
    code, _, body = _request(plain, '/generate_stream',
                             {'prompt_ids': [[1, 2]]})
    assert code == 400 and 'continuous-batching' in json.loads(body)['error']
    code, _, body = _request(plain, '/generate_text',
                             {'prompt': 'hi', 'stream': True})
    assert code == 400
    code, _, body = _request(plain, '/generate_text', {'prompt': 'hi',
                                                       'max_new_tokens': 3})
    assert code == 200 and len(json.loads(body)['tokens']) <= 3
    _, our_port = reference_server
    for path, bad in (('/generate_stream', {'prompt_ids': [[1], [2]]}),
                      ('/generate_stream', {}),
                      ('/generate_text', {'prompt': ''}),
                      ('/generate_text', {'prompt': 3})):
        assert _request(our_port, path, bad)[0] == 400, (path, bad)
    # A stream cut short by the client frees its slot.
    conn = http.client.HTTPConnection('127.0.0.1', our_port, timeout=60)
    conn.request('POST', '/generate_stream', body=json.dumps(
        {'prompt_ids': [[1, 2, 3]], 'max_new_tokens': 50}))
    resp = conn.getresponse()
    resp.fp.readline()
    conn.close()
    done = threading.Event()

    def probe():
        _request(our_port, '/generate', {'prompt_ids': [[4, 4]],
                                         'max_new_tokens': 2})
        done.set()
    threading.Thread(target=probe, daemon=True).start()
    assert done.wait(60)
