"""The port's observability plane on the CPU (tiny preset, f32).

- The port's engine gives the JAX engine's greedy tokens (paged, pinned
  to its kernel path in interpret mode) with the plane on and off, and
  the same per-request span counts (tokens, prefill chunks, spec steps,
  prefix-hit pages); span `to_dict()` keys and `profile()` snapshot keys
  equal the reference's.
- The port's metric families and labels are a superset of the
  reference's engine, scheduler, page-pool, profiler, log and server
  families, the flight recorder's (observability/events.py) and the
  chaos injector's, but for an explicit list of families still to port.
- The reference's own readers take the port's HTTP payloads:
  `parse_exposition` reads /metrics, `traces.collect` / `assemble` /
  `format_waterfall` read /spans, `collapsed_stacks` / `chrome_trace`
  read /profile, `fetch_log_records` reads /logs.
- Nothing under observability/ touches the device: the calls that would
  are patched to raise while a tick's worth of instruments runs, and an
  AST walk finds none of them named.
- The reference's unit cases of the metrics core, spans, profiler,
  sentinel and exports, ported as parametrised cases.
"""
from __future__ import annotations

import ast
import json
import pathlib
import threading
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.chaos import injector as ref_injector
from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.observability import events as ref_events
from skypilot_tpu.observability import logs as ref_logs
from skypilot_tpu.observability import metrics as ref_metrics
from skypilot_tpu.observability import profiling as ref_profiling
from skypilot_tpu.observability import traces as ref_traces
from skypilot_tpu.observability import tracing as ref_tracing
from skypilot_tpu.serve import batching_engine as jax_engine
from skypilot_tpu.serve import cache_manager as ref_cache_manager
from skypilot_tpu.serve import model_server as ref_model_server
from skypilot_tpu.serve import scheduler as ref_scheduler
from skypilot_tpu_torch.chaos import injector
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.observability import events
from skypilot_tpu_torch.observability import logs
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import profiling
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import http_protocol
from skypilot_tpu_torch.serve import model_server

REPO = pathlib.Path(__file__).resolve().parent.parent
ENGINE_KW = dict(max_len=64, slots=2, prefill_chunk=8, kv_pages=48,
                 page_size=8)
_RNG = np.random.default_rng(20261017)
# Seeded prompts, misaligned against page 8 / chunk 8 (the 24-token one
# prefills in three chunks), a one-token prompt, and a pair sharing two
# full pages (the second is a prefix hit: its seed counts as a chunk).
_SHARED = _RNG.integers(1, 250, 16).tolist()
PROMPTS = [(_RNG.integers(1, 250, n).tolist(), new) for n, new in
           ((8, 6), (1, 4), (13, 5), (24, 5), (7, 7))]
PROMPTS += [(_SHARED + [3, 1, 4, 1], 5), (_SHARED + [2, 7, 1], 6)]
CASES = {'paged': {}, 'spec': {'spec_tokens': 3}}

# Reference families the port does not have yet, with the Queue A item
# (ROADMAP) that brings each: none.
MISSING: dict = {}


@pytest.fixture(scope='module')
def setup():
    jcfg = jax_configs.get_config('tiny')
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    tcfg = configs.get_config('tiny')
    model = convert.from_jax_params(
        tcfg, jax.tree.map(np.asarray, params), device='cpu')
    return jcfg, params, tcfg, model


def _drive(engine):
    """Greedy tokens, finished spans and profile of PROMPTS, one at a
    time (ids r0, r1, ...).  Spans are read once the worker has stopped:
    the reference stores a span just after it wakes the request's
    waiter."""
    tokens = []
    try:
        for i, (prompt, new) in enumerate(PROMPTS):
            tokens.append(list(engine.submit(
                prompt, new, request_id=f'r{i}').result(timeout=300)))
    finally:
        engine.stop()
    spans = [engine.span(f'r{i}') for i in range(len(PROMPTS))]
    return tokens, spans, engine.profile()


@pytest.fixture(scope='module')
def jax_runs(setup):
    jcfg, params, _, _ = setup
    mp = pytest.MonkeyPatch()
    mp.setenv('SKYTPU_DECODE_KERNEL', 'pallas')
    mp.setenv('SKYTPU_PALLAS_INTERPRET', '1')
    try:
        runs = {}
        for case, kw in CASES.items():
            engine = jax_engine.ContinuousBatchingEngine(
                jcfg, params, **ENGINE_KW, **kw)
            assert engine.decode_kernel == 'pallas'
            runs[case] = _drive(engine)
        return runs
    finally:
        mp.undo()


@pytest.mark.parametrize('plane', ['on', 'off'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_engine_matches_jax_with_plane(setup, jax_runs, monkeypatch, case,
                                       plane):
    _, _, tcfg, model = setup
    if plane == 'off':
        monkeypatch.setenv('SKYTPU_PROFILE_DISABLE', '1')
    tokens, spans, profile = _drive(batching_engine.ContinuousBatchingEngine(
        tcfg, model, device='cpu', **ENGINE_KW, **CASES[case]))
    ref_tokens, ref_spans, ref_profile = jax_runs[case]
    assert tokens == ref_tokens
    assert profile['enabled'] is (plane == 'on')
    assert profile['recompiles']['enabled'] is (plane == 'on')
    for span, ref in zip(spans, ref_spans):
        assert set(span) == set(ref)
        for key in ('request_id', 'status', 'tokens', 'prefill_chunks',
                    'prefix_hit_pages', 'spec_steps', 'spec_proposed',
                    'spec_accepted', 'weight_epoch'):
            assert span.get(key) == ref.get(key), key
    assert spans[-1]['prefix_hit_pages'] == 2
    assert set(profile) == set(ref_profile)
    assert set(profile['recompiles']) == set(ref_profile['recompiles'])
    assert set(profile['device_memory']) == set(ref_profile['device_memory'])
    if plane == 'on':
        assert profile['ticks'] > 0
        assert set(profile['phases']) <= set(profiling.PHASES)
        for name, agg in profile['phases'].items():
            assert set(agg) == set(ref_profile['phases'][name])
        assert set(profile['ring'][0]) == set(ref_profile['ring'][0])
        assert (set(profile['recompiles']['fns']) ==
                set(ref_profile['recompiles']['fns']))
        for name, fn in profile['recompiles']['fns'].items():
            assert set(fn) == set(ref_profile['recompiles']['fns'][name])
        assert profile['device_memory']['watermark_bytes'] is None


@pytest.mark.parametrize('pipelined', [True, False],
                         ids=['pipelined', 'legacy'])
def test_host_ops_get_a_handoff_phase(setup, pipelined):
    """A host op (KV import, export, swap) run on an idle worker is
    recorded as the tick's 'handoff' phase in both loops; the request
    that follows ends ticks after it, so its tick is in the ring."""
    _, _, tcfg, model = setup
    engine = batching_engine.ContinuousBatchingEngine(
        tcfg, model, max_len=64, slots=2, pipelined=pipelined,
        device='cpu')
    try:
        engine._on_worker(lambda: None, RuntimeError('worker stuck'))  # pylint: disable=protected-access
        engine.generate(PROMPTS[0][0], 4)
        ring = engine.profile()['ring']
    finally:
        engine.stop()
    assert any(name == 'handoff' for rec in ring
               for name, _, _ in rec['phases'])


def _instruments(module, base):
    return {v.name: v for v in vars(module).values()
            if isinstance(v, base)}


def _accessed(module, base):
    """The instruments of `module`'s get-or-create accessors (the
    zero-argument functions that return one), created by the call."""
    out = {}
    for fn in vars(module).values():
        if (callable(fn) and not isinstance(fn, type) and
                getattr(fn, '__module__', None) == module.__name__ and
                fn.__code__.co_argcount == 0 and
                fn.__annotations__.get('return') is not None):
            inst = fn()
            if isinstance(inst, base):
                out[inst.name] = inst
    return out


def test_metric_families_cover_the_reference():
    """Every reference family of the replica's layers, the flight
    recorder's and the chaos injector's exists in the port with the
    same kind and label names, but for MISSING."""
    ref_logs._records_counter()   # lazily created families
    ref_logs._http_counter()
    ref = {}
    for module in (jax_engine, ref_scheduler, ref_cache_manager,
                   ref_model_server, ref_profiling):
        ref.update(_instruments(module, ref_metrics._Instrument))
    for name in ('skytpu_log_records_total', 'skytpu_http_requests_total'):
        ref[name] = ref_metrics.REGISTRY.get(name)
    flight = _accessed(ref_events, ref_metrics._Instrument)
    assert 'skytpu_gang_resizes_total' in flight and len(flight) == 13
    ref.update(flight)
    chaos = ref_injector.chaos_faults_total()
    ref[chaos.name] = chaos
    logs._records_counter()
    logs._http_counter()
    assert set(_accessed(events, metrics._Instrument)) == set(flight)
    injector.chaos_faults_total()
    assert set(MISSING) <= set(ref)
    for name, inst in sorted(ref.items()):
        ours = metrics.REGISTRY.get(name)
        if name in MISSING:
            assert ours is None, f'{name} is ported: drop it from MISSING'
            continue
        assert ours is not None, name
        assert ours.kind == inst.kind, name
        assert ours.labelnames == inst.labelnames, name
        if inst.kind == 'histogram':
            assert ours.buckets == inst.buckets, name


# ------------------------------------------------------ the HTTP surface


def _get(url, rid=None):
    req = urllib.request.Request(url, headers=(
        {http_protocol.REQUEST_ID_HEADER: rid} if rid else {}))
    with urllib.request.urlopen(req, timeout=60) as resp:
        return (resp.status, resp.headers.get(
            http_protocol.REQUEST_ID_HEADER), resp.read())


def _post(url, body, rid=None):
    headers = {'Content-Type': 'application/json'}
    if rid:
        headers[http_protocol.REQUEST_ID_HEADER] = rid
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method='POST', headers=headers)
    with urllib.request.urlopen(req, timeout=300) as resp:
        return (resp.status, resp.headers.get(
            http_protocol.REQUEST_ID_HEADER), json.loads(resp.read()))


def _settle(engine):
    """Return once the worker has read its last tick: two host ops run
    at the top of two worker iterations, the second after any tick the
    first found in flight."""
    for _ in range(2):
        engine._on_worker(lambda: None, RuntimeError('worker stuck'))  # pylint: disable=protected-access


def _family(parsed, name, **labels):
    want = set(labels.items())
    return sum(v for k, v in parsed.get(name, {}).items() if want <= set(k))


@pytest.fixture(scope='module')
def served(setup):
    _, _, tcfg, model = setup
    server = model_server.ModelServer(
        'tiny', device='cpu', params=model, continuous_batching=True,
        max_len=64, max_batch=2, prefill_chunk=8, kv_pages=48,
        page_size=8)
    port, stop = model_server.start_background(server)
    try:
        yield server, f'http://127.0.0.1:{port}'
    finally:
        stop()
        server.close()


def test_http_routes_read_by_the_reference(served):
    server, base = served
    engine = server.engine
    _settle(engine)
    before = ref_metrics.parse_exposition(_get(base + '/metrics')[2].decode())
    stats0 = engine.stats()
    ids = [f'obs-{i}' for i in range(3)]
    results = {}

    def run(i, rid):
        results[rid] = _post(base + http_protocol.GENERATE, {
            'prompt_ids': [PROMPTS[i][0]], 'max_new_tokens': 5}, rid)

    threads = [threading.Thread(target=run, args=(i, rid))
               for i, rid in zip((0, 2, 3), ids)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    _settle(engine)
    status, echoed, body = _get(base + http_protocol.METRICS, 'scrape-1')
    assert status == 200 and echoed == 'scrape-1'
    after = ref_metrics.parse_exposition(body.decode())
    stats1 = engine.stats()
    for rid in ids:
        code, echoed, out = results[rid]
        assert code == 200 and echoed == rid
    # /metrics: deltas over this test equal the engine's own counts.
    for family, key in (('skytpu_engine_ticks_total', 'ticks'),
                        ('skytpu_engine_decode_tokens_total',
                         'tokens_generated')):
        assert (_family(after, family) - _family(before, family) ==
                stats1[key] - stats0[key]), family
    assert (_family(after, 'skytpu_engine_ttft_seconds_count') -
            _family(before, 'skytpu_engine_ttft_seconds_count') == 3)
    assert _family(after, 'skytpu_engine_slots') == 2
    assert ref_metrics.histogram_quantile(
        after, 'skytpu_engine_ttft_seconds', 0.5) is not None
    # /spans through the reference's trace assembly.
    for rid in ids:
        segments = ref_traces.collect(rid, [{'url': base}])
        [seg] = [s for s in ref_traces.assemble(segments)
                 if s['name'] == 'engine']
        assert seg['request_id'] == rid and seg['status'] == 'ok'
        assert seg['tokens'] == len(results[rid][2]['tokens'][0])
        assert seg['ttft_ms'] <= seg['duration_ms']
        assert [p['name'] for p in seg['phases']] == [
            'queue', 'prefill', 'decode']
        ends = [p['start'] + p['duration_ms'] / 1e3 for p in seg['phases']]
        for end, nxt in zip(ends, seg['phases'][1:]):
            assert end <= nxt['start'] + 1e-5
        assert ref_traces.format_waterfall(segments)
        # /logs: the access record of the request carries its id.
        records = ref_traces.fetch_log_records(base, request_id=rid)
        assert [r['msg'] for r in records
                if r['msg'].startswith('POST')] == [
                    f'POST {http_protocol.GENERATE} -> 200']
        assert records[0]['process'] == 'replica'
    # /profile through the reference's exports.
    status, _, body = _get(base + http_protocol.PROFILE)
    payload = json.loads(body)
    prof = payload['profile']
    assert payload['process'] == 'replica' and prof['enabled'] is True
    assert prof['ticks'] > 0 and prof['pipelined'] is True
    assert set(prof['phases']) <= set(ref_profiling.PHASES)
    assert {'admit', 'prefill-chunk', 'decode-step', 'sample',
            'page-scatter'} <= set(prof['phases'])
    for rec in prof['ring']:
        assert sum(d for _, _, d in rec['phases']) <= rec['dur_s'] + 1e-9
    assert prof['recompiles']['steady_recompiles_total'] == 0
    assert 'step' in prof['recompiles']['fns']
    assert ref_profiling.collapsed_stacks(prof)
    trace = ref_profiling.chrome_trace(prof)
    assert {e['name'] for e in trace['traceEvents']} == set(prof['phases'])


def test_request_ids_are_made_echoed_and_segmented(served):
    server, base = served
    # No id sent: the server makes one, echoes it and names the span.
    code, rid, out = _post(base + http_protocol.GENERATE,
                           {'prompt_ids': [[5, 6, 7]], 'max_new_tokens': 3})
    assert code == 200 and rid and len(rid) == 16
    _settle(server.engine)
    assert server.engine.span(rid)['tokens'] == 3
    # Every response echoes it, errors and health included.
    assert _get(base + '/health', 'probe-1')[1] == 'probe-1'
    try:
        _post(base + '/nope', {}, 'lost-1')
        raise AssertionError('404 expected')
    except urllib.error.HTTPError as e:
        assert e.code == 404
        assert e.headers.get(http_protocol.REQUEST_ID_HEADER) == 'lost-1'
    # The handoff routes leave trace segments under the request's id.
    code, _, payload = _post(base + http_protocol.PREFILL_EXPORT,
                             {'prompt_ids': PROMPTS[3][0]}, 'hand-1')
    assert code == 200
    code, _, out = _post(base + http_protocol.KV_IMPORT, payload, 'hand-1')
    assert code == 200
    status, _, body = _get(base + http_protocol.SPANS +
                           '?request_id=hand-1')
    segments = json.loads(body)['segments']
    assert [s['name'] for s in ref_traces.assemble(segments)] == [
        'prefill_export', 'kv_import']
    assert segments[0]['tokens'] == len(PROMPTS[3][0])
    assert segments[1]['imported_pages'] + segments[1]['cached_pages'] == 2
    # The health payload carries the recent spans.
    health = json.loads(_get(base + '/health')[2])
    assert health['engine']['recent_spans'][0]['request_id'] == rid


# ------------------------------------------------- no device touch


FORBIDDEN_ATTRS = ('profiler', 'record_function', 'nvtx', 'synchronize',
                   'item', 'tolist', 'cpu')


def _observability_files():
    return sorted((REPO / 'skypilot_tpu_torch' / 'observability').glob(
        '*.py'))


@pytest.mark.parametrize('path', _observability_files(),
                         ids=lambda p: p.name)
def test_observability_names_no_device_call(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            if node.attr in FORBIDDEN_ATTRS:
                bad.append((node.lineno, node.attr))
            if (node.attr == 'Event' and isinstance(node.value, ast.Attribute)
                    and node.value.attr == 'cuda'):
                bad.append((node.lineno, 'cuda.Event'))
        elif isinstance(node, ast.ImportFrom) and node.module and (
                'profiler' in node.module or 'nvtx' in node.module):
            bad.append((node.lineno, node.module))
    assert not bad, f'{path.name}: {bad}'


def test_plane_runs_without_touching_the_device(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError('the observability plane touched the device')

    for owner, name in ((torch.cuda, 'synchronize'), (torch.Tensor, 'item'),
                        (torch.Tensor, 'tolist'), (torch.Tensor, 'cpu'),
                        (torch.profiler, 'profile')):
        monkeypatch.setattr(owner, name, boom)
    # The CUDA engine's memory callback, on the allocator's counters.
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated',
                        lambda device=None: 4096)
    prof = profiling.TickProfiler(
        disabled=False,
        memory_cb=profiling.device_memory_cb(torch.device('cuda', 0)))
    sentinel = profiling.RecompileSentinel(disabled=False, steady_after=1)
    step = sentinel.wrap('step', lambda *a, **k: a[2])
    module = torch.nn.Linear(4, 4)
    cache = {'k': {'q': torch.zeros(2, 3, dtype=torch.int8),
                   'scale': torch.ones(2, 3)},
             'v': torch.zeros(2, 3), 'lengths': torch.zeros(2)}
    span = tracing.RequestSpan('dev-1')
    span.mark_admitted()
    for width in (4, 4, 8):
        prof.begin_tick()
        prof.lap('handoff', record=False)
        state = {'tokens': torch.zeros(width, dtype=torch.int32)}
        step(None, module, state, cache, max_top_k=4)
        prof.lap('decode-step')
        span.mark_prefill_chunk(0.001)
        span.mark_token()
        prof.lap('sample')
        prof.end_tick()
    span.finish('ok')
    store = tracing.SpanStore()
    store.add(span)
    snap = prof.snapshot()
    assert snap['ticks'] == 3
    assert snap['device_memory']['watermark_bytes'] == 4096
    fns = sentinel.snapshot()['fns']['step']
    assert fns['compiles'] == 2 and fns['steady_recompiles'] == 1
    assert store.export({'process': 'replica'})[0]['tokens'] == 3
    assert metrics.parse_exposition(metrics.expose())
    assert profiling.device_memory_cb(torch.device('cpu'))() is None


# ------------------------------------------- ported unit cases: metrics


def _m_counter_inc_and_expose():
    reg = metrics.Registry()
    c = reg.counter('t_requests_total', 'Requests.')
    c.inc()
    c.inc(4)
    assert c.value == 5
    text = reg.expose()
    assert '# TYPE t_requests_total counter' in text
    assert 't_requests_total 5' in text


def _m_counter_rejects_negative():
    c = metrics.Registry().counter('t_neg_total', 'x')
    with pytest.raises(ValueError, match='only go up'):
        c.inc(-1)


def _m_gauge_set_inc_dec():
    g = metrics.Registry().gauge('t_depth', 'x')
    g.set(7)
    g.inc(2)
    g.dec()
    assert g.value == 8


def _m_labels_make_distinct_series():
    reg = metrics.Registry()
    c = reg.counter('t_by_reason_total', 'x', ('reason',))
    c.labels(reason='full').inc(2)
    c.labels(reason='expired').inc(3)
    series = metrics.parse_exposition(reg.expose())['t_by_reason_total']
    assert series[(('reason', 'full'),)] == 2
    assert series[(('reason', 'expired'),)] == 3


def _m_label_validation():
    c = metrics.Registry().counter('t_lab_total', 'x', ('a', 'b'))
    with pytest.raises(ValueError, match='unknown labels'):
        c.labels(a='1', nope='2')
    with pytest.raises(ValueError, match='label value'):
        c.labels('only-one')
    with pytest.raises(ValueError, match='has labels'):
        c.inc()


def _m_label_cardinality_overflow_folds():
    reg = metrics.Registry()
    c = metrics.Counter('t_card_total', 'x', ('k',), max_series=4)
    reg.register(c)
    for i in range(10):
        c.labels(k=f'v{i}').inc()
    series = c.series()
    assert len(series) == 5
    assert series[('_overflow_',)][0] == 6


def _m_get_or_create_and_conflict():
    reg = metrics.Registry()
    a = reg.counter('t_same_total', 'x')
    assert reg.counter('t_same_total', 'x') is a
    with pytest.raises(ValueError, match='already registered'):
        reg.gauge('t_same_total', 'x')
    with pytest.raises(ValueError, match='already registered'):
        reg.counter('t_same_total', 'x', ('extra',))


def _m_concurrent_increments_from_threads():
    reg = metrics.Registry()
    c = reg.counter('t_race_total', 'x')
    h = reg.histogram('t_race_seconds', 'x', buckets=(0.5, 1.0))

    def worker():
        for _ in range(1000):
            c.inc()
            h.observe(0.25)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 8000 and h.count == 8000
    assert h.bucket_counts() == [8000, 0, 0]


def _m_bucket_boundaries_le_inclusive():
    h = metrics.Registry().histogram('t_hist_seconds', 'x',
                                     buckets=(0.1, 1.0, 5.0))
    for v in (0.1, 0.05, 1.0, 4.9, 5.0, 100.0):
        h.observe(v)
    assert h.bucket_counts() == [2, 1, 2, 1]
    assert h.count == 6
    assert h.sum == pytest.approx(111.05)


def _m_exposition_cumulative_with_inf():
    reg = metrics.Registry()
    h = reg.histogram('t_exp_seconds', 'x', buckets=(1.0, 2.0))
    for v in (0.5, 1.5, 99.0):
        h.observe(v)
    parsed = metrics.parse_exposition(reg.expose())
    buckets = parsed['t_exp_seconds_bucket']
    assert buckets[(('le', '1'),)] == 1
    assert buckets[(('le', '2'),)] == 2
    assert buckets[(('le', '+Inf'),)] == 3
    assert parsed['t_exp_seconds_count'][()] == 3
    assert parsed['t_exp_seconds_sum'][()] == pytest.approx(101.0)


def _m_rejects_bad_buckets():
    with pytest.raises(ValueError):
        metrics.Histogram('t_bad', 'x', buckets=())
    with pytest.raises(ValueError, match='duplicate'):
        metrics.Histogram('t_bad2', 'x', buckets=(1.0, 1.0))


def _m_label_value_escaping_round_trip():
    reg = metrics.Registry()
    c = reg.counter('t_escape_total', 'x', ('path',))
    tricky = 'a"b\\c\nd'
    c.labels(path=tricky).inc()
    parsed = metrics.parse_exposition(reg.expose())
    assert parsed['t_escape_total'][(('path', tricky),)] == 1


def _m_exposition_http_server():
    reg = metrics.Registry()
    reg.counter('t_http_total', 'x').inc(3)
    port, shutdown = metrics.start_exposition_server(registry=reg)
    try:
        status, _, body = _get(f'http://127.0.0.1:{port}/metrics')
        assert status == 200
        assert metrics.parse_exposition(body.decode())['t_http_total'][
            ()] == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f'http://127.0.0.1:{port}/nope')
        assert e.value.code == 404
    finally:
        shutdown()


METRIC_CASES = {f.__name__[3:]: f for f in (
    _m_counter_inc_and_expose, _m_counter_rejects_negative,
    _m_gauge_set_inc_dec, _m_labels_make_distinct_series,
    _m_label_validation, _m_label_cardinality_overflow_folds,
    _m_get_or_create_and_conflict, _m_concurrent_increments_from_threads,
    _m_bucket_boundaries_le_inclusive, _m_exposition_cumulative_with_inf,
    _m_rejects_bad_buckets, _m_label_value_escaping_round_trip,
    _m_exposition_http_server)}


@pytest.mark.parametrize('case', sorted(METRIC_CASES))
def test_metrics_case(case):
    METRIC_CASES[case]()


# ------------------------------------------- ported unit cases: tracing


def _t_phases_recorded():
    span = tracing.RequestSpan('req-1')
    span.mark_admitted()
    span.mark_prefill_chunk(0.01)
    span.mark_prefill_chunk(0.02)
    assert span.mark_token() is None
    gap = span.mark_token()
    assert gap is not None and gap >= 0
    span.finish('ok')
    d = span.to_dict()
    assert d['request_id'] == 'req-1' and d['status'] == 'ok'
    assert d['queue_wait_ms'] is not None and d['ttft_ms'] is not None
    assert d['prefill_chunks'] == 2
    assert d['prefill_ms'] == pytest.approx(30.0, abs=0.5)
    assert d['tokens'] == 2 and d['total_ms'] is not None
    # The same keys as the reference's span.
    ref = ref_tracing.RequestSpan('req-1')
    ref.finish('ok')
    assert set(d) == set(ref.to_dict())
    assert set(span.segment()) == set(ref.segment())


def _t_finish_idempotent():
    span = tracing.RequestSpan()
    span.finish('ok')
    total = span.total_s
    span.finish('error')
    assert span.status == 'ok' and span.total_s == total


def _t_store_bounded_and_lookup():
    store = tracing.SpanStore(maxlen=3)
    for i in range(5):
        s = tracing.RequestSpan(f'r{i}')
        s.finish()
        store.add(s)
    assert len(store) == 3
    assert store.get('r0') is None
    assert store.get('r4')['request_id'] == 'r4'
    assert [s['request_id'] for s in store.recent(2)] == ['r4', 'r3']


def _t_ids_unique():
    assert len({tracing.new_request_id() for _ in range(100)}) == 100


TRACING_CASES = {f.__name__[3:]: f for f in (
    _t_phases_recorded, _t_finish_idempotent, _t_store_bounded_and_lookup,
    _t_ids_unique)}


@pytest.mark.parametrize('case', sorted(TRACING_CASES))
def test_tracing_case(case):
    TRACING_CASES[case]()


# ----------------------------------------- ported unit cases: profiling


class FakeClock:
    """Deterministic clock: every read advances by `step` unless reads
    are queued explicitly."""

    def __init__(self, step: float = 1.0) -> None:
        self.now = 0.0
        self.step = step
        self.queued = []

    def __call__(self) -> float:
        self.now += self.queued.pop(0) if self.queued else self.step
        return self.now


class RecordingJournal:

    def __init__(self) -> None:
        self.events = []

    def append(self, name, **fields) -> None:
        self.events.append((name, fields))


def _profiler(**kw):
    kw.setdefault('clock', FakeClock())
    kw.setdefault('memory_cb', lambda: None)
    kw.setdefault('disabled', False)
    return profiling.TickProfiler(**kw)


def _p_laps_are_exclusive_and_one_read_each(monkeypatch):
    del monkeypatch
    prof = _profiler(clock=FakeClock(step=1.0))
    prof.begin_tick()
    prof.lap('handoff', record=False)
    prof.lap('admit')
    prof.lap('decode-step')
    prof.end_tick()
    snap = prof.snapshot()
    assert snap['ticks'] == 1
    assert set(snap['phases']) == {'admit', 'decode-step'}
    assert snap['phases']['admit']['total_s'] == pytest.approx(1.0)
    [rec] = snap['ring']
    assert rec['dur_s'] == pytest.approx(3.0)
    assert sum(d for _, _, d in rec['phases']) == pytest.approx(2.0)


def _p_idle_ticks_never_enter_the_ring(monkeypatch):
    del monkeypatch
    prof = _profiler()
    for _ in range(5):
        prof.begin_tick()
        prof.lap('admit', record=False)
        prof.end_tick()
    assert prof.ticks == 0 and prof.snapshot()['ring'] == []


def _p_ring_is_bounded_but_aggregates_are_cumulative(monkeypatch):
    del monkeypatch
    prof = _profiler(ring_ticks=4)
    for _ in range(10):
        prof.begin_tick()
        prof.lap('decode-step')
        prof.end_tick()
    snap = prof.snapshot()
    assert len(snap['ring']) == 4 and snap['ticks'] == 10
    assert snap['phases']['decode-step']['count'] == 10


def _p_disable_gate_is_a_noop(monkeypatch):
    del monkeypatch
    prof = _profiler(disabled=True)
    prof.begin_tick()
    prof.lap('decode-step')
    prof.end_tick()
    snap = prof.snapshot()
    assert snap['enabled'] is False
    assert snap['ticks'] == 0 and snap['ring'] == []


def _p_env_knobs(monkeypatch):
    monkeypatch.setenv('SKYTPU_PROFILE_RING_TICKS', '7')
    monkeypatch.setenv('SKYTPU_PROFILE_DISABLE', '1')
    prof = profiling.TickProfiler(memory_cb=lambda: None)
    assert prof.ring_ticks == 7 and prof.disabled is True
    assert profiling.RecompileSentinel().disabled is True


def _p_quantiles_over_the_ring(monkeypatch):
    del monkeypatch
    clock = FakeClock(step=0.0)
    prof = _profiler(clock=clock, ring_ticks=128)
    for dur in (1.0, 2.0, 3.0, 4.0):
        clock.queued = [0.0, dur]
        prof.begin_tick()
        prof.lap('sample')
        prof.end_tick()
    agg = prof.snapshot()['phases']['sample']
    assert agg['p50_s'] == pytest.approx(3.0)
    assert agg['max_s'] == pytest.approx(4.0)
    assert agg['total_s'] == pytest.approx(10.0)


def _p_memory_watermark_and_dead_backend(monkeypatch):
    del monkeypatch
    mems = [100, 300, 200]
    prof = _profiler(memory_cb=lambda: mems.pop(0) if mems else None)
    for _ in range(3):
        prof.begin_tick()
        prof.lap('decode-step')
        prof.end_tick()
    snap = prof.snapshot()
    assert snap['device_memory']['watermark_bytes'] == 300
    assert snap['device_memory']['last_bytes'] == 200
    prof.begin_tick()
    prof.lap('decode-step')
    prof.end_tick()
    assert prof._mem_dead is True  # pylint: disable=protected-access


def _recompiles(name):
    parsed = metrics.parse_exposition(metrics.expose())
    return _family(parsed, 'skytpu_engine_recompiles_total', fn=name)


def _p_warmup_signatures_are_free_steady_trips_exactly_once(monkeypatch):
    del monkeypatch
    journal = RecordingJournal()
    sentinel = profiling.RecompileSentinel(
        steady_after=8, journal_factory=lambda: journal, disabled=False)
    fn = sentinel.wrap('steady_step', lambda x: x * 2)
    before = _recompiles('steady_step')
    for _ in range(12):
        fn(torch.ones(4))
    snap = sentinel.snapshot()['fns']['steady_step']
    assert snap['compiles'] == 1 and snap['steady_recompiles'] == 0
    assert journal.events == []
    fn(torch.ones(5))
    snap = sentinel.snapshot()['fns']['steady_step']
    assert snap['compiles'] == 2 and snap['steady_recompiles'] == 1
    [(event, fields)] = journal.events
    assert event == 'recompile_detected' and fields['fn'] == 'steady_step'
    assert 'torch.float32[5]' in fields['shapes']
    assert fields['quiet_calls'] >= 8
    assert _recompiles('steady_step') == before + 1
    for _ in range(12):
        fn(torch.ones(5))
    assert sentinel.snapshot()['fns']['steady_step'][
        'steady_recompiles'] == 1
    assert len(journal.events) == 1


def _p_immediate_reshape_is_warmup_not_steady(monkeypatch):
    del monkeypatch
    journal = RecordingJournal()
    sentinel = profiling.RecompileSentinel(
        steady_after=8, journal_factory=lambda: journal, disabled=False)
    fn = sentinel.wrap('prefill', lambda x: x + 1)
    for n in (1, 2, 3, 4):
        fn(torch.ones(n))
    snap = sentinel.snapshot()['fns']['prefill']
    assert snap['compiles'] == 4 and snap['steady_recompiles'] == 0
    assert journal.events == []


def _p_signature_flattens_dicts_and_keeps_modules_whole(monkeypatch):
    del monkeypatch
    sentinel = profiling.RecompileSentinel(steady_after=2, disabled=False,
                                           journal_factory=lambda: None)
    fn = sentinel.wrap('plain', lambda *a: None)
    module = torch.nn.Linear(3, 3)
    cache = {'v': torch.zeros(2, 5), 'k': {'scale': torch.ones(2),
                                           'q': torch.zeros(2, 5, dtype=torch.int8)}}
    for _ in range(3):
        fn(module, cache, [torch.zeros(1, 16, dtype=torch.int32)])
    fn(module, cache, [torch.zeros(1, 32, dtype=torch.int32)])
    snap = sentinel.snapshot()['fns']['plain']
    assert snap['compiles'] == 2 and snap['steady_recompiles'] == 1
    sig = next(iter(snap['signatures']))
    assert sig == ('(Linear, torch.int8[2,5], torch.float32[2], '
                   'torch.float32[2,5], torch.int32[1,16])')
    wide = profiling.RecompileSentinel._signature(  # pylint: disable=protected-access
        ({str(i): torch.zeros(i) for i in range(20)},))
    assert wide.endswith('...+4 leaves)') and wide.count('torch.') == 16


def _p_disabled_wrap_is_identity(monkeypatch):
    del monkeypatch
    sentinel = profiling.RecompileSentinel(disabled=True)
    fn = lambda x: x  # noqa: E731
    assert sentinel.wrap('f', fn) is fn
    assert sentinel.wrap('g', None) is None


def _snapshot_all_phases():
    prof = _profiler(clock=FakeClock(step=0.001), memory_cb=lambda: 4096)
    prof.begin_tick()
    for phase in profiling.PHASES:
        prof.lap(phase)
    prof.end_tick()
    return prof.snapshot()


def _p_collapsed_stacks(monkeypatch):
    del monkeypatch
    lines = profiling.collapsed_stacks(_snapshot_all_phases()).splitlines()
    assert len(lines) == len(profiling.PHASES)
    for line in lines:
        frame, count = line.rsplit(' ', 1)
        assert frame.startswith('engine;') and int(count) > 0
    assert {l.split(';')[1].split(' ')[0] for l in lines} == set(
        profiling.PHASES)


def _p_chrome_trace_is_valid_and_carries_all_phases(monkeypatch):
    del monkeypatch
    trace = profiling.chrome_trace(_snapshot_all_phases(), pid=3)
    blob = json.loads(json.dumps(trace))
    assert blob['displayTimeUnit'] == 'ms'
    bars = [e for e in blob['traceEvents'] if e['ph'] == 'X']
    assert {e['name'] for e in bars} == set(profiling.PHASES)
    for e in bars:
        assert e['dur'] > 0 and e['ts'] > 0 and e['pid'] == 3
    [mem] = [e for e in blob['traceEvents'] if e['ph'] == 'C']
    assert mem['args']['bytes_in_use'] == 4096
    assert profiling.PHASES == ref_profiling.PHASES


PROFILING_CASES = {f.__name__[3:]: f for f in (
    _p_laps_are_exclusive_and_one_read_each,
    _p_idle_ticks_never_enter_the_ring,
    _p_ring_is_bounded_but_aggregates_are_cumulative,
    _p_disable_gate_is_a_noop, _p_env_knobs, _p_quantiles_over_the_ring,
    _p_memory_watermark_and_dead_backend,
    _p_warmup_signatures_are_free_steady_trips_exactly_once,
    _p_immediate_reshape_is_warmup_not_steady,
    _p_signature_flattens_dicts_and_keeps_modules_whole,
    _p_disabled_wrap_is_identity, _p_collapsed_stacks,
    _p_chrome_trace_is_valid_and_carries_all_phases)}


@pytest.mark.parametrize('case', sorted(PROFILING_CASES))
def test_profiling_case(case, monkeypatch):
    PROFILING_CASES[case](monkeypatch)
