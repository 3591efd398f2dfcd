"""The port's replica front on the CPU, against the JAX package (tiny
preset, f32, weights carried across by `models/convert.py`).

- `RoleBudget.from_split` / `for_role` / `as_dict` equal the
  reference's over a grid of splits x slots x chunk widths, and
  `set_role_budget` orders pushes by version as the reference does.
- QoS: the smooth weighted round-robin pop order equals the reference
  `AdmissionQueue`'s for the same submit/pop sequences and
  `SKYTPU_LB_QOS_WEIGHTS` settings; class clamps, deadline defaults,
  header normalisation and config validation are equal.
- Engines: greedy tokens under the budget flips decode -> prefill ->
  mixed equal the JAX engine's (paged and dense), and the decode budget
  caps the busy slots in both.
- HTTP, both fronts (async and threaded) against the reference's same
  front: /generate tokens and concurrent SSE streams equal, a
  keep-alive connection reused, the same status codes, Retry-After and
  error keys for a bad body, an unknown path, a full queue and a
  draining replica, and equal /role_budget morph round trips.
- A client that hangs up (a stream, or /generate) cancels its request
  on both fronts; the slot and its pages come back.  `REPLICA_PATHS`
  and `HEADERS` equal the reference's as sets.
"""
from __future__ import annotations

import contextlib
import http.client
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import async_server as ref_async
from skypilot_tpu.serve import batching_engine as jax_engine
from skypilot_tpu.serve import http_protocol as ref_protocol
from skypilot_tpu.serve import model_server as ref_server
from skypilot_tpu.serve import qos as ref_qos
from skypilot_tpu.serve import roles as ref_roles
from skypilot_tpu.serve import scheduler as ref_scheduler
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.serve import async_server
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import http_protocol
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.serve import qos
from skypilot_tpu_torch.serve import roles
from skypilot_tpu_torch.serve import scheduler

_RNG = np.random.default_rng(20261018)
# Misaligned against prefill chunk 8; the one-token prompt has nothing
# to prefill.
PROMPTS = [(_RNG.integers(1, 250, n).tolist(), new)
           for n, new in ((12, 5), (20, 4), (5, 6), (30, 3), (1, 4))]
# Prefill chunks of PROMPTS at chunk 8 unclamped; the first prompt alone
# takes 11 under the decode budget (one token a piece).
UNCLAMPED_CHUNKS = sum(-(-(len(p) - 1) // 8) for p, _ in PROMPTS)
MODES = {'paged': dict(kv_pages=48, page_size=8), 'dense': {}}
FRONTS = {'async': (async_server.start_background,
                    ref_async.start_background),
          'threaded': (model_server.start_background,
                       ref_server.start_background)}


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
def _stalled(engine):
    """Hold the engine's worker between ticks (a host op that waits):
    queued requests stay queued until the block exits."""
    entered, release = threading.Event(), threading.Event()

    def op():
        entered.set()
        release.wait(120)
    with engine._host_ops_lock:  # pylint: disable=protected-access
        engine._host_ops.append(op)  # pylint: disable=protected-access
    with engine._cond:  # pylint: disable=protected-access
        engine._cond.notify_all()  # pylint: disable=protected-access
    assert entered.wait(60), 'the worker never reached the host op'
    try:
        yield
    finally:
        release.set()


def _slow_ticks(engine, seconds=0.05):
    """Make every decode tick of `engine` take at least `seconds`, so a
    long request is still decoding when the test looks (both engines
    call their step through the `_step` attribute)."""
    step = engine._step  # pylint: disable=protected-access

    def slow_step(*args, **kwargs):
        time.sleep(seconds)
        return step(*args, **kwargs)
    engine._step = slow_step  # pylint: disable=protected-access


def _wait_for(predicate, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


# ------------------------------------------------- protocol and roles


def test_protocol_and_roles_equal_reference():
    assert set(http_protocol.REPLICA_PATHS) == set(ref_protocol.REPLICA_PATHS)
    assert set(http_protocol.HEADERS) == set(ref_protocol.HEADERS)
    for name in ref_protocol.HEADERS:
        assert name in http_protocol.HEADERS
    assert roles.ROLES == ref_roles.ROLES
    assert roles.DEFAULT_ROLE == ref_roles.DEFAULT_ROLE
    assert roles.DEFAULT_SPLITS == ref_roles.DEFAULT_SPLITS
    for value in (None, '', 'prefill', 'decode', 'mixed'):
        assert roles.normalize(value) == ref_roles.normalize(value)
        assert (roles.role_of({'role': value}) ==
                ref_roles.role_of({'role': value}))
    with pytest.raises(ValueError):
        roles.normalize('training')


# ------------------------------------------------------- role budgets


@pytest.mark.parametrize('split', [-0.5, 0.0, 0.1, 0.25, 0.4, 0.5, 0.6,
                                   0.75, 0.9, 1.0, 1.5])
def test_role_budget_from_split_equals_reference(split):
    for slots in (1, 2, 3, 8, 16):
        for chunk in (1, 7, 16, 512):
            for role in roles.ROLES:
                ours = scheduler.RoleBudget.from_split(
                    split, slots=slots, prefill_chunk=chunk, role=role,
                    version=3)
                ref = ref_scheduler.RoleBudget.from_split(
                    split, slots=slots, prefill_chunk=chunk, role=role,
                    version=3)
                assert ours.as_dict() == ref.as_dict()


@pytest.mark.parametrize('role', ['prefill', 'decode', 'mixed'])
def test_role_budget_for_role_equals_reference(role):
    for slots in (1, 2, 8):
        for chunk in (1, 16, 512):
            ours = scheduler.RoleBudget.for_role(role, slots=slots,
                                                 prefill_chunk=chunk)
            ref = ref_scheduler.RoleBudget.for_role(role, slots=slots,
                                                    prefill_chunk=chunk)
            assert ours.as_dict() == ref.as_dict()
    raw = dict(prefill_tokens=0, decode_tokens=-3, role=role, split=2.0,
               version='4')
    assert (scheduler.RoleBudget(**raw).as_dict() ==
            ref_scheduler.RoleBudget(**raw).as_dict())
    with pytest.raises(ValueError):
        scheduler.RoleBudget(1, 1, role='training')


def test_set_role_budget_orders_by_version():
    ours, ref = scheduler.AdmissionQueue(), ref_scheduler.AdmissionQueue()
    pushes = [0, 2, 1, 2, 3, None, 0, 5, 4]
    got = {}
    for name, q, lib in (('ours', ours, scheduler),
                         ('ref', ref, ref_scheduler)):
        trail = []
        for version in pushes:
            budget = (None if version is None else
                      lib.RoleBudget.from_split(0.2 * (version % 5),
                                                slots=4, prefill_chunk=64,
                                                version=version))
            trail.append((q.set_role_budget(budget),
                          q.prefill_tokens_per_tick(64),
                          [q.admission_allowed(b) for b in range(6)],
                          q.stats()['role_budget'],
                          q.stats()['budget_swaps']))
        got[name] = trail
    assert got['ours'] == got['ref']


# ----------------------------------------------------------------- QoS


def _pop_order(lib, ops):
    q = lib.AdmissionQueue()
    order = []
    for i, op in enumerate(ops):
        if op == 'pop':
            request = q.pop()
            order.append(None if request is None else request.request_id)
        else:
            q.submit(lib.Request([1, 2], 4, None, request_id=f'r{i}',
                                 qos_class=op))
    while True:
        request = q.pop()
        if request is None:
            return order
        order.append(request.request_id)


@pytest.mark.parametrize('weights', ['', 'interactive=4,batch=1',
                                     'interactive=1,batch=1',
                                     'interactive=2,batch=3', 'batch=7',
                                     'interactive=x,batch=0'])
def test_weighted_pop_order_equals_reference(monkeypatch, weights):
    monkeypatch.setenv('SKYTPU_LB_QOS_WEIGHTS', weights)
    rng = np.random.default_rng(len(weights))
    for _ in range(4):
        ops = rng.choice(['interactive', 'batch', 'BATCH', None, 'pop'],
                         size=40, p=[0.3, 0.25, 0.05, 0.1, 0.3]).tolist()
        assert _pop_order(scheduler, ops) == _pop_order(ref_scheduler, ops)


def test_qos_clamps_and_defaults_equal_reference(monkeypatch):
    spec = {'batch': {'max_new_tokens': 5, 'deadline_ms': 2000},
            'interactive': {'weight': 3, 'deadline_ms': 750.5}}
    monkeypatch.setenv('SKYTPU_QOS_SPEC', json.dumps(spec))
    assert ({k: v.to_dict() for k, v in qos.engine_config().items()} ==
            {k: v.to_dict() for k, v in ref_qos.engine_config().items()})
    for default in ('', 'batch', 'bogus'):
        monkeypatch.setenv('SKYTPU_QOS_DEFAULT_CLASS', default)
        for header in (None, '', 'batch', ' Batch ', 'INTERACTIVE', 'gold'):
            assert qos.normalize(header) == ref_qos.normalize(header)
            for new, deadline in ((16, None), (3, None), (16, 100.0)):
                ours = scheduler.Request([1], new, None, qos_class=header,
                                         deadline_ms=deadline)
                ref = ref_scheduler.Request([1], new, None,
                                            qos_class=header,
                                            deadline_ms=deadline)
                assert ours.qos_class == ref.qos_class
                assert ours.max_new_tokens == ref.max_new_tokens
                assert ((ours.deadline - ours.submit_time) ==
                        pytest.approx(ref.deadline - ref.submit_time))
    for bad in ([1], {'gold': {}}, {'batch': 3}, {'batch': {'w': 1}},
                {'batch': {'weight': 0}}, {'batch': {'max_new_tokens': 0}},
                {'interactive': {'deadline_ms': -1}}):
        with pytest.raises(ValueError) as ours_err:
            qos.validate_config(bad, 'routers.qos')
        with pytest.raises(ValueError) as ref_err:
            ref_qos.validate_config(bad, 'routers.qos')
        assert str(ours_err.value) == str(ref_err.value)
    qos.validate_config(spec, 'routers.qos')


def test_watchers_replay_and_drop():
    """add_watcher replays what was pushed, later tokens follow in
    order, a raising watcher is dropped and never fails the pusher."""
    request = scheduler.Request([1], 8, None)
    request._push(5)  # pylint: disable=protected-access
    seen, broken = [], []

    def bad(token):
        broken.append(token)
        raise RuntimeError('closed loop')
    request.add_watcher(seen.append)
    request.add_watcher(bad)
    for token in (6, 7):
        request._push(token)  # pylint: disable=protected-access
    request._finish()  # pylint: disable=protected-access
    late = []
    request.add_watcher(late.append)
    assert seen == [5, 6, 7, None]
    assert broken == [5]
    assert late == [5, 6, 7, None]


# ------------------------------------------------------------ engines


def _flip_run(engine, lib):
    """PROMPTS under decode, then prefill, then mixed budgets; returns
    (tokens, stats).  The decode budget clamps every prefill piece to
    one token; the prefill budget caps the busy slots at 1."""
    budget = lib.RoleBudget.for_role
    assert engine.set_role_budget(budget('decode', slots=2,
                                         prefill_chunk=8, version=0))
    try:
        reqs = [engine.submit(p, n) for p, n in PROMPTS]
        reqs[0].result(timeout=300)
        assert engine.set_role_budget(budget('prefill', slots=2,
                                             prefill_chunk=8, version=1))
        reqs[2].result(timeout=300)
        assert engine.set_role_budget(budget('mixed', slots=2,
                                             prefill_chunk=8, version=2))
        assert not engine.set_role_budget(budget('decode', slots=2,
                                                 prefill_chunk=8,
                                                 version=1))
        tokens = [list(r.result(timeout=300)) for r in reqs]
        return tokens, engine.stats()
    finally:
        engine.stop()


@pytest.fixture(scope='module')
def jax_flips(setup):
    jcfg, params, _, _ = setup
    out = {}
    for mode, kw in MODES.items():
        plain = jax_engine.ContinuousBatchingEngine(
            jcfg, params, max_len=64, slots=2, prefill_chunk=8, **kw)
        try:
            unclamped = [list(plain.generate(p, n, timeout=300))
                         for p, n in PROMPTS]
        finally:
            plain.stop()
        flipped, stats = _flip_run(jax_engine.ContinuousBatchingEngine(
            jcfg, params, max_len=64, slots=2, prefill_chunk=8, **kw),
            jax_engine)
        assert flipped == unclamped, mode
        assert stats['prefill_chunks'] > UNCLAMPED_CHUNKS
        out[mode] = unclamped
    return out


@pytest.mark.parametrize('mode', sorted(MODES))
def test_budget_flips_token_exact_vs_jax(setup, jax_flips, mode):
    _, _, tcfg, model = setup
    tokens, stats = _flip_run(batching_engine.ContinuousBatchingEngine(
        tcfg, model, max_len=64, slots=2, prefill_chunk=8, device='cpu',
        **MODES[mode]), batching_engine)
    assert tokens == jax_flips[mode]
    assert stats['prefill_chunks'] > UNCLAMPED_CHUNKS
    assert stats['budget_swaps'] == 3
    assert stats['role_budget']['role'] == 'mixed'
    assert stats['role_budget']['version'] == 2


@pytest.mark.parametrize('framework', ['port', 'jax'])
def test_decode_budget_caps_busy_slots(setup, framework):
    """Under the prefill role's budget (decode_tokens 1) a 2-slot engine
    runs one request and keeps the other queued."""
    jcfg, params, tcfg, model = setup
    if framework == 'jax':
        engine, lib = jax_engine.ContinuousBatchingEngine(
            jcfg, params, max_len=64, slots=2, **MODES['paged']), jax_engine
    else:
        engine, lib = batching_engine.ContinuousBatchingEngine(
            tcfg, model, max_len=64, slots=2, device='cpu',
            **MODES['paged']), batching_engine
    _slow_ticks(engine)   # 40 tokens take >= 2 s
    try:
        engine.set_role_budget(lib.RoleBudget.for_role(
            'prefill', slots=2, prefill_chunk=512))
        with _stalled(engine):
            first = engine.submit(PROMPTS[0][0], 40)
            second = engine.submit(PROMPTS[2][0], 4)
        assert _wait_for(lambda: len(first.tokens) >= 2)
        with _stalled(engine):
            stats = engine.stats()
            assert not first.done.is_set()
            assert (stats['busy_slots'], stats['queued_requests']) == (1, 1)
            assert not second.tokens
        first.result(timeout=300)
        assert len(second.result(timeout=300)) == 4
    finally:
        engine.stop()


# --------------------------------------------------------------- HTTP


def _request(port, method, path, body=None, headers=None, raw=None):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _sse(body: bytes):
    return [line[len(b'data: '):].decode()
            for line in body.split(b'\n') if line.startswith(b'data: ')]


@pytest.fixture(scope='module')
def fronts():
    """The reference's server (tiny, dense continuous batching) and the
    port's on its weights, each behind both fronts; yields
    {front: (ref_port, our_port)} and the two servers."""
    ref = ref_server.ModelServer('tiny', max_len=64, max_batch=2,
                                 continuous_batching=True)
    tcfg = configs.get_config('tiny')
    ours = model_server.ModelServer(
        'tiny', max_len=64, max_batch=2, continuous_batching=True,
        device='cpu', params=convert.from_jax_params(
            tcfg, jax.tree.map(np.asarray, ref.params), device='cpu'))
    ports, stops = {}, []
    for front, (start_ours, start_ref) in FRONTS.items():
        ref_port, ref_stop = start_ref(ref)
        our_port, our_stop = start_ours(ours)
        ports[front] = (ref_port, our_port)
        stops += [ref_stop, our_stop]
    yield ports, ref, ours
    for stop in stops:
        stop()
    ours.close()
    ref.close()


@pytest.mark.parametrize('front', sorted(FRONTS))
def test_front_generate_and_streams_equal_reference(fronts, front,
                                                    monkeypatch):
    ports, ref, ours = fronts
    body = {'prompt_ids': [PROMPTS[1][0]], 'max_new_tokens': 6}
    outs = []
    for port in ports[front]:
        code, headers, raw = _request(port, 'POST', '/generate', body,
                                      {'X-SkyTPU-Request-Id': 'gen-1'})
        assert code == 200 and headers['X-SkyTPU-Request-Id'] == 'gen-1'
        outs.append(json.loads(raw))
    assert outs[0]['tokens'] == outs[1]['tokens']
    assert set(outs[0]) == set(outs[1])
    # An LB-routed batch-class request: the class's budget clamps it to
    # the first 3 tokens, and the routing facts land in its span.
    monkeypatch.setenv('SKYTPU_QOS_SPEC', json.dumps(
        {'batch': {'max_new_tokens': 3}}))
    rid = f'routed-{front}'
    routed = {'X-SkyTPU-Request-Id': rid, 'X-SkyTPU-QoS-Class': 'batch',
              'X-SkyTPU-Routed-Role': 'decode', 'X-SkyTPU-Affinity': 'hit',
              'X-SkyTPU-Handoff-Ms': '12.5', 'X-SkyTPU-Attempt': '1'}
    spans = []
    for server, port in zip((ref, ours), ports[front]):
        code, _, raw = _request(port, 'POST', '/generate', body, routed)
        assert code == 200
        assert json.loads(raw)['tokens'][0] == outs[0]['tokens'][0][:3]
        engine = server._engine  # pylint: disable=protected-access
        assert _wait_for(lambda e=engine: e.span(rid) is not None)
        spans.append({k: engine.span(rid).get(k) for k in (
            'routed_role', 'affinity_hit', 'handoff_ms', 'attempt',
            'tokens', 'status')})
    assert spans[0] == spans[1]
    assert spans[1]['routed_role'] == 'decode' and spans[1]['attempt'] == 1
    # Three concurrent streams on two slots (one waits its turn).
    streams = [{'prompt_ids': [PROMPTS[i][0]], 'max_new_tokens': 5}
               for i in (0, 3, 4)]
    got = {}
    for side, port in zip(('ref', 'ours'), ports[front]):
        results = [None] * len(streams)

        def run(i, port=port, results=results):
            results[i] = _request(port, 'POST', '/generate_stream',
                                  streams[i])
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(streams))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        got[side] = [(code, _sse(raw)) for code, _, raw in results]
    assert got['ours'] == got['ref']
    assert all(code == 200 and events[-1] == '[DONE]'
               for code, events in got['ours'])


@pytest.mark.parametrize('front', sorted(FRONTS))
def test_front_keep_alive_reuses_connection(fronts, front):
    ports, _, _ = fronts
    for port in ports[front]:
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
        try:
            conn.request('GET', '/health')
            first = conn.getresponse()
            assert first.status == 200
            json.loads(first.read())
            sock = conn.sock
            conn.request('POST', '/generate', body=json.dumps(
                {'prompt_ids': [[3, 1, 4]], 'max_new_tokens': 2}))
            second = conn.getresponse()
            assert second.status == 200
            json.loads(second.read())
            assert sock is not None and conn.sock is sock
        finally:
            conn.close()


def test_connection_close_generate_leaves_no_reader_error(fronts, caplog):
    """A /generate with Connection: close (the LB's routed path) answers,
    and the disconnect watchdog's read is gone before the connection
    reads again: asyncio logs no second reader on the stream."""
    ports, _, _ = fronts
    with caplog.at_level(logging.ERROR, logger='asyncio'):
        for _ in range(2):
            status, _, body = _request(
                ports['async'][1], 'POST', '/generate',
                {'prompt_ids': [[3, 1, 4]], 'max_new_tokens': 2},
                headers={'Connection': 'close'})
            assert status == 200 and len(json.loads(body)['tokens'][0]) == 2
        time.sleep(0.2)
    assert not [r for r in caplog.records if r.name == 'asyncio']


@pytest.mark.parametrize('front', sorted(FRONTS))
def test_front_errors_equal_reference(fronts, front):
    """Bad body, unknown path, full queue and draining replica: the same
    status, Retry-After and error keys as the reference's same front."""
    ports, ref, ours = fronts

    def answer(port, path, raw):
        code, headers, body = _request(port, 'POST', path, raw=raw)
        return code, 'Retry-After' in headers, sorted(json.loads(body))

    gen = json.dumps({'prompt_ids': [[5, 6]], 'max_new_tokens': 2}).encode()
    for path, raw in (('/generate', b'{not json'), ('/nowhere', b'{}'),
                      ('/generate', b'{}'), ('/generate_stream', b'{}'),
                      ('/generate_text', json.dumps({'prompt': ''}).encode()),
                      ('/role_budget',
                       json.dumps({'role': 'training'}).encode())):
        ref_answer, our_answer = (answer(p, path, raw)
                                  for p in ports[front])
        assert our_answer == ref_answer, (path, raw)
        assert our_answer[0] in (400, 404)
    # A full queue: the worker held, one request queued at max_queue 1.
    full = {}
    for side, server, port in (('ref', ref, ports[front][0]),
                               ('ours', ours, ports[front][1])):
        engine = server._engine  # pylint: disable=protected-access
        engine._queue.max_queue = 1  # pylint: disable=protected-access
        try:
            with _stalled(engine):
                queued = threading.Thread(
                    target=_request, args=(port, 'POST', '/generate'),
                    kwargs={'raw': gen})
                queued.start()
                assert _wait_for(lambda e=engine: len(e._queue) == 1)  # pylint: disable=protected-access
                full[side] = answer(port, '/generate', gen)
            queued.join(120)
            assert not queued.is_alive()
        finally:
            engine._queue.max_queue = 0  # pylint: disable=protected-access
    assert full['ours'] == full['ref'] == (429, True, ['error'])
    # A draining replica: 503 + Retry-After on every generation route.
    drained = {}
    for side, server, port in (('ref', ref, ports[front][0]),
                               ('ours', ours, ports[front][1])):
        code, _, body = _request(port, 'POST', '/drain', {})
        assert code == 200
        assert json.loads(body) == {'draining': True, 'inflight': 0}
        try:
            drained[side] = [answer(port, path, gen) for path in (
                '/generate', '/generate_stream', '/generate_text')]
            drained[side].append(json.loads(
                _request(port, 'GET', '/health')[2])['draining'])
        finally:
            server.draining = False
    assert drained['ours'] == drained['ref']
    assert drained['ours'][0][:2] == (503, True)


def test_role_budget_morph_round_trip_equals_reference(fronts):
    """The reference's morph round trip on both fronts: a morph flips
    the advertised role without a restart, a stale push is dropped,
    unknown roles and malformed versions are 400s, generation still
    works, and a resume push re-opens a draining replica."""
    ports, ref, ours = fronts
    trails = {}
    for side, server, index in (('ref', ref, 0), ('ours', ours, 1)):
        trail = []
        for front in sorted(FRONTS):
            port = ports[front][index]
            server.role = 'prefill'
            server._engine.set_role_budget(None)  # pylint: disable=protected-access

            def post(body, port=port):
                code, _, raw = _request(port, 'POST', '/role_budget', body)
                return code, json.loads(raw)
            trail.append(post({'role': 'decode', 'version': 1}))
            health = json.loads(_request(port, 'GET', '/')[2])
            trail.append((health['role'],
                          health['engine']['role_budget']))
            trail.append(post({'role': 'prefill', 'version': 0}))
            trail.append(post({'role': 'training'})[0])
            trail.append(post({'version': 'nope'})[0])
            trail.append(post({'split': 0.75, 'version': 2}))
            trail.append(post({'prefill_tokens': 3, 'decode_tokens': 1,
                               'version': 3}))
            code, _, raw = _request(port, 'POST', '/generate', {
                'prompt_ids': [[3, 5]], 'max_new_tokens': 3})
            trail.append((code, json.loads(raw)['tokens']))
            _request(port, 'POST', '/drain', {})
            trail.append(json.loads(_request(port, 'GET', '/')[2])[
                'draining'])
            trail.append(post({'role': 'decode', 'resume': True,
                               'version': 4}))
            trail.append(json.loads(_request(port, 'GET', '/')[2])[
                'draining'])
        server._engine.set_role_budget(None)  # pylint: disable=protected-access
        server.role = 'mixed'
        trails[side] = trail
    assert trails['ours'] == trails['ref']
    assert trails['ours'][0][1]['morphed'] is True


def test_role_budget_requires_continuous_batching(setup):
    _, _, _, model = setup
    server = model_server.ModelServer('tiny', max_len=64, device='cpu',
                                      params=model)
    for start in (model_server.start_background,
                  async_server.start_background):
        port, stop = start(server)
        try:
            code, _, raw = _request(port, 'POST', '/role_budget',
                                    {'split': 0.5})
            assert code == 400 and 'continuous' in json.loads(raw)['error']
            assert _request(port, 'POST', '/generate', {
                'prompt_ids': [[3, 5]], 'max_new_tokens': 2})[0] == 200
        finally:
            stop()
    server.close()


# -------------------------------------------------------- disconnects


@pytest.fixture(scope='module')
def paged_server(setup):
    """A paged port server whose ticks take >= 50 ms, so a 40-token
    request is still decoding when its client hangs up."""
    _, _, _, model = setup
    server = model_server.ModelServer(
        'tiny', max_len=64, max_batch=2, continuous_batching=True,
        kv_pages=48, page_size=8, device='cpu', params=model)
    _slow_ticks(server.engine)
    yield server
    server.close()


@pytest.mark.parametrize('route', ['/generate_stream', '/generate'])
@pytest.mark.parametrize('front', sorted(FRONTS))
def test_client_disconnect_frees_slot_and_pages(paged_server, front,
                                                route):
    server = paged_server
    engine = server.engine
    base = engine.stats()
    assert base['busy_slots'] == 0
    port, stop = FRONTS[front][0](server)
    rid = f'gone-{front}{route.replace("/", "-")}'
    try:
        body = json.dumps({'prompt_ids': [PROMPTS[1][0]],
                           'max_new_tokens': 40}).encode()
        sock = socket.create_connection(('127.0.0.1', port), timeout=60)
        sock.sendall(
            f'POST {route} HTTP/1.1\r\nHost: x\r\n'
            f'Content-Type: application/json\r\n'
            f'Content-Length: {len(body)}\r\n'
            f'X-SkyTPU-Request-Id: {rid}\r\n'
            f'Connection: close\r\n\r\n'.encode() + body)
        if route == '/generate_stream':
            seen = b''
            while seen.count(b'data: ') < 2:
                chunk = sock.recv(4096)
                assert chunk, 'the stream ended before two events'
                seen += chunk
        else:
            assert _wait_for(lambda: engine.stats()['busy_slots'] == 1)
            time.sleep(0.1)
        sock.close()
        assert _wait_for(lambda: engine.span(rid) is not None, 120)
        assert engine.span(rid)['status'] == 'cancelled'
        assert engine.span(rid)['tokens'] < 40
        assert _wait_for(lambda: engine.stats()['busy_slots'] == 0, 120)
        # Pages in use beyond the prefix cache's pinned ones: the slot's
        # pages went back (the cached prompt pages stay pinned).
        stats = engine.stats()
        assert (stats['kv_pages_used'] - stats['kv_pages_pinned'] ==
                base['kv_pages_used'] - base['kv_pages_pinned'] == 0)
        # The freed slot serves the next request.
        code, _, raw = _request(port, 'POST', '/generate', {
            'prompt_ids': [[9, 8, 7]], 'max_new_tokens': 3})
        assert code == 200 and len(json.loads(raw)['tokens'][0]) == 3
    finally:
        stop()


# ---------------------------------------------------------------- main


@pytest.mark.parametrize('flag', [[], ['--http-server', 'threaded']],
                         ids=['default', 'threaded'])
def test_main_serves_async_front_by_default(flag):
    """`python -m ...model_server` serves through the asyncio front
    unless --http-server threaded (the threaded front's responses carry
    BaseHTTPRequestHandler's Server header), and answers /drain and
    /role_budget."""
    with socket.socket() as probe:
        probe.bind(('127.0.0.1', 0))
        port = probe.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.model_server',
         '--model', 'tiny', '--device', 'cpu', '--continuous-batching',
         '--kv-pages', '48', '--page-size', '8', '--max-len', '64',
         '--max-batch', '2', '--role', 'prefill', '--port', str(port)]
        + flag, cwd=os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        def up():
            try:
                return _request(port, 'GET', '/health')[0] == 200
            except OSError:
                return False
        assert _wait_for(up, 120), 'the server did not come up'
        code, headers, raw = _request(port, 'GET', '/health')
        assert json.loads(raw)['role'] == 'prefill'
        assert ('BaseHTTP' in headers.get('Server', '')) == bool(flag)
        code, _, raw = _request(port, 'POST', '/role_budget',
                                {'role': 'decode', 'version': 1})
        assert code == 200 and json.loads(raw)['morphed'] is True
        code, _, raw = _request(port, 'POST', '/drain', {})
        assert code == 200 and json.loads(raw)['draining'] is True
        code, headers, _ = _request(port, 'POST', '/generate', {
            'prompt_ids': [[1, 2]], 'max_new_tokens': 2})
        assert code == 503 and headers['Retry-After'] == '5'
    finally:
        proc.terminate()
        proc.wait(30)
