"""Three repaired faults of the port, pinned on the CPU.

- Row blocks (decode ticks past one bucket): on the GPU a decode tick
  whose padded rows exceed one 64-row bucket runs every op whose kernel
  follows the row count once per 64-row block, so every such call has
  the shape of a one-bucket tick whatever B * S is.  These tests switch
  the GPU's row padding on for CPU tensors (`decode._pad_rows`) and
  record the rows each blocked call gets.
- Ticket counters: the paged kernels' counters are kept per (device,
  stream), and a stream's array grows only after that stream has
  synchronised.  Two fake stream handles stand in for CUDA streams.
- The serving environment defaults (C3): `build_parser()`'s defaults
  under each of SKYTPU_SERVE_KV_PAGES, _PAGE_SIZE, _KV_INT8,
  _SPEC_TOKENS and _PREFIX_CACHE, set and unset, equal what the
  reference's `main` hands its ModelServer (its ModelServer and
  serve_forever patched to record); SKYTPU_SERVE_DEFAULT_DEADLINE_MS
  reaps a request without a deadline header with 504 on both fronts;
  SKYTPU_MODEL_FLOPS_PER_TOKEN overrides the FLOPs estimate, and a
  non-numeric value is ignored as the reference ignores it.
"""
from __future__ import annotations

import http.client
import json
import logging
import sys
import time

import pytest
import torch

from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.ops import paged_attention
from skypilot_tpu_torch.serve import async_server
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import model_server

BLOCK = 64


@pytest.fixture(scope='module')
def tiny():
    cfg = configs.get_config('tiny')
    return cfg, init_params(cfg, seed=3, device='cpu')


@pytest.fixture
def gpu_layout(monkeypatch):
    """CPU tensors take the GPU's row layout; returns the list of (rows
    of the whole call, rows handed to one block call, blocked)."""
    calls = []
    by_blocks = decode._by_blocks  # pylint: disable=protected-access

    def spy(fn, x, blocked):
        def record(rows):
            calls.append((x.shape[0], rows.shape[0], blocked))
            return fn(rows)
        return by_blocks(record, x, blocked)

    def pad(x2d):
        pad = (-x2d.shape[0]) % BLOCK
        return torch.cat([x2d, x2d.new_zeros((pad, x2d.shape[1]))])

    monkeypatch.setattr(decode, '_pad_rows', pad)
    monkeypatch.setattr(decode, '_by_blocks', spy)
    return calls


def _one_call(monkeypatch):
    """Back to the CPU's layout, and every op as one call: the
    reference run of a blocked tick."""
    monkeypatch.undo()
    monkeypatch.setattr(decode, '_by_blocks',
                        lambda fn, x, blocked: fn(x))


def _paged(cfg, slots, s_q, quantize_kv=False):
    ps, rows = 8, 8
    pool = decode.init_paged_cache(cfg, 1 + slots * rows, ps, slots, rows,
                                   quantize_kv=quantize_kv, device='cpu')
    gen = torch.Generator().manual_seed(slots * 10 + s_q)
    for slot in range(slots):
        length = int(torch.randint(0, rows * ps - s_q, (1,), generator=gen))
        decode.paged_admit_slot(
            pool, slot, list(range(1 + slot * rows, 1 + (slot + 1) * rows)),
            length)
    tokens = torch.randint(0, cfg.vocab_size, (slots, s_q), generator=gen,
                           dtype=torch.int32)
    return pool, tokens


@pytest.mark.parametrize('slots,s_q', [(2, 5), (16, 1), (16, 5), (13, 5),
                                       (70, 1)])
def test_tick_rows_come_in_fixed_blocks(tiny, gpu_layout, monkeypatch,
                                        slots, s_q):
    """Every blocked call of a paged tick gets exactly one 64-row block,
    whatever B * S; the logits equal the unpadded run's."""
    cfg, model = tiny
    pool, tokens = _paged(cfg, slots, s_q)
    logits, _, _ = decode._paged_forward(  # pylint: disable=protected-access
        cfg, model, tokens, pool, all_positions=True)
    blocked = [(m, r) for m, r, b in gpu_layout if b]
    assert blocked and not [c for c in gpu_layout if not c[2]]
    assert {r for _, r in blocked} == {BLOCK}
    n_rows = -(-slots * s_q // BLOCK) * BLOCK
    # Per layer: two norms, q/k/v/o projections and the MLP; plus the
    # head.  Each runs once per block of the padded rows.
    per_op = n_rows // BLOCK
    assert len(blocked) == per_op * (7 * cfg.n_layers + 1)
    plain_pool, _ = _paged(cfg, slots, s_q)
    _one_call(monkeypatch)
    ref, _, _ = decode._paged_forward(  # pylint: disable=protected-access
        cfg, model, tokens, plain_pool, all_positions=True)
    torch.testing.assert_close(logits, ref, atol=1e-5, rtol=1e-5)


def test_one_bucket_tick_makes_one_call_per_op(tiny, gpu_layout):
    """At B * S <= 64 each op is one call on the padded 64 rows, as
    before the blocks; prefill chunks are never blocked."""
    cfg, model = tiny
    pool, tokens = _paged(cfg, 8, 1)
    decode.paged_batched_step(cfg, model, tokens, pool)
    assert {(m, r, b) for m, r, b in gpu_layout} == {(BLOCK, BLOCK, True)}
    gpu_layout.clear()
    prompt = torch.randint(0, cfg.vocab_size, (1, 100), dtype=torch.int32)
    decode.prefill(cfg, model, prompt, max_len=128)
    # The layers run on the 128 padded rows, the head on the last
    # position's bucket; nothing is blocked.
    assert {(m, r, b) for m, r, b in gpu_layout} == {(128, 128, False),
                                                     (BLOCK, BLOCK, False)}


def test_dense_tick_past_one_bucket(tiny, gpu_layout, monkeypatch):
    cfg, model = tiny
    slots = 70
    cache = decode.init_slot_cache(cfg, slots, 16, device='cpu')
    cache['lengths'][:] = torch.arange(slots, dtype=torch.int32) % 16
    tokens = torch.arange(slots, dtype=torch.int32)[:, None] % 200
    logits, _ = decode.batched_step(cfg, model, tokens, cache)
    assert {r for _, r, b in gpu_layout if b} == {BLOCK}
    _one_call(monkeypatch)
    cache = decode.init_slot_cache(cfg, slots, 16, device='cpu')
    cache['lengths'][:] = torch.arange(slots, dtype=torch.int32) % 16
    ref, _ = decode.batched_step(cfg, model, tokens, cache)
    torch.testing.assert_close(logits, ref, atol=1e-5, rtol=1e-5)


def test_spec_on_equals_spec_off_past_one_bucket(tiny, gpu_layout):
    """16 slots at k = 4 (80 rows, two blocks) against spec off (16
    rows): greedy tokens equal, with the GPU's layout."""
    cfg, model = tiny
    prompts = [list(range(3 + i, 12 + 2 * i)) for i in range(16)]
    out = {}
    for spec in (0, 4):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=64, slots=16, prefill_chunk=16,
            kv_pages=160, page_size=8, quantize_kv=True, spec_tokens=spec,
            device='cpu')
        try:
            handles = [engine.submit(p, 8) for p in prompts]
            out[spec] = [h.result(timeout=300) for h in handles]
        finally:
            engine.stop()
    assert out[0] == out[4]
    assert any(m == 2 * BLOCK and b for m, _, b in gpu_layout)


@pytest.fixture
def tickets(monkeypatch):
    table = {}
    monkeypatch.setattr(paged_attention, '_TICKETS', table)
    return table


def test_ticket_counters_keyed_by_stream(tickets):
    dev = torch.device('cpu')
    syncs = {1: 0, 2: 0}

    def sync(handle):
        def fn():
            syncs[handle] += 1
        return fn

    get = paged_attention._tickets  # pylint: disable=protected-access
    a = get(dev, 1, 16, sync(1))
    b = get(dev, 2, 16, sync(2))
    assert a is not b and a.numel() >= 16 and b.numel() >= 16
    assert int(a.count_nonzero()) == 0 and a.dtype == torch.int32
    assert set(tickets) == {(dev, 1), (dev, 2)}
    # Enough counters already: the same array, no sync.
    assert get(dev, 1, a.numel(), sync(1)) is a and syncs == {1: 0, 2: 0}
    # Stream 1 needs more: it syncs (stream 1 only), then grows.
    grown = get(dev, 1, 4 * a.numel(), sync(1))
    assert grown is not a and grown.numel() >= 4 * a.numel()
    assert syncs == {1: 1, 2: 0}
    assert int(grown.count_nonzero()) == 0
    # Stream 2's array was never replaced.
    assert get(dev, 2, 16, sync(2)) is b and tickets[dev, 2] is b
    assert get(dev, 1, 16, sync(1)) is grown



# ------------------------------------------- C3: the environment defaults

# variable -> the value set in the "set" case
ENV_DEFAULTS = {'SKYTPU_SERVE_KV_PAGES': '96',
                'SKYTPU_SERVE_PAGE_SIZE': '32',
                'SKYTPU_SERVE_KV_INT8': '1',
                'SKYTPU_SERVE_SPEC_TOKENS': '3',
                'SKYTPU_SERVE_PREFIX_CACHE': '0'}
# What each main hands ModelServer from those flags.
SERVER_KWARGS = ('kv_pages', 'page_size', 'quantize_kv', 'spec_tokens',
                 'prefix_caching')


def _main_kwargs(monkeypatch, lib, argv):
    """The ModelServer kwargs `lib.main` builds from `argv` (its
    ModelServer and serve_forever patched to record, nothing served)."""
    seen = {}

    class Recorder:
        def __init__(self, model, **kwargs):
            seen.update(kwargs, model=model)

    monkeypatch.setattr(lib, 'ModelServer', Recorder)
    monkeypatch.setattr(lib, 'serve_forever', lambda *a, **k: None)
    monkeypatch.setattr(sys, 'argv', ['model_server'] + argv)
    lib.main()
    return {k: seen[k] for k in SERVER_KWARGS}


@pytest.mark.parametrize('state', ['set', 'unset'])
@pytest.mark.parametrize('var', sorted(ENV_DEFAULTS))
def test_parser_env_defaults_equal_reference(monkeypatch, var, state):
    from skypilot_tpu.serve import model_server as ref_server
    for name in ENV_DEFAULTS:
        monkeypatch.delenv(name, raising=False)
    if state == 'set':
        monkeypatch.setenv(var, ENV_DEFAULTS[var])
    argv = ['--http-server', 'threaded']
    want = _main_kwargs(monkeypatch, ref_server, argv)
    assert _main_kwargs(monkeypatch, model_server, argv) == want
    args = model_server.build_parser().parse_args([])
    assert (args.kv_pages, args.page_size, args.quantize_kv,
            args.spec_tokens, not args.no_prefix_cache) == tuple(
                want[k] for k in SERVER_KWARGS)
    if state == 'set':
        # The variable moved the default away from the unset one.
        monkeypatch.delenv(var)
        assert _main_kwargs(monkeypatch, model_server, argv) != want


@pytest.mark.parametrize('header', [None, '', 'soon', '0', '-5', '750'])
@pytest.mark.parametrize('env', [None, '2500', 'bogus', '-1'])
def test_deadline_parse_equals_reference(monkeypatch, env, header):
    from skypilot_tpu.serve import async_server as ref_async
    from skypilot_tpu.serve import model_server as ref_server
    if env is None:
        monkeypatch.delenv('SKYTPU_SERVE_DEFAULT_DEADLINE_MS', raising=False)
    else:
        monkeypatch.setenv('SKYTPU_SERVE_DEFAULT_DEADLINE_MS', env)
    headers = {} if header is None else {'X-SkyTPU-Deadline-Ms': header}
    want = ref_async._deadline_ms(  # pylint: disable=protected-access
        {k.lower(): v for k, v in headers.items()})
    assert model_server.parse_deadline_ms(headers) == want
    assert (model_server.default_deadline_ms() ==
            ref_server.default_deadline_ms())


def _slow_ticks(engine, seconds=0.05):
    step = engine._step  # pylint: disable=protected-access

    def slow_step(*args, **kwargs):
        time.sleep(seconds)
        return step(*args, **kwargs)
    engine._step = slow_step  # pylint: disable=protected-access


@pytest.mark.parametrize('front', ['threaded', 'async'])
def test_default_deadline_reaps_without_header(monkeypatch, tiny, front):
    """As tests/unit/test_serve_lifecycle.py holds the reference: with
    SKYTPU_SERVE_DEFAULT_DEADLINE_MS set, a slow request that carries no
    deadline header is answered 504."""
    _, model = tiny
    monkeypatch.setenv('SKYTPU_SERVE_DEFAULT_DEADLINE_MS', '300')
    server = model_server.ModelServer('tiny', device='cpu', params=model,
                                      max_len=256, max_batch=2,
                                      continuous_batching=True)
    _slow_ticks(server.engine)
    start = (async_server.start_background if front == 'async'
             else model_server.start_background)
    port, stop = start(server)
    try:
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        conn.request('POST', '/generate', body=json.dumps(
            {'prompt_ids': [[1, 2, 3, 4]], 'max_new_tokens': 200}),
            headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 504, body
        if front == 'threaded':
            assert body['reason'] == 'deadline_exceeded'
        assert server.engine.stats()['deadline_reaped'] == 1
    finally:
        stop()
        server.close()


@pytest.mark.parametrize('env', [None, '1.5e9', 'bogus'])
def test_flops_override_equals_reference(monkeypatch, caplog, env):
    from skypilot_tpu.models import configs as ref_configs
    from skypilot_tpu.serve import model_server as ref_server
    if env is None:
        monkeypatch.delenv('SKYTPU_MODEL_FLOPS_PER_TOKEN', raising=False)
    else:
        monkeypatch.setenv('SKYTPU_MODEL_FLOPS_PER_TOKEN', env)
    with caplog.at_level(logging.WARNING):
        got = model_server.model_flops_per_token(
            configs.get_config('tiny'), 123456, 512)
    want = ref_server.model_flops_per_token(
        ref_configs.get_config('tiny'), 123456, 512)
    assert got == want
    assert (got == 1.5e9) == (env == '1.5e9')
    assert ('SKYTPU_MODEL_FLOPS_PER_TOKEN' in caplog.text) == (env == 'bogus')
