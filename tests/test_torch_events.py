"""The flight recorder (observability/events.py, utils/timeline.py's
`write_trace`) and the serving journals, against the reference's, on
the CPU.

- For the same appends, the port's and the reference's journals hold
  the same records once `ts` is set aside, on disk and in the tail;
  each side's `read` reads the other's file.  Rotation at
  SKYTPU_EVENT_JOURNAL_MAX_BYTES, corrupt lines skipped, the bounded
  tail, `journal_root` under SKYTPU_HOME, `ControlSpan`'s start/end
  records (status and error on an exception), `format_timeline`,
  `to_chrome_trace_events` and the exported trace file equal the
  reference's.  The checkpoint instruments have one definition.
- Serving journals: with SKYTPU_SERVE_PAGE_EVENTS and
  SKYTPU_SERVE_HANDOFF_EVENTS set, the port's paged server and the
  reference's, over the same prompts on the same weights, journal the
  same events in `serve.jsonl` (the profiling lifecycle, page
  alloc/free with their page counts, a `serve_request_done` per
  request with its token count); the reference's `page_pool_balance`
  and `handoff_consistency` are clean on the port's file.  Without the
  variables the pool journals nothing.  /weights_swap journals its
  lifecycle under SKYTPU_BATCH_EVENTS.
About 15 s alone.
"""
from __future__ import annotations

import http.client
import json
import os

import jax
import numpy as np
import pytest

from skypilot_tpu.chaos import invariants
from skypilot_tpu.observability import events as ref_events
from skypilot_tpu.serve import model_server as jax_server
from skypilot_tpu.utils import timeline as ref_timeline
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.observability import events
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import profiling
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.utils import timeline

APPENDS = [
    ('launch_start', {'cluster': 'c1', 'zones': ['a', 'b']}),
    ('gang_resize', {'from': 8, 'to': 4, 'direction': 'shrink',
                     'reason': None}),
    ('train_resume', {'step': 5, 'devices': 4,
                      'mesh': {'data': 1, 'fsdp': 4}, 'restored': True}),
    ('odd', {'value': 1.5, 'obj': object.__name__, 'flag': False}),
    ('launch_end', {'status': 'ok', 'duration_s': 0.25}),
]


def _strip(records, keys=('ts',)):
    return [{k: v for k, v in r.items() if k not in keys} for r in records]


def _fill(journal):
    for name, fields in APPENDS:
        journal.append(name, **fields)
    return journal


def test_same_appends_same_records(tmp_path):
    ours = _fill(events.EventJournal(str(tmp_path / 'port.jsonl')))
    theirs = _fill(ref_events.EventJournal(str(tmp_path / 'ref.jsonl')))
    assert _strip(ours.read()) == _strip(theirs.read())
    assert _strip(ours.tail()) == _strip(theirs.tail())
    assert _strip(ours.tail(2)) == _strip(theirs.tail(2))
    lines = []
    for path in (ours.path, theirs.path):
        with open(path, encoding='utf-8') as f:
            lines.append(_strip([json.loads(line) for line in f]))
    assert lines[0] == lines[1]
    # Each side reads the other's file.
    assert ref_events.EventJournal(ours.path).read() == ours.read()
    assert events.EventJournal(theirs.path).read() == theirs.read()


def test_rotation_corrupt_lines_and_tail(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_EVENT_JOURNAL_MAX_BYTES', '300')
    sides = {}
    for name, lib in (('port', events), ('ref', ref_events)):
        journal = lib.EventJournal(str(tmp_path / f'{name}.jsonl'),
                                   tail_len=3)
        for i in range(12):
            journal.append('tick', i=i, pad='x' * 20)
        with open(journal.path, 'a', encoding='utf-8') as f:
            f.write('{not json\n\n')
        journal.append('tick', i=12)
        sides[name] = journal
    ours, theirs = sides['port'], sides['ref']
    assert os.path.exists(ours.path + '.1')
    for suffix in ('', '.1'):
        with open(ours.path + suffix, encoding='utf-8') as a, open(
                theirs.path + suffix, encoding='utf-8') as b:
            assert len(a.readlines()) == len(b.readlines())
    assert _strip(ours.read()) == _strip(theirs.read())
    assert [e['i'] for e in ours.tail()] == [10, 11, 12]
    assert ref_events.EventJournal(ours.path).read() == ours.read()


def test_registry_and_scopes(monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_HOME', str(tmp_path / 'home'))
    assert events.journal_root() == ref_events.journal_root()
    assert events.training_journal().path == \
        ref_events.training_journal().path
    for name in ('cluster_journal', 'job_journal', 'cluster_job_journal'):
        assert getattr(events, name)(7).path == \
            getattr(ref_events, name)(7).path
    assert events.skylet_journal().path == ref_events.skylet_journal().path
    assert events.get_journal(events.training_journal().path) is \
        events.training_journal()
    assert profiling.serve_journal().path == os.path.join(
        ref_events.journal_root(), 'serve.jsonl')


def _span(lib, journal, fail):
    try:
        with lib.ControlSpan(journal, 'provision', cluster='c') as span:
            span.add(zone='z1')
            if fail:
                raise ValueError('boom')
    except ValueError:
        pass


@pytest.mark.parametrize('fail', [False, True], ids=['ok', 'raises'])
def test_control_span_records(tmp_path, fail):
    got = events.EventJournal(str(tmp_path / 'port.jsonl'))
    want = ref_events.EventJournal(str(tmp_path / 'ref.jsonl'))
    _span(events, got, fail)
    _span(ref_events, want, fail)
    keys = ('ts', 'duration_s')
    assert _strip(got.read(), keys) == _strip(want.read(), keys)
    end = got.read()[-1]
    assert end['status'] == ('ValueError' if fail else 'ok')
    assert (end.get('error') == 'boom') == fail


def test_rendering_equals_the_reference(tmp_path):
    records = [dict(ts=1700000000.0 + 0.5 * i, seq=i, event=name,
                    **fields) for i, (name, fields) in enumerate(APPENDS)]
    assert events.format_timeline(records) == \
        ref_events.format_timeline(records)
    assert events.format_timeline([]) == []
    assert events.to_chrome_trace_events(records) == \
        ref_events.to_chrome_trace_events(records)
    events.export_chrome_trace(records, str(tmp_path / 'port.json'))
    ref_events.export_chrome_trace(records, str(tmp_path / 'ref.json'))
    assert (tmp_path / 'port.json').read_text() == \
        (tmp_path / 'ref.json').read_text()
    trace = [{'name': 'x', 'ph': 'i', 'ts': 1}]
    timeline.write_trace(str(tmp_path / 'a' / 't.json'), trace)
    ref_timeline.write_trace(str(tmp_path / 'b' / 't.json'), trace)
    assert (tmp_path / 'a' / 't.json').read_text() == \
        (tmp_path / 'b' / 't.json').read_text()


def test_instruments_have_one_definition():
    """The checkpoint instruments are the flight recorder's, re-exported
    (test_torch_observability.py holds every instrument to the
    reference's name, kind, labels and buckets)."""
    assert checkpoints.checkpoint_save_hist is events.checkpoint_save_hist
    assert (checkpoints.checkpoint_blocked_counter is
            events.checkpoint_blocked_counter)
    assert checkpoints.CHECKPOINT_SAVE_BUCKETS is \
        events.CHECKPOINT_SAVE_BUCKETS
    assert events.gang_resizes() is metrics.REGISTRY.get(
        'skytpu_gang_resizes_total')


# ----------------------------------------------------- serving journals

PROMPTS = [(list(range(1, 42)), 6), (list(range(1, 42)) + [7, 8], 5),
           (list(range(60, 73)), 9), ([5], 3)]


def _post(port, path, body, rid):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        conn.request('POST', path, body=json.dumps(body),
                     headers={'Content-Type': 'application/json',
                              'X-SkyTPU-Request-Id': rid})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _serve(lib, make, home, monkeypatch):
    """A paged server made by `make` under SKYTPU_HOME=`home`, the
    prompts one after another over /generate -> (its serve.jsonl
    records, tokens)."""
    monkeypatch.setenv('SKYTPU_HOME', str(home))
    server = make()
    port, stop = lib.start_background(server)
    tokens = []
    try:
        for i, (ids, n) in enumerate(PROMPTS):
            code, out = _post(port, '/generate', {
                'prompt_ids': [ids], 'max_new_tokens': n}, f'req-{i}')
            assert code == 200, out
            tokens.append(out['tokens'][0])
    finally:
        stop()
        server.close()
    path = os.path.join(str(home), 'events', 'serve.jsonl')
    return ref_events.EventJournal(path).read(), tokens


def _shape(records):
    """What both sides must agree on: the page events with their page
    counts, in order, and the requests with their token counts."""
    pages = [(e['event'], e['n']) for e in records
             if e['event'].startswith('kv_pages_')]
    done = [(e['request_id'], e['status'], e['tokens']) for e in records
            if e['event'] == 'serve_request_done']
    profile = [e['event'] for e in records
               if e['event'].startswith('tick_profile_')]
    return pages, done, profile


def test_serving_journals_equal_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_SERVE_PAGE_EVENTS', '1')
    monkeypatch.setenv('SKYTPU_SERVE_HANDOFF_EVENTS', '1')
    kw = dict(max_len=64, max_batch=2, continuous_batching=True,
              kv_pages=48, page_size=8)
    holder = {}

    def reference():
        holder['ref'] = jax_server.ModelServer('tiny', **kw)
        return holder['ref']

    want, want_tokens = _serve(jax_server, reference, tmp_path / 'ref',
                               monkeypatch)
    model = convert.from_jax_params(
        configs.get_config('tiny'),
        jax.tree.map(np.asarray, holder['ref'].params), device='cpu')
    got, tokens = _serve(model_server, lambda: model_server.ModelServer(
        'tiny', device='cpu', params=model, **kw), tmp_path / 'port',
        monkeypatch)
    assert tokens == want_tokens
    assert _shape(got) == _shape(want)
    pages, done, profile = _shape(got)
    assert profile == ['tick_profile_start', 'tick_profile_end']
    assert [rid for rid, _, _ in done] == [f'req-{i}'
                                           for i in range(len(PROMPTS))]
    assert ('kv_pages_alloc', 6) in pages
    assert not invariants.page_pool_balance(got)
    assert not invariants.handoff_consistency(got)


def test_pages_are_not_journaled_unwatched(monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_HOME', str(tmp_path))
    monkeypatch.delenv('SKYTPU_SERVE_PAGE_EVENTS', raising=False)
    model = init_params(configs.get_config('tiny'), seed=0,
                                        device='cpu')
    engine = batching_engine.ContinuousBatchingEngine(
        configs.get_config('tiny'), model, device='cpu', max_len=64,
        slots=2, prefill_chunk=16, kv_pages=48, page_size=8)
    try:
        engine.generate([1, 2, 3, 4, 5], 3)
    finally:
        engine.stop()
    records = profiling.serve_journal().read()
    assert [e['event'] for e in records] == ['tick_profile_start',
                                             'tick_profile_end']
    assert records[-1]['status'] == 'ok' and records[-1]['ticks'] >= 1


def test_weight_swap_lifecycle_is_journaled(monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_HOME', str(tmp_path / 'home'))
    cfg = configs.get_config('tiny')
    model = init_params(cfg, seed=0, device='cpu')
    ckpt = str(tmp_path / 'ckpt')
    checkpoints.save_params(ckpt, 3, convert.param_tree(model))
    server = model_server.ModelServer('tiny', max_len=64, max_batch=2,
                                      continuous_batching=True,
                                      device='cpu', params=model)
    try:
        server.weights_swap({'checkpoint_dir': ckpt})
        assert not [e for e in profiling.serve_journal().read()
                    if e['event'].startswith('weight_swap_')]
        monkeypatch.setenv('SKYTPU_BATCH_EVENTS', '1')
        server.weights_swap({'checkpoint_dir': ckpt})
    finally:
        server.close()
    swaps = [e for e in profiling.serve_journal().read()
             if e['event'].startswith('weight_swap_')]
    assert [(e['event'], e.get('step'), e.get('status'),
             e.get('weight_epoch')) for e in swaps] == [
        ('weight_swap_start', 3, None, None),
        ('weight_swap_end', None, 'ok', 2)]
    assert not invariants.batch_exactly_once(swaps)
