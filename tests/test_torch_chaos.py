"""The chaos core (chaos/faults.py, chaos/injector.py) and the port's
four chaos sites, against the reference's injector, on the CPU.

- One plan JSON arms both injectors; over a scripted sequence of
  `inject` calls (nth, every, where, a seeded probability, max_times,
  every effect but a sleep) the outcomes and the `fault_log` sequences
  are equal, the port's `chaos.jsonl` reads under the reference's
  reader as the reference's own does, and
  `skytpu_chaos_faults_total` counts the fired faults.  Plans, their
  validation errors and the SKYTPU_CHAOS_PLAN forms parse alike.
- The sites behave as the reference's do:
  - `checkpoint.save` raise once: the retry succeeds with 2 attempts
    (tests/unit/test_checkpoints.py:94); raise always: the retries run
    out, the failure is journaled and training goes on (`:121`);
  - `serve.page_pool` deny: `PagesExhausted` from the pool; an engine
    defers the admission and the request completes, and the
    reference's `page_pool_balance` is clean on its journal;
  - `serve.kv_handoff` deny: `HandoffRejected`, and /kv_import answers
    the reference server's status and reason;
  - `serve.rank_exec` raise at rank 1, nth 6: the slice replica fails
    as a unit (tests/unit/test_slice_replica.py:392-398).
About 15 s alone.
"""
from __future__ import annotations

import http.client
import json

import jax
import numpy as np
import pytest

from skypilot_tpu.chaos import faults as ref_faults
from skypilot_tpu.chaos import injector as ref_injector
from skypilot_tpu.chaos import invariants
from skypilot_tpu.observability import events as ref_events
from skypilot_tpu.serve import model_server as jax_server
from skypilot_tpu_torch.chaos import faults
from skypilot_tpu_torch.chaos import injector
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.observability import events
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import cache_manager
from skypilot_tpu_torch.serve import handoff
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.serve import slice_replica

PLAN = json.dumps({'seed': 7, 'name': 'mix', 'faults': [
    {'site': 'checkpoint.save', 'effect': 'raise', 'error': 'OSError',
     'nth': [2, 5]},
    {'site': 'serve.page_pool', 'effect': 'deny', 'probability': 0.3,
     'max_times': 4},
    {'site': 'serve.rank_exec', 'effect': 'raise', 'where': {'rank': 1},
     'every': 3},
    {'site': 'serve.rank_exec', 'effect': 'hang', 'deadline_s': 0.0,
     'error': 'TimeoutError', 'where': {'rank': 0}, 'nth': [4]},
    {'site': 'serve.kv_handoff', 'effect': 'delay', 'probability': 0.5},
    {'site': 'serve.kv_handoff', 'effect': 'preempt', 'nth': [3]},
    {'site': 'provision.create', 'effect': 'raise', 'error': 'RuntimeError',
     'nth': 1},
]})
SITES = ('checkpoint.save', 'serve.page_pool', 'serve.rank_exec',
         'serve.kv_handoff', 'provision.create')


@pytest.fixture(autouse=True)
def _disarmed():
    injector.disarm()
    ref_injector.disarm()
    yield
    injector.disarm()
    ref_injector.disarm()


def _script():
    """A fixed sequence of (site, ctx) calls."""
    rng = np.random.default_rng(3)
    calls = []
    for i in range(80):
        site = SITES[int(rng.integers(len(SITES)))]
        ctx = {'i': i, 'rank': int(rng.integers(2)), 'need': 2,
               'step': i // 4}
        calls.append((site, ctx))
    return calls


def _drive(lib, fault_lib):
    lib.arm(fault_lib.FaultPlan.from_json(PLAN))
    outcomes = []
    for site, ctx in _script():
        try:
            got = lib.inject(site, **ctx)
            outcomes.append('deny' if got is lib.DENY else repr(got))
        except Exception as e:  # pylint: disable=broad-except
            outcomes.append(type(e).__name__)
    return outcomes, lib.fault_log()


def _chaos_counts():
    parsed = metrics.parse_exposition(metrics.expose())
    return dict(parsed.get('skytpu_chaos_faults_total', {}))


def test_one_plan_fires_the_same_faults(monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_HOME', str(tmp_path / 'ref'))
    want, want_log = _drive(ref_injector, ref_faults)
    monkeypatch.setenv('SKYTPU_HOME', str(tmp_path / 'port'))
    before = _chaos_counts()
    got, got_log = _drive(injector, faults)
    after = _chaos_counts()
    assert got == want
    assert got_log == want_log
    assert {r['effect'] for r in got_log} == {'raise', 'deny', 'delay',
                                              'hang', 'preempt'}
    assert len(got_log) >= 10
    fired = {}
    for r in got_log:
        key = (('effect', r['effect']), ('site', r['site']))
        fired[key] = fired.get(key, 0) + 1
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == fired
    # The reference's reader replays the port's chaos journal as its own.
    ours = ref_events.EventJournal(str(
        tmp_path / 'port' / 'events' / 'chaos.jsonl')).read()
    theirs = ref_events.EventJournal(str(
        tmp_path / 'ref' / 'events' / 'chaos.jsonl')).read()
    assert injector.chaos_journal().path == str(
        tmp_path / 'port' / 'events' / 'chaos.jsonl')
    strip = lambda rs: [{k: v for k, v in r.items() if k != 'ts'}
                        for r in rs]
    assert strip(ours) == strip(theirs)
    assert invariants.no_injections(ours)


def test_plans_parse_alike(tmp_path):
    port = faults.FaultPlan.from_json(PLAN)
    ref = ref_faults.FaultPlan.from_json(PLAN)
    assert port.to_json() == ref.to_json()
    assert port.sites() == ref.sites()
    assert sorted(faults.SITES) == sorted(ref_faults.SITES)
    assert faults.EFFECTS == ref_faults.EFFECTS
    path = tmp_path / 'plan.json'
    path.write_text(PLAN)
    for value in (PLAN, f'@{path}', str(path)):
        assert (faults.FaultPlan.from_env_value(value).to_dict() ==
                ref_faults.FaultPlan.from_env_value(value).to_dict())


@pytest.mark.parametrize('bad', [
    {'site': 'nowhere.at_all'},
    {'site': 'checkpoint.save', 'effect': 'explode'},
    {'site': 'checkpoint.save', 'nth': 1, 'every': 2},
    {'site': 'checkpoint.save', 'probability': 1.5},
    {'site': 'checkpoint.save', 'ranks': [1]},
], ids=['site', 'effect', 'selectors', 'probability', 'ranks'])
def test_bad_faults_are_refused_alike(bad):
    with pytest.raises(ValueError) as want:
        ref_faults.Fault(**bad)
    with pytest.raises(ValueError) as got:
        faults.Fault(**bad)
    assert str(got.value) == str(want.value)


def test_a_control_plane_error_is_refused_when_it_fires():
    """The port's sites meet none of the reference's control-plane
    errors: a fault naming one arms, and refuses as the reference
    refuses a name it does not know."""
    plan = {'faults': [{'site': 'checkpoint.save', 'error': 'ProvisionError'}]}
    _arm(**plan['faults'][0])
    with pytest.raises(ValueError, match='Unknown chaos error type'):
        injector.inject('checkpoint.save', step=0)
    assert injector.fault_log()[0]['site'] == 'checkpoint.save'


def test_the_environment_arms_alike(monkeypatch, tmp_path):
    path = tmp_path / 'plan.json'
    path.write_text(PLAN)
    monkeypatch.setenv(faults.PLAN_ENV_VAR, f'@{path}')
    for lib in (injector, ref_injector):
        assert lib.is_armed()
        assert lib.site_armed('serve.page_pool')
        assert not lib.site_armed('skylet.tick')
    monkeypatch.setenv(faults.PLAN_ENV_VAR, '{"faults": [{"site": 1}]}')
    for lib in (injector, ref_injector):
        lib.disarm()
        assert lib.current() is None and lib.fault_log() == []
    monkeypatch.delenv(faults.PLAN_ENV_VAR)
    assert injector.inject('checkpoint.save', step=0) is None


# ------------------------------------------------------------- the sites


def _arm(**fault):
    injector.arm(faults.FaultPlan(seed=0, faults=[faults.Fault(**fault)]))


def _state():
    state, _ = train.create_train_state(configs.get_config('tiny'),
                                        device='cpu')
    return state


def test_checkpoint_save_retries_through_an_injected_fault(tmp_path):
    journal = events.training_journal()
    _arm(site='checkpoint.save', effect='raise', error='OSError', nth=[1])
    with checkpoints.AsyncCheckpointManager(
            str(tmp_path / 'ckpt'), max_retries=3,
            retry_backoff_s=0.01) as mgr:
        mgr.save(0, _state())
        mgr.wait_until_finished()
        assert (mgr.saves_ok, mgr.saves_failed) == (1, 0)
        assert mgr.latest_step() == 0
    assert journal.path.endswith('/events/training.jsonl')
    ends = [e for e in journal.read()
            if e['event'] == 'checkpoint_save_end']
    assert ends[-1]['status'] == 'ok' and ends[-1]['attempts'] == 2
    assert [r['ctx']['attempt'] for r in injector.fault_log()] == [1]
    assert not invariants.checkpoint_liveness(journal.read())


def test_checkpoint_save_exhausts_retries_and_training_goes_on(tmp_path):
    journal = events.training_journal()
    _arm(site='checkpoint.save', effect='raise', error='OSError')
    with checkpoints.AsyncCheckpointManager(
            str(tmp_path / 'ckpt'), max_retries=1,
            retry_backoff_s=0.01) as mgr:
        state = _state()
        mgr.save(0, state)
        mgr.wait_until_finished()
        assert mgr.saves_failed == 1
        assert isinstance(mgr.last_error, OSError)
        assert mgr.save(1, state)   # the step loop keeps going
    ends = [e for e in journal.read()
            if e['event'] == 'checkpoint_save_end']
    assert [(e['status'], e['attempts']) for e in ends] == [
        ('OSError', 2), ('OSError', 2)]
    assert not invariants.checkpoint_liveness(journal.read())


def test_page_pool_deny_is_backpressure(setup):
    _arm(site='serve.page_pool', effect='deny', nth=[1])
    pool = cache_manager.PagePool(8, 4)
    with pytest.raises(cache_manager.PagesExhausted, match='chaos'):
        pool.alloc(2)
    assert pool.alloc(2) == [1, 2]
    # An engine defers the denied admission and serves it after.
    _, model, prompt, want = setup
    _arm(site='serve.page_pool', effect='deny', nth=[1, 2])
    engine = batching_engine.ContinuousBatchingEngine(
        configs.get_config('tiny'), model, device='cpu', **ENGINE_KW)
    try:
        assert engine.generate(prompt, 6) == want
        stats = engine.stats()
        assert stats['pages_exhausted_deferrals'] >= 1
        assert not stats['failed']
    finally:
        engine.stop()
    assert [r['call'] for r in injector.fault_log()] == [1, 2]
    journal = events.get_journal(f'{events.journal_root()}/serve.jsonl')
    records = ref_events.EventJournal(journal.path).read()
    names = [e['event'] for e in records]
    assert 'kv_pages_alloc' in names and 'kv_pages_free' in names
    assert not invariants.page_pool_balance(records)


def _post(port, path, raw):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
    try:
        conn.request('POST', path, body=raw,
                     headers={'Content-Type': 'application/octet-stream'})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


ENGINE_KW = dict(max_len=64, slots=2, prefill_chunk=16, kv_pages=48,
                 page_size=8)
PROMPT = list(range(1, 42))


@pytest.fixture(scope='module')
def setup():
    """The reference's paged server and the port's model on its
    weights, a prompt and the port's greedy tokens for it."""
    ref = jax_server.ModelServer('tiny', max_len=64, max_batch=2,
                                 continuous_batching=True, kv_pages=48,
                                 page_size=8)
    model = convert.from_jax_params(
        configs.get_config('tiny'), jax.tree.map(np.asarray, ref.params),
        device='cpu')
    engine = batching_engine.ContinuousBatchingEngine(
        configs.get_config('tiny'), model, device='cpu', **ENGINE_KW)
    try:
        want = engine.generate(PROMPT, 6)
    finally:
        engine.stop()
    yield ref, model, PROMPT, want
    ref.close()


def test_kv_handoff_deny_is_refused_like_the_reference(setup):
    ref, model, prompt, _ = setup
    ours = model_server.ModelServer(
        'tiny', max_len=64, max_batch=2, continuous_batching=True,
        kv_pages=48, page_size=8, device='cpu', params=model)
    our_port, our_stop = model_server.start_background(ours)
    ref_port, ref_stop = jax_server.start_background(ref)
    try:
        frame = ours.engine.export_prefill(prompt, page_size=8,
                                           binary=True)
        plan = dict(site='serve.kv_handoff', effect='deny')
        ref_injector.arm(ref_faults.FaultPlan(
            faults=[ref_faults.Fault(**plan)]))
        want = _post(ref_port, '/kv_import', frame)
        _arm(**plan)
        got = _post(our_port, '/kv_import', frame)
        assert want[0] == 503
        assert got == want
        decoded = handoff.decode_binary(frame)
        with pytest.raises(batching_engine.HandoffRejected):
            ours.engine.import_pages(decoded['hashes'], 8, decoded['k'],
                                     decoded['v'])
        assert [r['ctx']['pages'] for r in injector.fault_log()] == [
            len(decoded['hashes'])] * 2
        injector.disarm()
        assert _post(our_port, '/kv_import', frame)[0] == 200
    finally:
        our_stop()
        ours.close()
        ref_stop()


def test_rank_death_fails_the_slice_as_a_unit(setup):
    _, model, _, _ = setup
    _arm(site='serve.rank_exec', effect='raise', where={'rank': 1}, nth=[6])
    eng = slice_replica.SliceReplicaEngine(
        configs.get_config('tiny'), model, num_hosts=2,
        sp_threshold=10_000, device='cpu', max_len=128, slots=2,
        prefill_chunk=16)
    try:
        with pytest.raises(RuntimeError, match='rank 1 died'):
            eng.generate(list(range(1, 30)), 20, timeout=60)
        stats = eng.stats()
        assert stats['failed'] is True
        assert stats['slice']['degraded'] is True
        assert stats['slice']['dead_ranks'] == [1]
        with pytest.raises(RuntimeError):
            eng.submit([1, 2, 3], 4)
    finally:
        eng.stop()
    [fired] = injector.fault_log()
    assert (fired['call'], fired['ctx']['rank']) == (6, 1)
