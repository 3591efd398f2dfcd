"""One-GPU training's data and checkpoint path against the reference,
on the CPU (tiny preset, f32):

- `train_llama.main(['--model', 'tiny', '--init-from', <dir>, '--data',
  <tokens>, ...])` against `jax_train.train_step` from the same params
  over the reference's `HostShardedBatches` on the same file: plain,
  fused CE and accum_steps 2 (loss and grad_norm within rtol 1e-5, f32
  summed in different orders on the two sides).
- Resume through SKYTPU_CHECKPOINT_DIR: exactly (atol 0) the losses and
  final parameters of the port's uninterrupted run, and within rtol
  1e-5 of the reference resumed through its own AsyncCheckpointManager
  and restore_or_init (orbax) in a temporary directory.
- The port's AsyncCheckpointManager, after tests/unit/test_checkpoints.py:
  round trip, no checkpoint, async == sync, interval skipping, retries
  through a fault, exhaustion, blocked accounting, max_to_keep, a
  snapshot that the next step cannot tear, the metric family names.
- Restore paths: a params-only step is refused for resume; a server on
  a training step; `load_pretrained_params`' checks.
"""
from __future__ import annotations

import functools
import os
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.callbacks import base as ref_callbacks
from skypilot_tpu.data import checkpoints as ref_checkpoints
from skypilot_tpu.data import loader as ref_loader
from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.observability import events as ref_events
from skypilot_tpu_torch import train_llama
from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import import_weights
from skypilot_tpu_torch.models import quantize
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.serve import model_server

B, S, STEPS = 4, 16, 4
CLI = ['--model', 'tiny', '--device', 'cpu', '--batch-size', str(B),
       '--seq-len', str(S)]
TRAIN_FLAGS = {'plain': ([], {}),
               'fused': (['--fused-ce', '--vocab-chunk', '96'],
                         {'fused_ce': True, 'vocab_chunk': 96}),
               'accum': (['--accum-steps', '2'], {'accum_steps': 2})}


@pytest.fixture(autouse=True)
def hermetic(monkeypatch, tmp_path):
    """Summaries under tmp_path, fresh callback singletons, no
    checkpoint contract unless a test sets one."""
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path / 'bench_logs'))
    monkeypatch.delenv(checkpoints.ENV_CHECKPOINT_DIR, raising=False)
    monkeypatch.setattr(callbacks, '_instance', None)
    monkeypatch.setattr(ref_callbacks, '_instance', None)


class Journal:
    """A stand-in for the event journal: records append(kind, **f)."""

    def __init__(self):
        self.events = []

    def append(self, kind, **fields):
        self.events.append({'event': kind, **fields})

    def ends(self):
        return [e for e in self.events if e['event'] == 'checkpoint_save_end']


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The reference's initial tiny params (numpy, scan layout)."""
    params = JaxTransformer(jax_configs.get_config('tiny')).init(
        jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))['params']
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture
def init_dir(tmp_path):
    """The reference's initial params saved as the port's checkpoint."""
    d = str(tmp_path / 'init')
    checkpoints.save_params(d, 0, _as_torch(_jax_params()))
    import_weights.save_model_config(d, configs.get_config('tiny'))
    return d


@pytest.fixture
def tokens(tmp_path):
    path = str(tmp_path / 'tokens.bin')
    loader.write_token_file(
        path, np.random.default_rng(5).integers(0, 256, 4096))
    return path


def _jax_run(tokens_path, steps, state=None, start=0, **tcfg_kw):
    """The reference trainer over its HostShardedBatches; -> (state,
    [(loss, grad_norm)])."""
    jtcfg = jax_train.TrainConfig(**tcfg_kw)
    if state is None:
        state = jax_train.TrainState.create(
            apply_fn=JaxTransformer(jax_configs.get_config('tiny')).apply,
            params=_jax_params(), tx=jax_train.make_optimizer(jtcfg))
    batches = ref_loader.HostShardedBatches(
        ref_loader.TokenDataset(tokens_path), global_batch=B, seq_len=S)
    step_fn = jax.jit(functools.partial(jax_train.train_step, tcfg=jtcfg))
    out = []
    for step in range(start, steps):
        state, m = step_fn(state, jax.tree.map(jnp.asarray,
                                               batches.batch_at(step)))
        out.append((float(m['loss']), float(m['grad_norm'])))
    return state, out


def _pairs(history):
    return [(h['loss'], h['grad_norm']) for h in history]


@pytest.mark.parametrize('tc', sorted(TRAIN_FLAGS))
def test_cli_matches_jax_trainer(tc, init_dir, tokens, capsys):
    flags, kw = TRAIN_FLAGS[tc]
    history = train_llama.main(CLI + ['--init-from', init_dir, '--data',
                                      tokens, '--steps', str(STEPS), *flags])
    assert f'initialized params from {init_dir}' in capsys.readouterr().out
    _, ref = _jax_run(tokens, STEPS, **kw)
    assert [h['step'] for h in history] == list(range(STEPS))
    np.testing.assert_allclose(_pairs(history), ref, rtol=1e-5)


def _flat_state(state):
    """Every parameter, both moments and the counts, on the host."""
    out = {'step': state.step}
    for path, p in train.param_paths(state.model):
        name = '/'.join(path)
        out[name] = p.detach().clone()
        st = state.optimizer.state.get(p, {})
        for key in ('exp_avg', 'exp_avg_sq', 'step'):
            if key in st:
                out[f'{key}/{name}'] = st[key].clone()
    return out


def _assert_states_equal(a, b):
    fa, fb = _flat_state(a), _flat_state(b)
    assert sorted(fa) == sorted(fb)
    for key, value in fa.items():
        if torch.is_tensor(value):
            assert value.dtype == fb[key].dtype, key
            assert torch.equal(value, fb[key]), key
        else:
            assert value == fb[key], key


def test_resume_is_exact_and_matches_reference(init_dir, tokens, tmp_path,
                                               monkeypatch, capsys):
    argv = CLI + ['--init-from', init_dir, '--data', tokens]
    whole, state_u = train_llama.run(argv + ['--steps', str(STEPS)])
    callbacks.reset()
    ckpt = str(tmp_path / 'ckpt')
    monkeypatch.setenv(checkpoints.ENV_CHECKPOINT_DIR, ckpt)
    first, state_a = train_llama.run(argv + ['--steps', '1'])
    assert checkpoints.latest_step(ckpt) == 0
    callbacks.reset()
    rest, state_b = train_llama.run(argv + ['--steps', str(STEPS)])
    out = capsys.readouterr().out
    assert 'resuming from step 0' in out and 'resuming from step 1' in out
    assert [h['step'] for h in rest] == list(range(1, STEPS))
    assert _pairs(first + rest) == _pairs(whole)       # atol 0
    _assert_states_equal(state_b, state_u)
    # The step that was restored is run A's final state, bit for bit.
    fresh, _ = train.create_train_state(configs.get_config('tiny'),
                                        device='cpu', seed=1)
    restored, start = checkpoints.restore_or_init(fresh, ckpt)
    assert start == 1
    _assert_states_equal(restored, state_a)

    # The reference resumed through its own manager and restore_or_init.
    ref_dir = str(tmp_path / 'ref_ckpt')
    journal = Journal()
    jstate, ref_first = _jax_run(tokens, 1)
    with ref_checkpoints.AsyncCheckpointManager(
            ref_dir, save_interval_steps=10, journal=journal) as mgr:
        assert mgr.save(0, jstate)
    template, _ = _jax_run(tokens, 0)
    with ref_checkpoints.AsyncCheckpointManager(
            ref_dir, save_interval_steps=10, journal=journal) as mgr:
        jstate, start = mgr.restore_or_init(template)
    assert start == 1
    _, ref_rest = _jax_run(tokens, STEPS, state=jstate, start=1)
    np.testing.assert_allclose(_pairs(first + rest), ref_first + ref_rest,
                               rtol=1e-5)
    assert [e['status'] for e in journal.ends()] == ['ok']


# ------------------------------------------------------------- manager


def _trained_state(steps=2, seed=0):
    """A tiny state after `steps` steps (moments and counts nonzero)."""
    cfg = configs.get_config('tiny')
    state, _ = train.create_train_state(cfg, device='cpu', seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = {'tokens': torch.tensor(rng.integers(0, 256, (2, 9)))}
        state, _ = train.train_step(state, batch)
    return state


def _fresh_state():
    return train.create_train_state(configs.get_config('tiny'),
                                    device='cpu', seed=7)[0]


def test_restore_or_init_round_trip(tmp_path):
    state = _trained_state()
    d = str(tmp_path / 'ckpt')
    mgr = checkpoints.AsyncCheckpointManager(d, save_interval_steps=1)
    assert mgr.save(7, state)
    mgr.close()
    assert mgr.latest_step() == 7
    assert sorted(os.listdir(f'{d}/7')) == [checkpoints.OPTIMIZER_FILE,
                                           checkpoints.PARAMS_FILE]
    with checkpoints.AsyncCheckpointManager(d) as mgr2:
        restored, start = mgr2.restore_or_init(_fresh_state())
    assert start == 8
    _assert_states_equal(restored, state)
    # The AdamW count survives exactly: one more step is bit-equal.
    batch = {'tokens': torch.tensor(np.arange(18).reshape(2, 9))}
    _, m1 = train.train_step(state, batch)
    _, m2 = train.train_step(restored, batch)
    assert float(m1['loss']) == float(m2['loss'])
    _assert_states_equal(restored, state)


def test_restore_or_init_no_checkpoint(tmp_path):
    state = _fresh_state()
    with checkpoints.AsyncCheckpointManager(str(tmp_path / 'none')) as mgr:
        same, start = mgr.restore_or_init(state)
    assert start == 0 and same is state
    with pytest.raises(RuntimeError, match='No checkpoint dir'):
        checkpoints.AsyncCheckpointManager()


def test_checkpoint_dir_contract(monkeypatch, tmp_path):
    assert checkpoints.checkpoint_dir() is None
    monkeypatch.setenv('SKYTPU_CHECKPOINT_DIR', str(tmp_path))
    assert checkpoints.checkpoint_dir() == str(tmp_path)
    with checkpoints.AsyncCheckpointManager() as mgr:
        assert mgr.directory == str(tmp_path)
    assert checkpoints.CHECKPOINT_PATH == ref_checkpoints.CHECKPOINT_PATH
    assert (checkpoints.default_bucket_name('ab12') ==
            ref_checkpoints.default_bucket_name('ab12'))


def test_async_and_sync_saves_are_equivalent(tmp_path):
    state = _trained_state()
    for async_save in (True, False):
        with checkpoints.AsyncCheckpointManager(
                str(tmp_path / str(async_save)),
                async_save=async_save) as mgr:
            assert mgr.save(3, state)
    a = (tmp_path / 'True' / '3')
    s = (tmp_path / 'False' / '3')
    for name in (checkpoints.PARAMS_FILE, checkpoints.OPTIMIZER_FILE):
        assert (a / name).read_bytes() == (s / name).read_bytes()
    restored, start = checkpoints.restore_or_init(_fresh_state(),
                                                  str(tmp_path / 'True'))
    assert start == 4
    _assert_states_equal(restored, state)


def test_save_interval_skips_off_interval_steps(tmp_path, monkeypatch):
    taken = []
    real = train.snapshot
    monkeypatch.setattr(train, 'snapshot',
                        lambda s: taken.append(s.step) or real(s))
    state = _fresh_state()
    with checkpoints.AsyncCheckpointManager(
            str(tmp_path / 'ckpt'), save_interval_steps=3) as mgr:
        assert mgr.save(0, state)
        assert not mgr.save(1, state)
        assert not mgr.save(2, state)
        assert mgr.save(3, state)
        mgr.wait_until_finished()
        assert mgr.latest_step() == 3
    assert len(taken) == 2        # no snapshot off the interval


def _failing_writes(monkeypatch, n_failures):
    calls = []
    real = checkpoints.save_train_step

    def flaky(*args, **kwargs):
        calls.append(args[1])
        if n_failures is None or len(calls) <= n_failures:
            raise OSError('bucket write failed')
        return real(*args, **kwargs)
    monkeypatch.setattr(checkpoints, 'save_train_step', flaky)
    return calls


def test_save_retries_through_a_fault(tmp_path, monkeypatch):
    calls = _failing_writes(monkeypatch, 2)
    journal = Journal()
    with checkpoints.AsyncCheckpointManager(
            str(tmp_path / 'ckpt'), max_retries=3, retry_backoff_s=0.01,
            journal=journal) as mgr:
        mgr.save(0, _fresh_state())
        mgr.wait_until_finished()
        assert (mgr.saves_ok, mgr.saves_failed) == (1, 0)
        assert mgr.latest_step() == 0
    assert calls == [0, 0, 0]
    assert [e['event'] for e in journal.events] == [
        'checkpoint_save_start', 'checkpoint_save_end']
    assert journal.ends()[-1]['status'] == 'ok'
    assert journal.ends()[-1]['attempts'] == 3
    assert not [n for n in os.listdir(tmp_path / 'ckpt')
                if n.startswith('.tmp')]


def test_save_exhausts_retries_without_stopping_training(tmp_path,
                                                         monkeypatch):
    _failing_writes(monkeypatch, None)
    journal = Journal()
    hist = checkpoints.checkpoint_save_hist()
    before = hist.count
    with checkpoints.AsyncCheckpointManager(
            str(tmp_path / 'ckpt'), max_retries=1, retry_backoff_s=0.01,
            journal=journal) as mgr:
        mgr.save(0, _fresh_state())
        mgr.wait_until_finished()
        assert mgr.saves_failed == 1
        assert isinstance(mgr.last_error, OSError)
        assert mgr.save(1, _fresh_state())   # the loop keeps going
    assert any(e['status'] == 'OSError' and e['attempts'] == 2
               for e in journal.ends())
    assert hist.count - before == 2
    assert checkpoints.latest_step(str(tmp_path / 'ckpt')) is None


def test_blocked_in_flight_accounting(tmp_path, monkeypatch):
    real = checkpoints.save_train_step

    def slow(*args, **kwargs):
        time.sleep(0.2)
        return real(*args, **kwargs)
    monkeypatch.setattr(checkpoints, 'save_train_step', slow)
    counter = checkpoints.checkpoint_blocked_counter()
    before = counter.value
    state = _fresh_state()
    with checkpoints.AsyncCheckpointManager(
            str(tmp_path / 'ckpt'), max_in_flight=1) as mgr:
        mgr.save(0, state)
        mgr.save(1, state)
        mgr.wait_until_finished()
    assert mgr.blocked_seconds > 0.05
    assert counter.value - before == pytest.approx(mgr.blocked_seconds)


def test_max_to_keep_prunes_port_steps_only(tmp_path):
    d = tmp_path / 'ckpt'
    (d / '0').mkdir(parents=True)
    (d / '0' / '_CHECKPOINT_METADATA').write_text('{}')   # orbax's
    state = _fresh_state()
    with checkpoints.AsyncCheckpointManager(str(d), max_to_keep=3) as mgr:
        for step in range(1, 6):
            mgr.save(step, state)
    assert sorted(os.listdir(d)) == ['0', '3', '4', '5']
    assert checkpoints.prune_steps(str(d), 1) == [3, 4]
    assert sorted(os.listdir(d)) == ['0', '5']


def test_snapshot_is_not_torn_by_the_next_step(tmp_path, monkeypatch):
    """Save at step k, run step k + 1 while the writer still holds the
    snapshot, wait: the restored state is step k's."""
    state = _trained_state(steps=1)
    at_k = _flat_state(state)
    release = []
    real = checkpoints.save_train_step

    def held(*args, **kwargs):
        deadline = time.time() + 10
        while not release and time.time() < deadline:
            time.sleep(0.01)
        return real(*args, **kwargs)
    monkeypatch.setattr(checkpoints, 'save_train_step', held)
    d = str(tmp_path / 'ckpt')
    with checkpoints.AsyncCheckpointManager(d) as mgr:
        mgr.save(1, state)
        batch = {'tokens': torch.tensor(np.arange(18).reshape(2, 9) % 256)}
        train.train_step(state, batch)      # in place, under the writer
        release.append(True)
    restored, start = checkpoints.restore_or_init(_fresh_state(), d)
    assert start == 2
    got = _flat_state(restored)
    assert sorted(got) == sorted(at_k)
    for key, value in at_k.items():
        assert (torch.equal(got[key], value) if torch.is_tensor(value)
                else got[key] == value), key
    assert not torch.equal(got['embed/embedding'],
                           _flat_state(state)['embed/embedding'])


def test_checkpoint_metric_families_equal_reference():
    assert (checkpoints.checkpoint_save_hist().name ==
            ref_events.checkpoint_save_hist().name)
    assert (checkpoints.checkpoint_blocked_counter().name ==
            ref_events.checkpoint_blocked_counter().name)
    assert (checkpoints.CHECKPOINT_SAVE_BUCKETS ==
            ref_events.CHECKPOINT_SAVE_BUCKETS)


# --------------------------------------------------------- restore paths


def test_params_only_step_is_refused_for_resume(init_dir):
    with pytest.raises(checkpoints.CheckpointFormatError,
                       match='params only.*--init-from'):
        checkpoints.restore_or_init(_fresh_state(), init_dir)


def test_model_server_serves_a_training_step(tmp_path, monkeypatch):
    state = _trained_state(steps=3)
    d = str(tmp_path / 'ckpt')
    monkeypatch.setenv(checkpoints.ENV_CHECKPOINT_DIR, d)
    train_llama.main(CLI + ['--steps', '1'])     # writes model_config.json
    with checkpoints.AsyncCheckpointManager(d) as mgr:
        mgr.save(20, state)
    # The server reads params.safetensors alone.
    tree = checkpoints.restore_params(d, device='cpu')
    assert 'mu' not in tree and 'nu' not in tree
    kw = dict(continuous_batching=True, max_len=64, max_batch=2,
              device='cpu')
    prompts = [[3, 17, 40, 9], [250, 1, 2]]
    served = model_server.ModelServer('auto', checkpoint_dir=d, **kw)
    in_memory = model_server.ModelServer(
        'tiny', params=convert.from_jax_params(
            state.model.cfg, convert.param_tree(state.model), device='cpu'),
        **kw)
    try:
        assert served.cfg == state.model.cfg
        for prompt in prompts:
            got = served.generate([prompt], 8)
            assert got == in_memory.generate([prompt], 8)
            assert len(got[0]) == 8
    finally:
        served.close()
        in_memory.close()


def test_load_pretrained_params_layouts(init_dir, tmp_path):
    cfg = configs.get_config('tiny')
    want = convert.from_jax_params(cfg, _jax_params(), device='cpu',
                                   trainable=True)
    flat = tmp_path / 'flat'
    checkpoints.save_params(str(flat), 0, convert.param_tree(want))
    for d in (init_dir, str(flat)):       # scan layout, then layer_{i}
        state = _fresh_state()
        train.load_pretrained_params(state, d)
        for (_, a), (_, b) in zip(train.param_paths(state.model),
                                  train.param_paths(want)):
            assert a.dtype == torch.float32 and torch.equal(a, b)
        assert not state.optimizer.state and state.step == 0


def test_load_pretrained_params_refusals(tmp_path):
    cfg = configs.get_config('tiny')
    tree = convert.param_tree(train.create_train_state(
        cfg, device='cpu')[0].model)
    missing = {k: v for k, v in tree.items() if k != 'final_norm'}
    checkpoints.save_params(str(tmp_path / 'missing'), 0, missing)
    with pytest.raises(ValueError, match='Checkpoint has .* arrays'):
        train.load_pretrained_params(_fresh_state(), str(tmp_path / 'missing'))
    wide = train.create_train_state(configs.get_config('tiny', d_ff=96),
                                    device='cpu')[0].model
    checkpoints.save_params(str(tmp_path / 'wide'), 0,
                            convert.param_tree(wide))
    with pytest.raises(ValueError, match='Shape mismatch'):
        train.load_pretrained_params(_fresh_state(), str(tmp_path / 'wide'))
    checkpoints.save_params(str(tmp_path / 'int8'), 0,
                            quantize.quantize_params(tree))
    with pytest.raises(ValueError, match='int8'):
        train.load_pretrained_params(_fresh_state(), str(tmp_path / 'int8'))
    with pytest.raises(FileNotFoundError):
        train.load_pretrained_params(_fresh_state(), str(tmp_path / 'none'))


def test_model_auto_needs_init_from(tmp_path):
    with pytest.raises(SystemExit, match='--model auto needs --init-from'):
        train_llama.main(['--model', 'auto', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='No model_config.json'):
        train_llama.main(['--model', 'auto', '--device', 'cpu',
                          '--init-from', str(tmp_path)])
