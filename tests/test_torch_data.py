"""The port's data and telemetry modules against the reference's, on
the CPU: `data/loader.py` (token files byte for byte, batches array for
array, the same rejections), `data/prefetch.py` (the guarantees of
tests/unit/test_prefetch.py, on device='cpu') and `callbacks/base.py`
(summary.json's keys, the init contract, the hooks, the metric
families, the torch.profiler trace)."""
from __future__ import annotations

import itertools
import json
import os
import time

import numpy as np
import pytest
import torch

from skypilot_tpu import exceptions as ref_exceptions
from skypilot_tpu.callbacks import base as ref_callbacks
from skypilot_tpu.data import loader as ref_loader
from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.data import prefetch
from skypilot_tpu_torch.observability import metrics


@pytest.fixture(autouse=True)
def fresh_callbacks(monkeypatch, tmp_path):
    """Both packages' singletons reset, summaries under tmp_path."""
    log_dir = str(tmp_path / 'bench_logs')
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, log_dir)
    monkeypatch.delenv(callbacks.ENV_PROFILE_DIR, raising=False)
    monkeypatch.setattr(callbacks, '_instance', None)
    monkeypatch.setattr(ref_callbacks, '_instance', None)
    yield log_dir


# ------------------------------------------------------------- loader


@pytest.mark.parametrize('high', [2**16, 2**20], ids=['uint16', 'uint32'])
def test_token_file_bytes_equal_reference(tmp_path, high):
    tokens = np.random.default_rng(high).integers(0, high, 3001)
    ours, ref = tmp_path / 'ours.bin', tmp_path / 'ref.bin'
    loader.write_token_file(str(ours), tokens)
    ref_loader.write_token_file(str(ref), tokens)
    assert ours.read_bytes() == ref.read_bytes()
    data = loader.TokenDataset(str(ours))
    assert data.tokens.dtype == (np.uint16 if high == 2**16 else np.uint32)
    assert len(data) == 3001
    np.testing.assert_array_equal(data.window(7, 100), tokens[7:107])


@pytest.mark.parametrize('host_rank,num_hosts', [(0, 1), (1, 2)])
@pytest.mark.parametrize('seed', [0, 3, 11])
def test_batches_equal_reference(tmp_path, seed, host_rank, num_hosts):
    path = str(tmp_path / 'tok.bin')
    loader.write_token_file(
        path, np.random.default_rng(seed).integers(0, 70000, 5000))
    kw = dict(global_batch=6, seq_len=31, host_rank=host_rank,
              num_hosts=num_hosts, seed=seed)
    ours = loader.HostShardedBatches(loader.TokenDataset(path), **kw)
    ref = ref_loader.HostShardedBatches(ref_loader.TokenDataset(path), **kw)
    for step in (0, 1, 2, 9, 1000):
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert got['tokens'].dtype == want['tokens'].dtype == np.int32
        assert got['tokens'].shape == (6 // num_hosts, 32)
        np.testing.assert_array_equal(got['tokens'], want['tokens'])
    for got, step in zip(ours.batches(start_step=5), range(5, 8)):
        np.testing.assert_array_equal(got['tokens'],
                                      ref.batch_at(step)['tokens'])


def _message(fn):
    try:
        fn()
    except Exception as e:  # pylint: disable=broad-except
        return type(e), str(e)
    raise AssertionError('no error raised')


def test_rejections_mirror_reference(tmp_path):
    bad_magic = tmp_path / 'bad_magic.bin'
    bad_magic.write_bytes(b'NOTATOK\n\x02' + b'\x00' * 8)
    bad_size = tmp_path / 'bad_size.bin'
    bad_size.write_bytes(b'SKYTOK1\n\x03' + b'\x00' * 9)
    for path in (bad_magic, bad_size):
        kind, msg = _message(lambda p=path: loader.TokenDataset(str(p)))
        ref_kind, ref_msg = _message(
            lambda p=path: ref_loader.TokenDataset(str(p)))
        assert kind is loader.TokenFileError
        assert ref_kind is ref_exceptions.SkyTpuError
        assert msg == ref_msg
    small = str(tmp_path / 'small.bin')
    loader.write_token_file(small, np.arange(10))
    for kw in (dict(global_batch=2, seq_len=10),
               dict(global_batch=3, seq_len=4, num_hosts=2)):
        got = _message(lambda k=kw: loader.HostShardedBatches(
            loader.TokenDataset(small), **k))
        want = _message(lambda k=kw: ref_loader.HostShardedBatches(
            ref_loader.TokenDataset(small), **k))
        assert got == want and got[0] is ValueError
    with pytest.raises(ValueError, match='1-D'):
        loader.write_token_file(small, np.zeros((2, 2)))


# ------------------------------------------------------------- prefetch


def _cpu(src, **kw):
    return prefetch.DevicePrefetcher(src, device='cpu', **kw)


def test_batches_arrive_in_order_as_tensors():
    src = ({'step': np.full((2,), i, np.int32)} for i in range(50))
    out = list(_cpu(src))
    assert len(out) == 50
    for i, batch in enumerate(out):
        assert isinstance(batch['step'], torch.Tensor)
        assert batch['step'].dtype == torch.int32
        assert batch['step'].tolist() == [i, i]
    mixed = next(_cpu(iter([{'a': np.zeros(2), 'b': torch.ones(3)}])))
    assert torch.equal(mixed['a'], torch.zeros(2, dtype=torch.float64))
    assert torch.equal(mixed['b'], torch.ones(3))


def test_producer_blocks_at_depth():
    """An unbounded source never runs more than `depth` batches ahead of
    the consumer: `depth` staged and one more pulled from the source,
    parked before its copy."""
    produced = []

    def source():
        for i in itertools.count():
            produced.append(i)
            yield {'x': np.full((2,), i)}

    pf = _cpu(source(), depth=2)
    try:
        deadline = time.time() + 5
        while len(produced) < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)            # would overshoot here if unbounded
        assert len(produced) == 3
        assert next(pf)['x'].tolist() == [0, 0]  # frees exactly one slot
        deadline = time.time() + 5
        while len(produced) < 4 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert len(produced) == 4
    finally:
        pf.close()
    assert not pf._thread.is_alive()  # pylint: disable=protected-access


def test_depth_validated():
    with pytest.raises(ValueError, match='depth'):
        _cpu(iter([]), depth=0)


def test_producer_error_propagates_and_repeats():
    def boom():
        yield {'x': np.zeros(2)}
        raise RuntimeError('producer failed')

    pf = _cpu(boom())
    next(pf)
    with pytest.raises(RuntimeError, match='producer failed'):
        next(pf)
    with pytest.raises(RuntimeError, match='producer failed'):
        next(pf)


def test_exhaustion_is_repeatable():
    pf = _cpu(iter([{'x': np.zeros(2)}]))
    next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_loader_alias_is_the_same_class():
    assert loader.DevicePrefetcher is prefetch.DevicePrefetcher
    assert loader.prefetch_to_device is prefetch.prefetch_to_device


def test_consumer_wait_reaches_telemetry():
    cb = callbacks.init()
    wait = metrics.REGISTRY.get('skytpu_train_data_wait_seconds_total')
    before = wait.value

    def slow():
        for i in range(2):
            time.sleep(0.05)
            yield {'x': np.full((1,), i)}

    with prefetch.prefetch_to_device(slow(), device='cpu') as pf:
        assert [b['x'].item() for b in pf] == [0, 1]
    assert cb.prefetch_wait_seconds > 0.02
    assert wait.value - before == pytest.approx(cb.prefetch_wait_seconds)


def test_prefetch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        prefetch.prefetch_to_device(iter([]))


# ------------------------------------------------------------ callbacks


def _summary(log_dir):
    with open(os.path.join(log_dir, callbacks.SUMMARY_FILE),
              encoding='utf-8') as f:
        return json.load(f)


def test_summary_keys_equal_reference(fresh_callbacks, tmp_path):
    cb = callbacks.init(total_steps=5, tokens_per_step=64)
    ref = ref_callbacks.init(log_dir=str(tmp_path / 'ref'), total_steps=5,
                             tokens_per_step=64)
    for c in (cb, ref):
        for _ in range(3):
            with c.step():
                time.sleep(0.002)
        c.flush()
    ours = _summary(fresh_callbacks)
    assert set(ours) == set(_summary(str(tmp_path / 'ref')))
    assert ours['num_steps'] == 3 and ours['total_steps'] == 5
    assert ours['seconds_per_step'] is not None
    assert ours['compute_seconds_per_step'] > 0
    assert ours['tokens_per_s'] == pytest.approx(
        64 / ours['compute_seconds_per_step'])


def test_init_contract(fresh_callbacks):
    with pytest.raises(RuntimeError, match='init'):
        callbacks.on_step_begin()
    callbacks.init()
    cb = callbacks.init(total_steps=9)
    assert cb.total_steps == 9
    with pytest.raises(RuntimeError, match='already initialized'):
        callbacks.init(log_dir='/somewhere/else')
    assert callbacks.init() is cb and cb.log_dir == fresh_callbacks
    callbacks.on_step_begin()
    callbacks.on_step_end()
    with callbacks.step():
        pass
    callbacks.reset()
    assert _summary(fresh_callbacks)['num_steps'] == 2
    assert callbacks.init() is not cb


def test_data_wait_and_peak_reach_summary(fresh_callbacks):
    peak = metrics.REGISTRY.get('skytpu_train_peak_memory_bytes')
    callbacks.record_data_wait(0.25)      # no singleton: metric only
    callbacks.record_peak_memory(7)
    assert peak.value == 7
    cb = callbacks.init()
    callbacks.record_data_wait(0.5)
    callbacks.record_data_wait(0.0)
    callbacks.record_peak_memory(123456)
    cb.flush()
    summary = _summary(fresh_callbacks)
    assert summary['prefetch_wait_seconds'] == 0.5
    assert summary['peak_memory_bytes'] == 123456
    assert peak.value == 123456


def test_train_metric_families_equal_reference():
    ref = {m.name for m in vars(ref_callbacks).values()
           if type(m).__name__ in ('Counter', 'Gauge', 'Histogram')}
    ours = {m.name for m in vars(callbacks).values()
            if isinstance(m, (metrics.Counter, metrics.Gauge,
                              metrics.Histogram))}
    assert ours == ref and len(ours) == 5
    assert all(metrics.REGISTRY.get(name) is not None for name in ours)


def test_profile_dir_writes_a_trace(monkeypatch, tmp_path):
    monkeypatch.setenv(callbacks.ENV_PROFILE_DIR, str(tmp_path / 'trace'))
    cb = callbacks.init()
    with cb.step():
        torch.ones(4).sum()
    path = cb.stop_profiler()
    assert path is not None and os.path.getsize(path) > 0
    with open(path, encoding='utf-8') as f:
        assert 'traceEvents' in json.load(f)
    assert cb.stop_profiler() is None
    callbacks.reset()


def test_profiler_failure_is_never_fatal(monkeypatch, tmp_path, caplog):
    monkeypatch.setenv(callbacks.ENV_PROFILE_DIR, str(tmp_path / 'trace'))

    def broken(*args, **kwargs):
        raise RuntimeError('no profiler here')

    monkeypatch.setattr(torch.profiler, 'profile', broken)
    cb = callbacks.init()
    with cb.step():
        pass
    assert 'trace not started' in caplog.text
    assert cb.stop_profiler() is None

