"""Elastic training (models/elastic.py) against the reference's
`ElasticTrainer`, on the CPU.

The reference's trainer runs over the conftest's 8 virtual JAX devices
and the port's over the indexed CPU entries `cpu:0 ... cpu:7` (the CPU
tests' stand-in for cards), on the schedule of
tests/unit/test_elastic.py: 6 steps on 8 devices, a shrink to 4, 4
steps, an expand to 8, 2 steps, saving every 2 steps.  Both take the
same numpy batches and start from the same parameters and moments (the
reference trainer's initial state loaded into the port trainer's with
`convert.load_reference_train_state`).  Held: every loss within rtol
1e-5 of the reference's, the resumed step, `resumed_from_checkpoint`
and the mesh after each resize equal, the recomputed overlap steps
within 1e-4 of their first run, the journal's (event, from, to, step,
restored, direction) sequence equal to the reference's, the
reference's `resize_monotone_steps` and `checkpoint_liveness` clean on
the port's `training.jsonl`, and `skytpu_gang_resizes_total` counting
one shrink and one expand.

Across hosts: two gloo host processes train under one `ElasticTrainer`
each (data 2 over the hosts, host 0 writes), their `resize` raises
naming A17c-ii, and a one-host trainer over `cpu:0, cpu:1` restores
their newest step bit for bit and continues with the losses of an
uninterrupted one-host run.  45-50 s alone (the reference's run
most of it).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.chaos import invariants
from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models.elastic import ElasticTrainer as JaxElasticTrainer
from skypilot_tpu.observability import events as ref_events
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.models.elastic import ElasticTrainer
from skypilot_tpu_torch.observability import events
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SAVE_EVERY = 8, 32, 2
RTOL = 1e-5
OVERLAP_ATOL = 1e-4
# (devices before the phase, steps) of each phase: 8 -> 4 -> 8.
PHASES = ((8, 6), (4, 4), (8, 2))
JOURNAL_KEYS = ('event', 'from', 'to', 'step', 'restored', 'direction')


def batch_tokens(step: int) -> np.ndarray:
    """The step's batch, the same numpy tokens for both trainers."""
    return np.random.default_rng(1000 + step).integers(
        0, 256, (B, S + 1)).astype(np.int32)


def _adam(opt_state):
    if hasattr(opt_state, 'mu'):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam(sub)
            if found is not None:
                return found
    return None


def _initial_state(jstate):
    """(params, mu, nu, count, step) of a reference TrainState as numpy."""
    adam = _adam(jstate.opt_state)
    params, mu, nu = (jax.tree.map(np.asarray, nn.meta.unbox(t))
                      for t in (jstate.params, adam.mu, adam.nu))
    return params, mu, nu, int(adam.count), int(jstate.step)


def _schedule(trainer, devices, batch_fn):
    """PHASES on `trainer` -> (losses by phase, [(step, resumed, mesh)]
    after each resize)."""
    losses, resumes = [dict(trainer.train_steps(PHASES[0][1], batch_fn))], []
    for (n, steps), reason in zip(PHASES[1:], ('partial preemption',
                                               'capacity returned')):
        trainer.resize(devices[:n], reason=reason)
        resumes.append((trainer.step, trainer.resumed_from_checkpoint,
                        {k: int(v) for k, v in trainer.mesh.shape.items()}))
        losses.append(dict(trainer.train_steps(steps, batch_fn)))
    trainer.close()
    return losses, resumes


def _resizes():
    parsed = metrics.parse_exposition(metrics.expose())
    family = parsed.get('skytpu_gang_resizes_total', {})
    return {d: sum(v for k, v in family.items() if ('direction', d) in k)
            for d in ('shrink', 'expand')}


@pytest.fixture(scope='module')
def runs(tmp_path_factory, gang_started):
    """The reference's and the port's trainers on the same schedule."""
    del gang_started   # the hosts run meanwhile
    root = tmp_path_factory.mktemp('elastic')
    jdevices = jax.devices()
    assert len(jdevices) >= 8
    jjournal = ref_events.EventJournal(str(root / 'ref' / 'training.jsonl'))
    jtrainer = JaxElasticTrainer(
        jax_configs.get_config('tiny'), checkpoint_dir=str(root / 'ref_ckpt'),
        batch_size=B, seq_len=S, save_interval_steps=SAVE_EVERY,
        devices=jdevices[:8], journal=jjournal)
    init = _initial_state(jtrainer.state)
    ref = _schedule(jtrainer, jdevices[:8],
                    lambda step: {'tokens': batch_tokens(step)})

    before = _resizes()
    journal = events.EventJournal(str(root / 'port' / 'training.jsonl'))
    devices = [f'cpu:{i}' for i in range(8)]
    trainer = ElasticTrainer(
        configs.get_config('tiny'), checkpoint_dir=str(root / 'port_ckpt'),
        batch_size=B, seq_len=S, save_interval_steps=SAVE_EVERY,
        devices=devices, journal=journal)
    params, mu, nu, count, step = init
    convert.load_reference_train_state(trainer.state, params, mu, nu,
                                       count=count, step=step)
    port = _schedule(trainer, devices,
                     lambda step: {'tokens': torch.from_numpy(
                         batch_tokens(step))})
    after = _resizes()
    return dict(ref=ref, port=port, ref_events=jjournal.read(),
                port_events=journal.read(), trainer=trainer,
                resizes={d: after[d] - before[d] for d in after})


def test_losses_match_the_reference(runs):
    (want, _), (got, _) = runs['ref'], runs['port']
    for phase_want, phase_got in zip(want, got):
        assert sorted(phase_got) == sorted(phase_want)
        for step, loss in phase_want.items():
            np.testing.assert_allclose(phase_got[step], loss, rtol=RTOL,
                                       err_msg=f'step {step}')


def test_resumes_and_meshes_match_the_reference(runs):
    """The shrink resumes at 5 (saves at even steps, phase 1 ended after
    step 5), fsdp 4; the expand at 9, fsdp 8; both restored."""
    (_, want), (_, got) = runs['ref'], runs['port']
    assert got == want
    assert [(step, restored, mesh['fsdp']) for step, restored, mesh
            in got] == [(5, True, 4), (9, True, 8)]
    assert runs['trainer'].step == 11


def test_recomputed_overlap_steps_match_their_first_run(runs):
    first, second, third = runs['port'][0]
    overlap = set(first) & set(second)
    assert overlap == {5}
    for step in overlap:
        assert abs(first[step] - second[step]) < OVERLAP_ATOL
    assert min(third) >= max(second)


def _projected(records):
    return [tuple(e.get(k) for k in JOURNAL_KEYS) for e in records]


def test_journal_sequence_matches_the_reference(runs):
    got = _projected(runs['port_events'])
    assert got == _projected(runs['ref_events'])
    resizes = [(e['from'], e['to'], e['direction'], e['reason'])
               for e in runs['port_events'] if e['event'] == 'gang_resize']
    assert resizes == [(8, 4, 'shrink', 'partial preemption'),
                       (4, 8, 'expand', 'capacity returned')]
    assert [e['devices'] for e in runs['port_events']
            if e['event'] == 'train_resume'] == [8, 4, 8]


def test_reference_invariants_hold_on_the_port_journal(runs):
    """The reference's reader and checkers replay the port's file."""
    path = str(runs['trainer']._journal.path)  # pylint: disable=protected-access
    replayed = ref_events.EventJournal(path).read()
    assert replayed == runs['port_events']
    assert not invariants.resize_monotone_steps(replayed)
    assert not invariants.checkpoint_liveness(replayed)
    assert all(e['status'] == 'ok' for e in replayed
               if e['event'] == 'checkpoint_save_end')


def test_gang_resizes_are_counted(runs):
    assert runs['resizes'] == {'shrink': 1.0, 'expand': 1.0}


def test_resize_before_any_checkpoint_is_a_fresh_init(tmp_path):
    devices = [f'cpu:{i}' for i in range(8)]
    trainer = ElasticTrainer(configs.get_config('tiny'),
                             checkpoint_dir=str(tmp_path / 'ckpt'),
                             batch_size=B, seq_len=S,
                             save_interval_steps=100, devices=devices,
                             journal=events.EventJournal(
                                 str(tmp_path / 'training.jsonl')))
    try:
        trainer.resize(devices[:4])
        assert not trainer.resumed_from_checkpoint
        assert trainer.step == 0
        assert trainer.mesh.shape['fsdp'] == 4
    finally:
        trainer.close()


def test_a_one_device_mesh_resizes_both_ways(tmp_path):
    """One position (the plain state on its device) -> two -> one: each
    restore is bit-equal to the state that was saved."""
    trainer = ElasticTrainer(configs.get_config('tiny'),
                             checkpoint_dir=str(tmp_path / 'ckpt'),
                             batch_size=4, seq_len=16,
                             save_interval_steps=1, devices=['cpu:0'],
                             journal=events.EventJournal(
                                 str(tmp_path / 'training.jsonl')))
    try:
        first = dict(trainer.train_steps(2))
        trainer.checkpointer.wait_until_finished()
        saved = train.state_digest(trainer.state)
        assert trainer.state.shards is None
        trainer.resize(['cpu:0', 'cpu:1'])
        assert (trainer.step, trainer.mesh.shape['fsdp']) == (2, 2)
        assert train.state_digest(trainer.state) == saved
        second = dict(trainer.train_steps(1))
        trainer.checkpointer.wait_until_finished()
        saved = train.state_digest(trainer.state)
        trainer.resize(['cpu:0'])
        assert trainer.step == 3 and trainer.state.shards is None
        assert train.state_digest(trainer.state) == saved
        third = dict(trainer.train_steps(1))
    finally:
        trainer.close()
    assert sorted(first) + sorted(second) + sorted(third) == [0, 1, 2, 3]


def test_default_batch_is_a_function_of_the_step(tmp_path):
    kw = dict(checkpoint_dir=str(tmp_path / 'ckpt'), batch_size=4,
              seq_len=16, journal=events.EventJournal(
                  str(tmp_path / 'training.jsonl')))
    cfg = configs.get_config('tiny')
    wide = ElasticTrainer(cfg, devices=['cpu:0', 'cpu:1'], **kw)
    narrow = ElasticTrainer(cfg, devices=['cpu:0'], **kw)
    try:
        batch = wide.default_batch(7)['tokens']
        assert batch.dtype == torch.int32 and batch.shape == (4, 17)
        assert int(batch.min()) >= 0 and int(batch.max()) < cfg.vocab_size
        assert torch.equal(batch, narrow.default_batch(7)['tokens'])
        assert not torch.equal(batch, wide.default_batch(8)['tokens'])
    finally:
        wide.close()
        narrow.close()


def test_devices_default_to_every_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ElasticTrainer(configs.get_config('tiny'),
                       checkpoint_dir=str(tmp_path / 'ckpt'))


# ------------------------------------------------------- across hosts

HOSTS = 2
HOST_TIMEOUT_S = 120
GANG_B, GANG_S = 8, 16
_GANG_HOST = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from skypilot_tpu_torch.models import configs, train
    from skypilot_tpu_torch.models.elastic import ElasticTrainer
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    assert distributed.initialize_from_env(device='cpu', timeout=60)
    trainer = ElasticTrainer(
        configs.get_config('tiny'), checkpoint_dir=sys.argv[1],
        mesh_config=mesh_lib.MeshConfig(data=-1), batch_size=%d,
        seq_len=%d, devices=['cpu'], save_interval_steps=1,
        async_save=False)
    losses = trainer.train_steps(2)
    try:
        trainer.resize(['cpu'])
        error = None
    except NotImplementedError as e:
        error = str(e)
    trainer.close()
    print(json.dumps(dict(
        losses=losses, error=error, step=trainer.step,
        local=trainer.mesh.shape, mesh=trainer.mesh.global_shape,
        digest=train.state_digest(trainer.state))), flush=True)
    distributed.shutdown()
""" % (GANG_B, GANG_S))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start_gang(script, root, argv):
    """HOSTS processes of `script` as one gang, started."""
    port = _free_port()
    procs = []
    for rank in range(HOSTS):
        env = {**os.environ, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1',
               'SKYTPU_HOME': str(root / f'home{rank}'),
               distributed.ENV_NUM_HOSTS: str(HOSTS),
               distributed.ENV_HOST_RANK: str(rank),
               distributed.ENV_COORDINATOR_ADDRESS: f'127.0.0.1:{port}'}
        with open(root / f'host{rank}.log', 'w', encoding='utf-8') as log:
            procs.append(subprocess.Popen(
                [sys.executable, '-c', script] + argv, env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def _finish_gang(procs, root):
    """The JSON line each host printed last, once all have exited;
    every process still running is killed, whatever happened."""
    deadline = time.monotonic() + HOST_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = []
    for rank, proc in enumerate(procs):
        text = (root / f'host{rank}.log').read_text()
        assert proc.returncode == 0, text[-4000:]
        outs.append(json.loads(text.strip().splitlines()[-1]))
    return outs


def _one_host(ckpt, steps):
    trainer = ElasticTrainer(
        configs.get_config('tiny'), checkpoint_dir=str(ckpt),
        mesh_config=mesh_lib.MeshConfig(data=-1), batch_size=GANG_B,
        seq_len=GANG_S, devices=['cpu:0', 'cpu:1'], save_interval_steps=1,
        async_save=False, journal=events.EventJournal(
            str(ckpt) + '.training.jsonl'))
    return trainer, trainer.train_steps(steps) if steps else None


@pytest.fixture(scope='module')
def gang_started(tmp_path_factory):
    """The two hosts, started before the reference's run (`runs`) so
    that they train while it compiles; killed at the module's end."""
    root = tmp_path_factory.mktemp('elastic_gang')
    procs = _start_gang(_GANG_HOST, root, [str(root / 'ckpt')])
    yield root, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope='module')
def gang_run(gang_started):
    root, procs = gang_started
    hosts = _finish_gang(procs, root)
    whole, losses = _one_host(root / 'whole', 3)
    whole.close()
    return dict(hosts=hosts, root=root, whole=losses)


def test_a_two_host_checkpoint_resumes_on_one_host(gang_run):
    """Host 0 wrote steps 0-1 on the global data-2 mesh; a one-host
    trainer over two CPU entries restores step 1 bit for bit (the
    hosts' digest) and takes step 2 with the uninterrupted run's loss."""
    hosts, whole = gang_run['hosts'], dict(gang_run['whole'])
    assert hosts[0]['digest'] == hosts[1]['digest']
    for host in hosts:
        assert host['mesh']['data'] == 2 and host['local']['data'] == 1
        assert host['step'] == 2
        for step, loss in host['losses']:
            np.testing.assert_allclose(loss, whole[step], rtol=RTOL)
    trainer, _ = _one_host(gang_run['root'] / 'ckpt', 0)
    try:
        assert trainer.resumed_from_checkpoint and trainer.step == 2
        assert trainer.mesh.shape['data'] == 2 and trainer.mesh.hosts == 1
        assert train.state_digest(trainer.state) == hosts[0]['digest']
        [(step, loss)] = trainer.train_steps(1)
    finally:
        trainer.close()
    assert step == 2
    np.testing.assert_allclose(loss, whole[2], rtol=RTOL)


def test_a_resize_inside_a_host_group_names_a17c_ii(gang_run):
    for host in gang_run['hosts']:
        assert host['error'] and 'A17c-ii' in host['error']
