"""The DCN 'pipeline' axis across hosts (parallel/mesh.py's host blocks,
parallel/pipeline.py's host-to-host boundaries and host-driven
backward, models/train.py's sums over the data and pipeline groups)
against the reference's `pipeline_train_step` on the global mesh, on
the CPU.

Each layout runs as a gang of host processes over gloo (the gang
environment on a free port), each host on its CPU entries and its
stripe of every global batch, from the reference's initial state
(`convert.load_reference_train_state`), three steps at M = 2:

- 'pipeline4-hosts': pipeline 4 over two hosts of two indexed entries
  (`cpu:0`, `cpu:1`), two stages a host: the hop inside a host and the
  hop between hosts, and a copy of the embedding, final norm and head
  on each entry;
- 'pipeline2-hosts-fsdp2': pipeline 2 over two hosts, fsdp 2 inside
  each;
- 'data2-pipeline2-hosts4': data 2 x pipeline 2 over four hosts of one
  entry, which exercises both sub-group families.

Tolerances are tests/test_torch_multihost.py's: loss and grad_norm
within rtol 1e-5; moments rtol 1e-5 / atol 1e-6; params rtol 1e-5 /
atol 3e-5, on the leaves each host holds.  Every host reports the same
digest and clean copies, and a final norm moved on one host after
the run shows in that host's digest alone.  A tied embedding (tiny-gemma) takes a
step on 'pipeline4-hosts' equal to one process over the same global
mesh, and a step saved by two pipeline hosts resumes in two new hosts
with the uninterrupted run's losses and digest and restores onto one
process without hosts bit for bit.

Every host process runs under a timeout and is killed when a test
fails; the gangs start at once and run their jobs as soon as the
reference, whose layouts compile on threads of their own, has written
them.
"""
from __future__ import annotations

import concurrent.futures
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import pipeline as jax_pipeline
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline

import test_torch_multihost as multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS, M = 8, 16, 3, 2
RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-6, 3e-5
HOST_TIMEOUT_S = 150

# name -> (global MeshConfig kwargs, hosts, each host's CPU entries)
CASES = {
    'pipeline4-hosts': (dict(data=1, pipeline=4), 2, ['cpu:0', 'cpu:1']),
    'pipeline2-hosts-fsdp2': (dict(data=1, pipeline=2, fsdp=2), 2,
                              ['cpu', 'cpu']),
    'data2-pipeline2-hosts4': (dict(data=2, pipeline=2), 4, ['cpu']),
}
LAYERS = 4          # tiny at four layers: one or two a stage
PIPE4 = 'pipeline4-hosts'

# A host of a gang (tests/test_torch_multihost_moe.py's too): runs each
# job (a pickle the test writes while the hosts start, renamed into
# place when whole) in argv[1:] in turn, its results pickled to
# <job>.<rank>.  A job names the global mesh, the host's entries, the
# model (and config overrides, `cfg`), the batches and the initial
# state (or a checkpoint directory to resume from), and may save step
# 0 (`save`).  The host counts each step's MoE exchanges and, for a
# `zero_prefix` job, plants a fault: every host dispatches its rows as
# if they came first in the global batch.  After its results the last
# host moves its final norm and every host takes the digest again
# (`drifted`).
_HOST = textwrap.dedent("""
    import os, pickle, sys, time
    import torch
    torch.set_num_threads(1)
    from skypilot_tpu_torch.data import checkpoints
    from skypilot_tpu_torch.models import configs, convert, moe, train
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    EXCHANGES = []
    _init, _place = moe.HostDispatch.__init__, moe.HostDispatch.place


    def counted(self, *args, **kwargs):
        _init(self, *args, **kwargs)
        EXCHANGES.append(self)


    def zero_prefix(self, key, gate_idx, n_experts):
        prefix, n_global = _place(self, key, gate_idx, n_experts)
        return torch.zeros_like(prefix), n_global


    moe.HostDispatch.__init__ = counted


    def wait_for(path):
        deadline = time.monotonic() + 120
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.05)


    def run(path, hosts, rank):
        wait_for(path)
        with open(path, 'rb') as f:
            job = pickle.load(f)
        moe.HostDispatch.place = (zero_prefix if job.get('zero_prefix')
                                  else _place)
        del EXCHANGES[:]
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**job['axes']),
                                   job['devices'])
        cfg = configs.get_config(job['model'], n_layers=job['layers'],
                                 **job.get('cfg', {}))
        tcfg = train.TrainConfig(accum_steps=job['m'])
        state, _ = train.create_train_state(cfg, tcfg, mesh=mesh, seed=1)
        first = 0
        if 'resume' in job:
            wait_for(job['resume'] + '.done')
            state, first = checkpoints.restore_or_init(state, job['resume'])
        elif job.get('init') is not None:
            convert.load_reference_train_state(state, *job['init'][:3],
                                               count=job['init'][3],
                                               step=job['init'][4])
        mgr = (checkpoints.AsyncCheckpointManager(job['save'])
               if 'save' in job else None)
        metrics, saved = [], None
        for step, batch in enumerate(job['batches'][first:], first):
            rows = batch['tokens'].shape[0] // hosts
            mine = {'tokens': torch.tensor(
                batch['tokens'][rank * rows:(rank + 1) * rows])}
            state, m = train.train_step(state, mine, tcfg)
            metrics.append((float(m['loss']), float(m['grad_norm'])))
            if mgr is not None and step == 0:
                mgr.save(0, state)
                saved = train.state_digest(state)
        if mgr is not None:
            mgr.close()
            if rank == 0:
                open(job['save'] + '.done', 'w').close()
        flat = {}
        for leaf, pieces, shape, dtype in train._pieces(state):
            if not pieces:
                continue
            key = '/'.join(leaf)
            p, mu, nu = train._leaf_tensors(state, pieces, shape, dtype, set())
            flat[key], flat['mu/' + key], flat['nu/' + key] = (
                p.numpy(), mu.numpy(), nu.numpy())
        digest, copies = train.state_digest(state), train.check_copies(state)
        # A planted drift: the last host's final norm, which every host
        # holds, moves; the digests are taken again.
        if rank == hosts - 1:
            for leaf, pieces, _, _ in train._pieces(state):
                if leaf[0] == 'final_norm':
                    with torch.no_grad():
                        pieces[0][0].add_(1.0)
        drifted = train.state_digest(state)
        with open(f'{path}.{rank}', 'wb') as f:
            pickle.dump(dict(metrics=metrics, flat=flat, step=state.step,
                             local=dict(mesh.shape),
                             offsets=dict(mesh.offsets),
                             digest=digest, drifted=drifted, saved=saved,
                             copies=copies,
                             reduced=state.host_reduce.take()[1],
                             gathers=[x.gathers for x in EXCHANGES]), f)


    assert distributed.initialize_from_env(device='cpu', timeout=60)
    for path in sys.argv[1:]:
        run(path, *distributed.gang())
    distributed.shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(hosts, jobs, root, tag):
    """`hosts` processes of one gang running _HOST over `jobs`, each
    writing its output to <root>/<tag>.<rank>.log."""
    port = _free_port()
    procs = []
    for rank in range(hosts):
        env = {**os.environ, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1',
               distributed.ENV_NUM_HOSTS: str(hosts),
               distributed.ENV_HOST_RANK: str(rank),
               distributed.ENV_COORDINATOR_ADDRESS: f'127.0.0.1:{port}'}
        env.pop(checkpoints.ENV_CHECKPOINT_DIR, None)
        path = os.path.join(root, f'{tag}.{rank}.log')
        with open(path, 'w', encoding='utf-8') as out:
            procs.append(subprocess.Popen(
                [sys.executable, '-c', _HOST] + jobs, env=env, stdout=out,
                stderr=subprocess.STDOUT))
        procs[-1].log_path = path
    return procs


def _write(path, job) -> None:
    with open(path + '.tmp', 'wb') as f:
        pickle.dump(job, f)
    os.replace(path + '.tmp', path)


def _results(path, hosts):
    out = []
    for rank in range(hosts):
        with open(f'{path}.{rank}', 'rb') as f:
            out.append(pickle.load(f))
    return out


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    return [{'tokens': rng.integers(0, 256, (B, S + 1)).astype(np.int32)}
            for _ in range(STEPS)]


def _reference(axes, batches):
    """(initial state, [(loss, grad_norm)], flat final leaves) of the
    reference's jitted `pipeline_train_step` on the global mesh."""
    jcfg = jax_configs.get_config('tiny', n_layers=LAYERS)
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    jstate, shardings = jax_pipeline.create_pipeline_train_state(
        jcfg, jax_train.TrainConfig(), mesh=jmesh, batch_size=B, seq_len=S)
    jstep = jax.jit(jax_pipeline.pipeline_train_step(jcfg, jmesh, M),
                    in_shardings=(shardings, None),
                    out_shardings=(shardings, None))
    init = multihost._reference_state(jstate)  # pylint: disable=protected-access
    metrics = []
    with jmesh:
        for batch in batches:
            jstate, jm = jstep(jstate, batch)
            metrics.append((float(jm['loss']), float(jm['grad_norm'])))
    cfg = configs.get_config('tiny', n_layers=LAYERS)
    return init, metrics, multihost._flat(  # pylint: disable=protected-access
        cfg, *multihost._reference_state(jstate)[:3])  # pylint: disable=protected-access


def _job(name, batches, model='tiny', **extra):
    axes, _, devices = CASES[name]
    return dict(axes=axes, devices=devices, model=model, layers=LAYERS,
                m=M, batches=batches, **extra)


def _finish(procs, timeout=HOST_TIMEOUT_S):
    try:
        multihost._finish(procs, timeout)  # pylint: disable=protected-access
    finally:
        multihost._kill(procs)  # pylint: disable=protected-access


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{job name: (reference or None, [host results])}: the gangs start
    at once, a two-host gang for the two-host layouts, the tied
    embedding and the save, a four-host gang for data 2 x pipeline 2,
    and two new hosts that resume the saved step."""
    root = str(tmp_path_factory.mktemp('multihost_pipeline'))
    path = lambda name: os.path.join(root, name)  # pylint: disable=unnecessary-lambda-assignment
    ckpt = path('ckpt')
    # The tied embedding first: its job needs no reference, so it runs
    # while the reference compiles.
    two = ['gemma', 'pipeline4-hosts', 'pipeline2-hosts-fsdp2']
    gangs = [_spawn(2, [path(n) for n in two], root, 'two'),
             _spawn(4, [path('data2-pipeline2-hosts4')], root, 'four'),
             _spawn(2, [path('resume')], root, 'resume')]
    refs, batches = {}, {}
    try:
        for i, name in enumerate(CASES):
            batches[name] = _batches(31 + i)
        gemma = _batches(41)[:1]
        _write(path('resume'), _job(PIPE4, batches[PIPE4],
                                    resume=ckpt))
        _write(path('gemma'), _job(PIPE4, gemma, model='tiny-gemma'))
        # The reference's compiles overlap on threads of their own.
        with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
            futures = {pool.submit(_reference, CASES[name][0],
                                   batches[name]): name for name in CASES}
            for future in concurrent.futures.as_completed(futures):
                name = futures[future]
                init, metrics, leaves = future.result()
                extra = {'save': ckpt} if name == PIPE4 else {}
                _write(path(name), _job(name, batches[name], init=init,
                                        **extra))
                refs[name] = (metrics, leaves)
        refs['gemma'] = _one_process_gemma(gemma)
        for gang in gangs:
            _finish(gang)
    finally:
        for gang in gangs:
            multihost._kill(gang)  # pylint: disable=protected-access
    out = {name: (refs.get(name), _results(path(name), CASES[name][1]))
           for name in CASES}
    out['gemma'] = (refs['gemma'], _results(path('gemma'), 2))
    out['resume'] = (ckpt, _results(path('resume'), 2))
    return out


def _one_process_gemma(batches):
    """tiny-gemma's step on the global mesh of 'pipeline4-hosts' in one
    process (four indexed entries, no hosts) from the seed the hosts
    draw their state from: [(loss, grad_norm)] and the flat leaves."""
    cfg = configs.get_config('tiny-gemma', n_layers=LAYERS)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=4),
                               [f'cpu:{i}' for i in range(4)], hosts=1,
                               host_rank=0)
    tcfg = train.TrainConfig(accum_steps=M)
    state, _ = train.create_train_state(cfg, tcfg, mesh=mesh, seed=1)
    metrics = []
    step = pipeline.pipeline_train_step(cfg, mesh, M)
    for batch in batches:
        state, m = step(state, {'tokens': torch.tensor(batch['tokens'])})
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    snap = train.snapshot(state)
    flat = {}
    for prefix, leaves in (('', snap.params), ('mu/', snap.mu),
                           ('nu/', snap.nu)):
        for leaf, t in leaves:
            flat[prefix + '/'.join(leaf)] = t.numpy()
    return metrics, flat


def _hold(name, want_metrics, want, hosts, rtol=RTOL):
    """Each host's metrics and held leaves against `want`; every leaf
    held somewhere; equal digests on every host."""
    held = set()
    for rank, got in enumerate(hosts):
        np.testing.assert_allclose(got['metrics'], want_metrics, rtol=rtol,
                                   err_msg=f'{name} host {rank} loss, '
                                           'grad_norm')
        for key, leaf in got['flat'].items():
            atol = ATOL if key.startswith(('mu/', 'nu/')) else PARAM_ATOL
            np.testing.assert_allclose(leaf, want[key], rtol=rtol, atol=atol,
                                       err_msg=f'{name} host {rank} {key}')
        held |= set(got['flat'])
    assert held == set(want)
    assert len({h['digest'] for h in hosts}) == 1
    assert len({tuple(map(tuple, h['metrics'])) for h in hosts}) == 1


@pytest.mark.parametrize('name', list(CASES))
def test_pipeline_hosts_match_the_reference_on_the_global_mesh(runs, name):
    (want_metrics, want), hosts = runs[name]
    axes, n_hosts, devices = CASES[name]
    _hold(name, want_metrics, want, hosts)
    for rank, got in enumerate(hosts):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), devices,
                                   hosts=n_hosts, host_rank=rank)
        assert got['local'] == mesh.shape
        assert got['offsets'] == mesh.offsets
        assert got['step'] == STEPS


def _hold_drift(hosts):
    """The last host's moved final norm shows in its digest alone: the
    other hosts still agree, on the digest they took before."""
    assert hosts[-1]['drifted'] != hosts[-1]['digest']
    assert {h['drifted'] for h in hosts[:-1]} == {hosts[0]['digest']}


@pytest.mark.parametrize('name', list(CASES))
def test_a_drifted_host_changes_its_digest_alone(runs, name):
    _hold_drift(runs[name][1])


def test_every_host_holds_its_stages_and_the_ends_once(runs):
    """Two stages a host on two indexed entries: each host holds its
    two stages' layers and a copy of each end block on each entry (3
    copies besides the owners); the stages' layers are not reduced
    across hosts (no other host holds them), only the end blocks, the
    loss, the denominator and the clip's norm are."""
    _, hosts = runs['pipeline4-hosts']
    layers = [{k.split('/')[0] for k in h['flat']
               if k.startswith('layer_')} for h in hosts]
    assert layers == [{'layer_0', 'layer_1'}, {'layer_2', 'layer_3'}]
    cfg = configs.get_config('tiny', n_layers=LAYERS)
    ends = (2 * cfg.vocab_size * cfg.d_model + cfg.d_model) * 4
    for got in hosts:
        assert got['copies'] == 3
        # Per step: denominator 4, the norm's layer squares 4, the loss
        # 4 and the end blocks' gradients.
        assert got['reduced'] == STEPS * (ends + 12)


def test_a_tied_embedding_across_hosts_matches_one_process(runs):
    """tiny-gemma over 'pipeline4-hosts': the embedding's two stages lie
    on different hosts and meet in the sum over every host."""
    (want_metrics, want), hosts = runs['gemma']
    _hold('gemma', want_metrics, want, hosts)


def test_a_pipeline_step_resumes_across_hosts_and_onto_one_process(
        runs, tmp_path):
    ckpt, resumed = runs['resume']
    (_, _), whole = runs[PIPE4]
    assert checkpoints.latest_step(ckpt) == 0
    for rank, got in enumerate(resumed):
        # Steps 1-2 of the uninterrupted run, and its final state.
        assert got['metrics'] == whole[rank]['metrics'][1:]
        assert got['digest'] == whole[rank]['digest']
    # The step restores onto one process without hosts, bit for bit:
    # the global digest the saving hosts took after step 0.
    cfg = configs.get_config('tiny', n_layers=LAYERS)
    state, _ = train.create_train_state(cfg, device='cpu', seed=1)
    state, start = checkpoints.restore_or_init(state, ckpt)
    assert start == 1
    assert train.state_digest(state) == whole[0]['saved']
    assert len({h['saved'] for h in whole}) == 1


@pytest.mark.parametrize('axes,local,hosts,want,offsets', [
    (dict(data=1, pipeline=4), 2, 2, dict(pipeline=2),
     [dict(data=0, pipeline=0), dict(data=0, pipeline=2)]),
    (dict(data=2, pipeline=2), 1, 4, {},
     [dict(data=d, pipeline=p) for d in range(2) for p in range(2)]),
    (dict(data=-1, pipeline=2, fsdp=2), 2, 2, dict(fsdp=2),
     [dict(data=0, pipeline=0), dict(data=0, pipeline=1)]),
    (dict(data=-1, pipeline=2), 4, 2, dict(data=2, pipeline=2),
     [dict(data=0, pipeline=0), dict(data=2, pipeline=0)]),
])
def test_a_host_holds_a_block_of_the_dcn_axes(axes, local, hosts, want,
                                              offsets):
    """Host h holds global positions [h n, (h + 1) n): whole stages of
    some data coordinates, or consecutive stages of one, with the
    reference's global sizes and every ICI axis whole."""
    n = hosts * local
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    for rank in range(hosts):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes),
                                   ['cpu'] * local, hosts=hosts,
                                   host_rank=rank)
        assert mesh.global_shape == dict(jmesh.shape)
        assert {k: v for k, v in mesh.shape.items() if v > 1} == want
        assert mesh.offsets == offsets[rank]
        data_hosts, pipe_hosts = mesh.host_grid
        assert divmod(rank, pipe_hosts) == (
            mesh.offsets['data'] // mesh.shape['data'],
            mesh.offsets['pipeline'] // mesh.shape['pipeline'])
        assert data_hosts * pipe_hosts == hosts


def test_a_dcn_grid_the_hosts_cannot_block_raises():
    """Three (data, pipeline) coordinates a host over data 3 x pipeline 2
    cross a data coordinate's stages."""
    with pytest.raises(ValueError, match='whole stages'):
        mesh_lib.build_mesh(mesh_lib.MeshConfig(data=3, pipeline=2),
                            ['cpu'] * 3, hosts=2, host_rank=0)


def test_host_groups_cover_the_grid():
    """The data group of a pipeline coordinate and the pipeline group
    of a data coordinate, without a process group (no collectives)."""
    groups = distributed.HostGroups(2, 2)
    assert groups.data_ranks == [[0, 2], [1, 3]]
    assert groups.pipeline_ranks == [[0, 1], [2, 3]]
    solo = distributed.HostGroups(1, 2)
    assert solo.data(1) is distributed.SOLO
    assert distributed.all_reduce_sum_([torch.ones(2)],
                                       distributed.SOLO) == 0
    assert distributed.all_gather(torch.arange(3)).tolist() == [[0, 1, 2]]
