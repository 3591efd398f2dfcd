"""Multi-host training (parallel/distributed.py, the host parts of
parallel/mesh.py, models/train.py's cross-host sum, train_llama in a
gang) against the reference's sharded step, on the CPU.

Each case spawns two host processes with the gang environment
(SKYTPU_NUM_HOSTS=2, SKYTPU_HOST_RANK, SKYTPU_COORDINATOR_ADDRESS on a
free port), which join one gloo group and run `train_step` on their
part of the global mesh over CPU entries: the global mesh is the one
the reference's jitted sharded step runs over the conftest's virtual
CPU devices, both start from the reference's initial state
(`convert.load_reference_train_state`) and take three steps on the
same numpy batches, each host on its rows.  Tolerances are
test_torch_sharded_train.py's: loss and grad_norm of every step within
rtol 1e-5; the moments after step 3 within rtol 1e-5 / atol 1e-6; the
params within rtol 1e-5 / atol 3e-5 (Adam amplifies the summation
noise of near-zero gradients; the hosts sum their own positions first,
then each other, where GSPMD sums in its own order).  Both hosts' state
digests (`train.state_digest`) are equal in every case.

The CLI: two `train_llama` hosts with `--data` and `--init-from` take
the reference `examples/train_llama.py`'s losses over the global batch
(8 virtual devices, fsdp 2), each host's batches are the reference's
`HostShardedBatches` rows for its rank, and a checkpoint host 0 wrote
in a two-host run resumes in two new hosts with the losses and the
digest of an uninterrupted run.  `sky.launch` of a 2-node task on the
local cloud trains with the port (the twin of
tests/unit/test_gang_distributed_e2e.py).  A layout that puts an ICI
axis across hosts raises naming A17f-iii; 'pipeline' across hosts
(tests/test_torch_multihost_pipeline.py) and an MoE model on hosts
(tests/test_torch_multihost_moe.py) build.

Every host process runs under a timeout of its own and is killed when
a test fails; one pair of hosts runs the reference cases in turn
while the reference computes the next, and every reference case runs
once for the module.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
import types

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
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import pipeline as jax_pipeline
from skypilot_tpu.parallel.sharding import token_batch_sharding
from skypilot_tpu_torch import train_llama
from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS = 8, 16, 3
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 3e-5
HOSTS = 2
HOST_TIMEOUT_S = 150

# name -> (global MeshConfig kwargs, CPU entries a host, SP mode,
# TrainConfig kwargs, masked batches)
CASES = {
    'data2': (dict(data=2), 1, 'ring', {}, False),
    'data4-fsdp2': (dict(data=4, fsdp=2), 4, 'ring', {}, False),
    'data2-seq2-ring': (dict(data=2, sequence=2), 2, 'ring', {}, False),
    'data4-tensor2': (dict(data=4, tensor=2), 4, 'ring', {}, False),
    'fused-ce-accum2-masked': (dict(data=2, fsdp=2), 2, 'ring',
                               {'fused_ce': True, 'vocab_chunk': 96,
                                'accum_steps': 2}, True),
    # Pipeline 2 inside each host, 'data' across them, at two
    # microbatches, on indexed CPU entries (`COPIES`): the embedding,
    # final norm and head have a copy on each stage's entry.
    'pipeline2-data2-copies': (dict(data=2, pipeline=2), 2, 'ring',
                               {'accum_steps': 2}, False),
}
# The cases whose hosts run on indexed CPU entries (cpu:0, cpu:1, ...),
# distinct entries that keep a copy of each replicated block apiece.
COPIES = {'pipeline2-data2-copies'}

# A host of the reference cases, one after another in one group: each
# job (a pickle this test writes while the hosts start, renamed into
# place when whole) in argv[1:], its results pickled to <job>.<rank>.
_CASE_HOST = textwrap.dedent("""
    import os, pickle, sys, time
    import torch
    torch.set_num_threads(1)
    from skypilot_tpu_torch.models import configs, convert, train
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib


    def run(path, hosts, rank):
        deadline = time.monotonic() + 120
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.05)
        with open(path, 'rb') as f:
            job = pickle.load(f)
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**job['axes']),
                                   job['devices'])
        cfg = configs.get_config('tiny', sequence_parallel=job['sp'])
        tcfg = train.TrainConfig(**job['tc'])
        state, _ = train.create_train_state(cfg, tcfg, mesh=mesh, seed=1)
        params, mu, nu, count, step = job['init']
        convert.load_reference_train_state(state, params, mu, nu,
                                           count=count, step=step)
        metrics, reduced = [], []
        for batch in job['batches']:
            rows = next(iter(batch.values())).shape[0] // hosts
            mine = {k: torch.tensor(v[rank * rows:(rank + 1) * rows])
                    for k, v in batch.items()}
            state, m = train.train_step(state, mine, tcfg)
            metrics.append((float(m['loss']), float(m['grad_norm'])))
            reduced.append(state.host_reduce.take()[1])
        snap = train.snapshot(state)
        flat = {}
        for prefix, leaves in (('', snap.params), ('mu/', snap.mu),
                               ('nu/', snap.nu)):
            for leaf, t in leaves:
                flat[prefix + '/'.join(leaf)] = t.numpy()
        with open(f'{path}.{rank}', 'wb') as f:
            pickle.dump(dict(metrics=metrics, flat=flat, count=snap.count,
                             step=state.step, local=dict(mesh.shape),
                             digest=train.state_digest(state),
                             reduced=reduced,
                             copies=train.check_copies(state),
                             params=sum(p.numel() for p in
                                        state.model.parameters())), f)


    assert distributed.initialize_from_env(device='cpu', timeout=60)
    for path in sys.argv[1:]:
        run(path, *distributed.gang())
    distributed.shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(argv, root, tag, extra_env=None):
    """HOSTS processes running `argv` as one gang (a free coordinator
    port), each writing its output to <root>/<tag>.<rank>.log and its
    benchmark log under <root>/<tag>.<rank>.bench."""
    port = _free_port()
    procs = []
    for rank in range(HOSTS):
        env = {**os.environ, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1',
               distributed.ENV_NUM_HOSTS: str(HOSTS),
               distributed.ENV_HOST_RANK: str(rank),
               distributed.ENV_COORDINATOR_ADDRESS: f'127.0.0.1:{port}',
               callbacks.ENV_LOG_DIR: os.path.join(root,
                                                   f'{tag}.{rank}.bench')}
        env.update(extra_env or {})
        path = os.path.join(root, f'{tag}.{rank}.log')
        with open(path, 'w', encoding='utf-8') as out:
            procs.append(subprocess.Popen(
                [sys.executable] + argv, env=env, stdout=out,
                stderr=subprocess.STDOUT))
        procs[-1].log_path = path
    return procs


def _kill(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finish(procs, timeout=HOST_TIMEOUT_S):
    """Each process's output once all have exited within `timeout`;
    kills every one still running, whatever happened."""
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        _kill(procs)
    outs = []
    for rank, proc in enumerate(procs):
        with open(proc.log_path, encoding='utf-8') as f:
            outs.append(f.read())
        assert proc.returncode == 0, (f'host {rank} failed '
                                      f'({proc.returncode}):\n'
                                      f'{outs[-1][-4000:]}')
    return outs


def _summary(out: str) -> dict:
    """The JSON line train_llama prints last on each host of a gang."""
    lines = [l for l in out.splitlines() if l.startswith('{"host"')]
    assert len(lines) == 1, out[-3000:]
    return json.loads(lines[0])


# ------------------------------------------------- the reference's step


def _batches(seed: int, masked: bool):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
        if not masked:
            out.append({'tokens': tokens})
            continue
        mask = (rng.random((B, S)) > 0.25).astype(np.float32)
        out.append({'inputs': tokens[:, :-1], 'targets': tokens[:, 1:],
                    'mask': mask})
    return out


def _adam(opt_state):
    """The ScaleByAdamState inside optax's chain state."""
    if hasattr(opt_state, 'mu'):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam(sub)
            if found is not None:
                return found
    return None


def _numpy(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _reference_state(jstate):
    adam = _adam(jstate.opt_state)
    return (_numpy(jstate.params), _numpy(adam.mu), _numpy(adam.nu),
            int(adam.count), int(jstate.step))


def _flat(cfg, params, mu, nu):
    out = {}
    for prefix, tree in (('', params), ('mu/', mu), ('nu/', nu)):
        for k, v in convert._flat_port_leaves(cfg, tree).items():  # pylint: disable=protected-access
            out[prefix + k] = v
    return out


def _reference(axes, sp_mode, tc, masked, seed):
    """(job for the hosts, [(loss, grad_norm)], flat final leaves) of
    the reference's jitted step on the global mesh (over a pipeline,
    its `pipeline_train_step` at tc's accum_steps microbatches)."""
    jcfg = jax_configs.get_config('tiny', sequence_parallel=sp_mode)
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    if axes.get('pipeline', 1) > 1:
        jstate, shardings = jax_pipeline.create_pipeline_train_state(
            jcfg, jax_train.TrainConfig(), mesh=jmesh, batch_size=B,
            seq_len=S)
        jstep = jax.jit(jax_pipeline.pipeline_train_step(
            jcfg, jmesh, tc['accum_steps']), in_shardings=(shardings, None),
            out_shardings=(shardings, None))
    else:
        jtcfg = jax_train.TrainConfig(**tc)
        jstate, shardings = jax_train.create_train_state(
            jcfg, jtcfg, mesh=jmesh, batch_size=B, seq_len=S)
        jstep = jax_train.jit_train_step(
            shardings, token_batch_sharding(jmesh), jtcfg)
    batches = _batches(seed, masked)
    job = dict(axes=axes, sp=sp_mode, tc=tc, batches=batches,
               init=_reference_state(jstate))
    metrics = []
    with jmesh:
        for batch in batches:
            jstate, jm = jstep(jstate, batch)
            metrics.append((float(jm['loss']), float(jm['grad_norm'])))
    cfg = configs.get_config('tiny', sequence_parallel=sp_mode)
    return job, metrics, _flat(cfg, *_reference_state(jstate)[:3])


@pytest.fixture(scope='module')
def case_runs(tmp_path_factory):
    """{case: (reference metrics, reference leaves, [host results])}:
    one pair of hosts runs every case in turn, each as soon as its
    reference run has written its job."""
    root = str(tmp_path_factory.mktemp('multihost_cases'))
    names = sorted(CASES)
    paths = [os.path.join(root, f'{name}.job') for name in names]
    hosts = _spawn(['-c', _CASE_HOST] + paths, root, 'cases')
    refs = {}
    try:
        for i, (name, path) in enumerate(zip(names, paths)):
            axes, local, sp, tc, masked = CASES[name]
            job, metrics, leaves = _reference(axes, sp, tc, masked,
                                              seed=11 + i)
            job['devices'] = ([f'cpu:{i}' for i in range(local)]
                              if name in COPIES else ['cpu'] * local)
            with open(path + '.tmp', 'wb') as f:
                pickle.dump(job, f)
            os.replace(path + '.tmp', path)
            refs[name] = (metrics, leaves)
        _finish(hosts)
    finally:
        _kill(hosts)
    results = {}
    for name in CASES:
        hosts = []
        for rank in range(HOSTS):
            with open(os.path.join(root, f'{name}.job.{rank}'), 'rb') as f:
                hosts.append(pickle.load(f))
        results[name] = refs[name] + (hosts,)
    return results


@pytest.mark.parametrize('name', sorted(CASES))
def test_two_hosts_match_the_reference_on_the_global_mesh(case_runs, name):
    want_metrics, want, hosts = case_runs[name]
    axes = CASES[name][0]
    for rank, got in enumerate(hosts):
        # Each host's mesh is the global one with 'data' halved.
        assert got['local'] == dict(
            mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes),
                                ['cpu'] * CASES[name][1], hosts=HOSTS,
                                host_rank=rank).shape)
        assert got['local']['data'] * HOSTS == axes['data']
        np.testing.assert_allclose(got['metrics'], want_metrics, rtol=RTOL,
                                   err_msg=f'host {rank} loss, grad_norm')
        assert got['count'] == STEPS and got['step'] == STEPS
        assert sorted(got['flat']) == sorted(want)
        for key, leaf in want.items():
            atol = ATOL if key.startswith(('mu/', 'nu/')) else PARAM_ATOL
            np.testing.assert_allclose(got['flat'][key], leaf, rtol=RTOL,
                                       atol=atol,
                                       err_msg=f'host {rank} {key}')
    # The hosts hold the same bits: equal digests, equal leaves.
    assert hosts[0]['metrics'] == hosts[1]['metrics']
    assert hosts[0]['digest'] == hosts[1]['digest']
    assert all(np.array_equal(hosts[0]['flat'][k], hosts[1]['flat'][k])
               for k in want)


def test_copies_across_hosts_reduce_the_one_copy_bytes(case_runs):
    """Pipeline 2 inside each host on two indexed entries: the ends'
    copies are bit-equal to their owners after the steps, and a step
    reduces across hosts the bytes of one copy a block (every f32
    gradient element once, the loss and the denominator), not of
    every copy."""
    for got in case_runs['pipeline2-data2-copies'][2]:
        assert got['copies'] == 3          # embedding, final norm, head
        assert got['reduced'] == [4 * got['params'] + 8] * STEPS


# ------------------------------------------------------------- layouts


@pytest.mark.parametrize('axes,local,slices,want,hosts', [
    (dict(data=-1), 1, 1, dict(data=1), HOSTS),
    (dict(data=-1, fsdp=2), 4, 1, dict(data=2, fsdp=2), HOSTS),
    (dict(data=-1, sequence=2, tensor=2), 4, 1, dict(data=1, sequence=2,
                                                   tensor=2), HOSTS),
    (dict(data=-1, pipeline=2), 2, 1, dict(data=1, pipeline=2), HOSTS),
    (dict(data=-1, fsdp=2), 2, 2, dict(data=1, fsdp=2), HOSTS),
    (dict(data=-1, fsdp=2), 4, 4, dict(data=2, fsdp=2), HOSTS),
    # 'pipeline' across hosts: a stage a host, two stages a host, and
    # data 2 x pipeline 2 over four hosts.
    (dict(data=1, pipeline=2), 1, 1, dict(data=1, pipeline=1), HOSTS),
    (dict(data=1, pipeline=4), 2, 1, dict(data=1, pipeline=2), HOSTS),
    (dict(data=2, pipeline=2), 1, 1, dict(data=1, pipeline=1), 4),
])
def test_a_host_keeps_its_part_of_the_global_mesh(axes, local, slices, want,
                                                  hosts):
    """The global sizes are the reference's over hosts x local devices
    (its slices made of whole hosts); each host keeps every ICI axis
    whole and its block of the DCN axes: 'data' / hosts, or over a
    pipeline across hosts its stages of one data coordinate."""
    n = hosts * local
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n], num_slices=slices)
    for rank in range(hosts):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes),
                                   ['cpu'] * local, num_slices=slices,
                                   hosts=hosts, host_rank=rank)
        assert mesh.global_shape == dict(jmesh.shape)
        assert {k: v for k, v in mesh.shape.items() if v > 1} == {
            k: v for k, v in want.items() if v > 1}
        assert (mesh.hosts, mesh.host_rank, mesh.size) == (hosts, rank,
                                                           local)


@pytest.mark.parametrize('axes,local,across', [
    (dict(data=-1, sequence=2), 1, 'sequence'),
    (dict(data=1, tensor=2), 1, 'tensor'),
    (dict(data=1, fsdp=2, tensor=2), 2, 'fsdp'),
])
def test_an_axis_across_hosts_names_a17f_ii(axes, local, across):
    """An ICI axis across hosts is the queue's next item: the raise
    names A17f-iii and the axis."""
    with pytest.raises(NotImplementedError, match='A17f-iii') as err:
        mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * local,
                            hosts=HOSTS, host_rank=0)
    assert repr(across) in str(err.value)


def test_global_data_the_hosts_do_not_divide_raises():
    with pytest.raises(ValueError, match='not divisible'):
        mesh_lib.build_mesh(mesh_lib.MeshConfig(data=-1, fsdp=2),
                            ['cpu'] * 3, hosts=HOSTS, host_rank=0)


def test_moe_on_hosts_names_a17f_ii():
    """An MoE model builds its state on a host of a gang, materialised
    and abstract, with the host's cross-host sums."""
    cfg = configs.get_config('tiny-moe')
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(), ['cpu'], hosts=HOSTS,
                               host_rank=1)
    state, _ = train.create_train_state(cfg, mesh=mesh)
    assert state.host_reduce is not None and state.shards is None
    assert state.host_reduce.grid == (HOSTS, 1)
    assert sum(p.numel() for p in state.model.parameters()) == sum(
        p.numel() for p in train.create_train_state(
            cfg, device='cpu')[0].model.parameters())
    abstract, shardings = train.abstract_train_state(cfg, mesh=mesh)
    assert abstract.host_reduce is not None
    assert all(t.device.type == 'meta' for t in abstract.parameters())
    assert set(shardings) == {n for n, _ in
                              abstract.model.named_parameters()}


def test_buckets_cover_every_element_once_in_order():
    """all_reduce_sum_'s buckets: contiguous views of the tensors, in
    order, none over the cap, a tensor larger than the cap in pieces."""
    tensors = [torch.arange(n, dtype=torch.float32) for n in (3, 10, 1, 4)]
    buckets = list(distributed._buckets(tensors, 4))  # pylint: disable=protected-access
    assert all(sum(p.numel() for p in b) <= 4 for b in buckets)
    flat = torch.cat([p for b in buckets for p in b])
    assert torch.equal(flat, torch.cat(tensors))
    for b in buckets:
        for p in b:
            p.add_(1)
    assert torch.equal(torch.cat(tensors), flat + 1)  # views, not copies
    assert distributed.all_reduce_sum_(tensors) == 0  # no group: no sum


# ------------------------------------------------------------------ CLI


def _ref_params():
    params = JaxTransformer(jax_configs.get_config('tiny')).init(
        jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))['params']
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


@pytest.fixture(scope='module')
def sources(tmp_path_factory):
    """A token file and the reference's initial params, saved as an
    orbax step (the reference's --init-from) and as the port's."""
    root = tmp_path_factory.mktemp('multihost_sources')
    tokens = str(root / 'tokens.bin')
    loader.write_token_file(
        tokens, np.random.default_rng(5).integers(0, 256, 8192))
    params = _ref_params()
    ref_init = str(root / 'ref_init')
    state = jax_train.TrainState.create(
        apply_fn=JaxTransformer(jax_configs.get_config('tiny')).apply,
        params=params, tx=jax_train.make_optimizer(jax_train.TrainConfig()))
    with ref_checkpoints.AsyncCheckpointManager(ref_init) as mgr:
        mgr.save(0, state)
    port_init = str(root / 'port_init')
    checkpoints.save_params(port_init, 0, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), params))
    return tokens, ref_init, port_init


def _cli_argv(tokens, port_init, steps):
    """A host's train_llama: four CPU entries at fsdp 2, so the global
    mesh is data 4 x fsdp 2 over 8 entries, B rows a host."""
    return ['-m', 'skypilot_tpu_torch.train_llama', '--model', 'tiny',
            '--device', 'cpu', '--mesh-devices', ','.join(['cpu'] * 4),
            '--fsdp', '2', '--batch-size', str(B), '--seq-len', str(S),
            '--data', tokens, '--init-from', port_init, '--steps',
            str(steps)]


@pytest.fixture(scope='module')
def cli_runs(sources, tmp_path_factory):
    """Two-host train_llama runs: uninterrupted (3 steps, --preflight),
    and a run of 1 step saving step 0 under a checkpoint directory,
    resumed by two new hosts to 3 steps.  -> (uninterrupted outputs,
    first outputs, resumed outputs, checkpoint directory)."""
    tokens, _, port_init = sources
    root = str(tmp_path_factory.mktemp('multihost_cli'))
    ckpt = os.path.join(root, 'ckpt')
    whole = _spawn(_cli_argv(tokens, port_init, STEPS) + ['--preflight'],
                   root, 'whole')
    first = _spawn(_cli_argv(tokens, port_init, 1), root, 'first',
                   {checkpoints.ENV_CHECKPOINT_DIR: ckpt})
    try:
        first_out = _finish(first)
        rest = _spawn(_cli_argv(tokens, port_init, STEPS), root, 'rest',
                      {checkpoints.ENV_CHECKPOINT_DIR: ckpt})
        rest_out = _finish(rest)
        whole_out = _finish(whole)
    finally:
        _kill(whole + first)
    return whole_out, first_out, rest_out, ckpt


def _reference_cli(argv, monkeypatch):
    """examples/train_llama.py's main() under the conftest's devices;
    -> [(loss, grad_norm)] of every step (its jitted step recorded)."""
    spec = importlib.util.spec_from_file_location(
        'ref_train_llama', os.path.join(REPO, 'examples', 'train_llama.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    recorded = []
    real = jax_train.jit_train_step

    class Recording:
        def __init__(self, fn):
            self.fn = fn

        def lower(self, *args):
            del args
            return types.SimpleNamespace(compile=lambda: self)

        def __call__(self, state, batch):
            state, m = self.fn(state, batch)
            recorded.append((float(m['loss']), float(m['grad_norm'])))
            return state, m

    monkeypatch.setattr(jax_train, 'jit_train_step',
                        lambda *a, **k: Recording(real(*a, **k)))
    monkeypatch.setattr(sys, 'argv', ['train_llama.py'] + argv)
    module.main()
    return recorded


def test_cli_hosts_match_the_reference_example(cli_runs, sources,
                                               monkeypatch, tmp_path):
    """Two hosts of B rows each over data 4 x fsdp 2 take the losses of
    the reference's example over the global batch of 2 B on its 8
    devices, from the same params and token file."""
    tokens, ref_init, _ = sources
    monkeypatch.setenv(ref_callbacks.ENV_LOG_DIR, str(tmp_path))
    monkeypatch.setattr(ref_callbacks, '_instance', None)
    monkeypatch.delenv('SKYTPU_CHECKPOINT_DIR', raising=False)
    want = _reference_cli(
        ['--model', 'tiny', '--batch-size', str(HOSTS * B), '--seq-len',
         str(S), '--steps', str(STEPS), '--fsdp', '2', '--data', tokens,
         '--init-from', ref_init], monkeypatch)
    whole = cli_runs[0]
    summaries = [_summary(out) for out in whole]
    for rank, (out, got) in enumerate(zip(whole, summaries)):
        assert ("mesh: {'data': 4, 'pipeline': 1, 'fsdp': 2, 'sequence': 1, "
                "'tensor': 1, 'expert': 1} over 8 devices (2 hosts over "
                f'gloo; host {rank}: ' + "{'data': 2, 'pipeline': 1, "
                "'fsdp': 2") in out
        assert 'collective preflight: healthy' in out
        assert "'data': {'size': 4.0" in out
        assert 'step 0: loss=' in out and 'step 2: loss=' in out
        assert (got['host'], got['hosts'], got['backend']) == (rank, HOSTS,
                                                              'gloo')
        np.testing.assert_allclose(
            list(zip(got['losses'], got['grad_norms'])), want, rtol=1e-5)
        assert len(got['step_ms']) == len(got['reduce_ms']) == STEPS
        n_params = sum(p.numel() for p in train.create_train_state(
            configs.get_config('tiny'), device='cpu')[0].model.parameters())
        # A step sums the denominator, the loss and every gradient.
        assert got['reduce_bytes'] == 4 * (n_params + 2)
    assert summaries[0]['losses'] == summaries[1]['losses']
    assert summaries[0]['digest'] == summaries[1]['digest']


@pytest.mark.parametrize('rank', range(HOSTS))
def test_a_hosts_batches_are_the_references_rows(sources, monkeypatch,
                                                 rank):
    tokens, _, _ = sources
    monkeypatch.setattr(distributed, 'gang', lambda: (HOSTS, rank))
    args = train_llama._parser().parse_args(  # pylint: disable=protected-access
        ['--batch-size', str(B), '--seq-len', str(S)])
    got = train_llama.host_batches(args, loader.TokenDataset(tokens))
    want = ref_loader.HostShardedBatches(
        ref_loader.TokenDataset(tokens), global_batch=HOSTS * B,
        seq_len=S, host_rank=rank, num_hosts=HOSTS)
    for step in range(4):
        assert np.array_equal(got.batch_at(step)['tokens'],
                              want.batch_at(step)['tokens'])
    # Without --data: the rows of one global batch that every host draws.
    whole = torch.randint(0, 256, (HOSTS * B, S + 1),
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(train_llama.random_batch(args, 256, 3),
                       whole[rank * B:(rank + 1) * B])


def test_cli_resume_across_hosts_is_exact(cli_runs):
    """Host 0 alone wrote step 0; two new hosts resume at step 1 and
    take the uninterrupted run's losses and state bit for bit."""
    whole, first, rest, ckpt = cli_runs
    assert checkpoints.latest_step(ckpt) == 0
    assert sorted(os.listdir(ckpt)) == ['0', 'model_config.json']
    for out in rest:
        assert 'resuming from step 1' in out
    for rank in range(HOSTS):
        want, a, b = (_summary(x[rank]) for x in (whole, first, rest))
        assert a['losses'] + b['losses'] == want['losses']
        assert a['grad_norms'] + b['grad_norms'] == want['grad_norms']
        assert b['digest'] == want['digest']


# ------------------------------------------------------ the gang contract


def test_gang_task_trains_with_the_port(tmp_path):
    """`sky.launch` of a 2-node task on the local cloud whose run is the
    port's trainer: the gang supervisor exports the hosts' rank and
    count, the hosts join one group and finish with equal losses and
    digests.  The task's envs name a free coordinator port (the gang's
    fixed one is the JAX twin's, which may run at the same time)."""
    import skypilot_tpu as sky  # pylint: disable=import-outside-toplevel
    from skypilot_tpu import global_user_state  # pylint: disable=import-outside-toplevel
    global_user_state.set_enabled_clouds(['local'])
    task = sky.Task(
        name='porttrain', num_nodes=2,
        envs={distributed.ENV_COORDINATOR_ADDRESS:
                  f'127.0.0.1:{_free_port()}',
              'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1'},
        run=(f'{sys.executable} -m skypilot_tpu_torch.train_llama --model '
             'tiny --device cpu --steps 2 --batch-size 2 --seq-len 16'))
    task.set_resources(sky.Resources(cloud='local'))
    job_id = sky.launch(task, cluster_name='gtorch', stream_logs=False)
    try:
        deadline = time.time() + 120
        status = None
        while time.time() < deadline:
            status = next(r['status'] for r in sky.queue('gtorch')
                          if r['job_id'] == job_id)
            if status == 'SUCCEEDED' or status.startswith('FAILED'):
                break
            time.sleep(1.0)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sky.tail_logs('gtorch', job_id=job_id, follow=False)
        logs = buf.getvalue()
        assert status == 'SUCCEEDED', f'status={status}\n{logs[-3000:]}'
        found = {}
        for line in logs.splitlines():
            at = line.find('{"host"')
            if at >= 0:
                got = json.loads(line[at:])
                found[got['host']] = got
        assert sorted(found) == [0, 1], logs[-3000:]
        assert found[0]['hosts'] == 2 and found[0]['backend'] == 'gloo'
        assert found[0]['losses'] == found[1]['losses']
        assert len(found[0]['losses']) == 2
        assert found[0]['digest'] == found[1]['digest']
    finally:
        sky.down('gtorch')
