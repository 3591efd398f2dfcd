"""Sharded training's checkpoints and CLI against the reference, on the
CPU (tiny, f32).

- Checkpoints: a state trained on fsdp 4 saves the same step format as
  an unsharded one (byte-equal files for the same state) and restores
  onto fsdp 2 (`restore_sharded`, which returns step + 1 as
  tests/unit/test_checkpoints.py:163-184 checks) and onto mesh=None,
  bit for bit; `abstract_train_state` materialises nothing.
- `train_llama --mesh-devices <8 x cpu> --fsdp 2 --sequence 2` with
  `--sp-mode` ring and ulysses: losses and grad_norms within rtol 1e-5
  of the reference's `examples/train_llama.py` run under the conftest
  (8 virtual devices, the same mesh), both from the same initial params
  (`--init-from`) over the same token file (`--data`), with
  `--preflight`; a resume through SKYTPU_CHECKPOINT_DIR on the mesh is
  exactly the uninterrupted run, at tensor 2 too (fsdp 2 x sequence 2
  x tensor 2), whose state restores onto tensor 1 and back.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.callbacks import base as ref_callbacks
from skypilot_tpu.data import checkpoints as ref_checkpoints
from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu_torch import train_llama
from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.parallel import mesh as mesh_lib

B, S, STEPS = 8, 16, 3
CPUS = ','.join(['cpu'] * 8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path / 'bench_logs'))
    monkeypatch.delenv(checkpoints.ENV_CHECKPOINT_DIR, raising=False)
    monkeypatch.setattr(callbacks, '_instance', None)
    monkeypatch.setattr(ref_callbacks, '_instance', None)


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {'tokens': torch.tensor(rng.integers(0, 256, (B, S + 1)))}


def _trained(mesh, steps=2):
    cfg = configs.get_config('tiny')
    state, shardings = train.create_train_state(cfg, mesh=mesh, seed=4,
                                                device='cpu')
    for i in range(steps):
        train.train_step(state, _batch(i))
    return state, shardings


def _flat(state):
    snap = train.snapshot(state)
    out = {'count': snap.count, 'step': snap.train_step}
    for prefix, leaves in (('', snap.params), ('mu/', snap.mu),
                           ('nu/', snap.nu)):
        for path, t in leaves:
            out[prefix + '/'.join(path)] = t
    return out


def _assert_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for key, value in fa.items():
        if torch.is_tensor(value):
            assert torch.equal(value, fb[key]), key
        else:
            assert value == fb[key], key


def test_save_on_fsdp4_restores_onto_fsdp2_and_no_mesh(tmp_path):
    state, _ = _trained(_mesh(data=1, fsdp=4))
    directory = str(tmp_path / 'ckpt')
    with checkpoints.AsyncCheckpointManager(directory) as mgr:
        mgr.save(5, state)
    cfg = configs.get_config('tiny')
    mesh2 = _mesh(data=1, fsdp=2)
    abstract, shardings = train.abstract_train_state(cfg, mesh=mesh2)
    assert all(t.device.type == 'meta'
               for t in abstract.shards.parameters())
    restored, start = checkpoints.restore_sharded(directory, abstract,
                                                  shardings)
    assert start == 6 and restored.step == state.step == 2
    _assert_equal(restored, state)
    embed = restored.shards.blocks['embed.embedding']
    assert [tuple(t.shape) for t in embed.values()] == [(256, 32)] * 2
    # Onto mesh=None: the unsharded state of the same config.
    plain, _ = train.create_train_state(cfg, device='cpu', seed=9)
    plain, start = checkpoints.restore_or_init(plain, directory)
    assert start == 6 and plain.shards is None
    _assert_equal(plain, state)
    # The restored states train on alike.
    for st in (restored, plain):
        train.train_step(st, _batch(7))
    np.testing.assert_allclose(
        _flat(restored)['embed/embedding'].numpy(),
        _flat(plain)['embed/embedding'].numpy(), rtol=1e-5, atol=1e-6)
    # An abstract state of a one-position mesh restores unsharded.
    one = mesh_lib.build_mesh(mesh_lib.MeshConfig(), ['cpu'])
    abstract, shardings = train.abstract_train_state(cfg, mesh=one)
    single, _ = checkpoints.restore_sharded(directory, abstract, shardings)
    assert single.shards is None
    _assert_equal(single, state)
    assert checkpoints.restore_sharded(str(tmp_path / 'missing'), abstract,
                                       shardings) == (None, 0)


def test_sharded_and_unsharded_step_files_have_equal_bytes(tmp_path):
    cfg = configs.get_config('tiny')
    sharded, _ = train.create_train_state(cfg, mesh=_mesh(data=2, fsdp=2,
                                                          sequence=2),
                                          seed=6)
    plain, _ = train.create_train_state(cfg, device='cpu', seed=6)
    dirs = []
    for name, st in (('sharded', sharded), ('plain', plain)):
        dirs.append(str(tmp_path / name))
        checkpoints.save_train_step(dirs[-1], 0, train.snapshot(st))
    # A trained sharded state, and the same state restored unsharded.
    train.train_step(sharded, _batch(1))
    checkpoints.save_train_step(dirs[0], 1, train.snapshot(sharded))
    checkpoints.restore_or_init(plain, dirs[0])
    checkpoints.save_train_step(dirs[1], 1, train.snapshot(plain))
    for step in ('0', '1'):
        for fname in (checkpoints.PARAMS_FILE, checkpoints.OPTIMIZER_FILE):
            with open(os.path.join(dirs[0], step, fname), 'rb') as f:
                a = f.read()
            with open(os.path.join(dirs[1], step, fname), 'rb') as f:
                assert f.read() == a, (step, fname)


def test_load_pretrained_params_onto_a_mesh(tmp_path):
    cfg = configs.get_config('tiny')
    source, _ = train.create_train_state(cfg, device='cpu', seed=2)
    init = str(tmp_path / 'init')
    checkpoints.save_params(init, 0, _tree(source))
    state, _ = train.create_train_state(cfg, mesh=_mesh(data=2, fsdp=2),
                                        seed=3)
    train.load_pretrained_params(state, init)
    for name, p in source.model.named_parameters():
        assert torch.equal(state.shards.gather(name, 'cpu'), p), name
    assert not state.optimizer.state and state.step == 0


def _tree(state):
    tree = {}
    for path, p in train.param_paths(state.model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach()
    return tree


# ------------------------------------------------------------------ CLI


def _ref_params():
    params = JaxTransformer(jax_configs.get_config('tiny')).init(
        jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))['params']
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


@pytest.fixture(scope='module')
def sources(tmp_path_factory):
    """A token file and the reference's initial params, saved as an
    orbax step (the reference's --init-from) and as the port's."""
    root = tmp_path_factory.mktemp('sources')
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


@pytest.mark.parametrize('sp_mode', ['ring', 'ulysses'])
def test_cli_on_a_mesh_matches_reference_example(sp_mode, sources,
                                                 monkeypatch, capsys):
    tokens, ref_init, port_init = sources
    common = ['--model', 'tiny', '--batch-size', str(B), '--seq-len', str(S),
              '--steps', str(STEPS), '--fsdp', '2', '--sequence', '2',
              '--sp-mode', sp_mode, '--data', tokens, '--preflight']
    want = _reference_cli(common + ['--init-from', ref_init], monkeypatch)
    history = train_llama.main(common + ['--init-from', port_init,
                                         '--device', 'cpu',
                                         '--mesh-devices', CPUS])
    out = capsys.readouterr().out
    assert 'collective preflight: healthy' in out
    assert "'data': 2, 'pipeline': 1, 'fsdp': 2, 'sequence': 2" in out
    got = [(h['loss'], h['grad_norm']) for h in history]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cli_resume_on_a_mesh_is_exact(sources, tmp_path, monkeypatch,
                                       capsys):
    tokens, _, port_init = sources
    argv = ['--model', 'tiny', '--device', 'cpu', '--mesh-devices', CPUS,
            '--fsdp', '2', '--sequence', '2', '--batch-size', str(B),
            '--seq-len', str(S), '--init-from', port_init, '--data', tokens,
            '--fused-ce', '--vocab-chunk', '96', '--accum-steps', '2']
    whole, state_u = train_llama.run(argv + ['--steps', str(STEPS)])
    callbacks.reset()
    ckpt = str(tmp_path / 'ckpt')
    monkeypatch.setenv(checkpoints.ENV_CHECKPOINT_DIR, ckpt)
    first, _ = train_llama.run(argv + ['--steps', '1'])
    assert checkpoints.latest_step(ckpt) == 0
    callbacks.reset()
    rest, state_b = train_llama.run(argv + ['--steps', str(STEPS)])
    assert 'resuming from step 1' in capsys.readouterr().out
    assert state_u.shards is not None and state_b.shards is not None
    assert ([(h['loss'], h['grad_norm']) for h in first + rest] ==
            [(h['loss'], h['grad_norm']) for h in whole])
    _assert_equal(state_b, state_u)


def test_cli_tensor_axis_names_a16b(sources, tmp_path, monkeypatch,
                                   capsys):
    """A16b's training half: `--tensor 2` (fsdp 2 x sequence 2 x tensor
    2 over 8 CPU entries, fused CE and accumulation) resumed through
    SKYTPU_CHECKPOINT_DIR gives the uninterrupted run's losses and
    state bit for bit; its final state, saved, restores onto tensor 1
    and that state, saved again, back onto tensor 2, with the same
    leaves."""
    tokens, _, port_init = sources
    argv = ['--model', 'tiny', '--device', 'cpu', '--mesh-devices', CPUS,
            '--fsdp', '2', '--sequence', '2', '--tensor', '2',
            '--batch-size', str(B), '--seq-len', str(S), '--init-from',
            port_init, '--data', tokens, '--fused-ce', '--vocab-chunk',
            '96', '--accum-steps', '2']
    whole, state_u = train_llama.run(argv + ['--steps', str(STEPS)])
    callbacks.reset()
    ckpt = str(tmp_path / 'ckpt')
    monkeypatch.setenv(checkpoints.ENV_CHECKPOINT_DIR, ckpt)
    first, _ = train_llama.run(argv + ['--steps', '1'])
    callbacks.reset()
    rest, state_b = train_llama.run(argv + ['--steps', str(STEPS)])
    out = capsys.readouterr().out
    assert 'resuming from step 1' in out and "'tensor': 2" in out
    assert ([(h['loss'], h['grad_norm']) for h in first + rest] ==
            [(h['loss'], h['grad_norm']) for h in whole])
    _assert_equal(state_b, state_u)
    cfg = configs.get_config('tiny')
    saved = str(tmp_path / 'tensor2')
    with checkpoints.AsyncCheckpointManager(saved) as mgr:
        mgr.save(STEPS, state_b)
    abstract, shardings = train.abstract_train_state(
        cfg, mesh=_mesh(data=1, fsdp=2, sequence=2))
    one, start = checkpoints.restore_sharded(saved, abstract, shardings)
    assert start == STEPS + 1 and one.shards.rank_cfg == cfg
    _assert_equal(one, state_b)
    again = str(tmp_path / 'tensor1')
    with checkpoints.AsyncCheckpointManager(again) as mgr:
        mgr.save(STEPS, one)
    abstract, shardings = train.abstract_train_state(
        cfg, mesh=_mesh(data=2, tensor=2))
    two, _ = checkpoints.restore_sharded(again, abstract, shardings)
    assert two.shards.rank_cfg.n_heads == cfg.n_heads // 2
    _assert_equal(two, state_b)
