"""Sharded training (parallel/sharding.py, models/train.py over a mesh)
against the reference's sharded step, on the CPU.

The reference runs its jitted sharded step (`create_train_state(mesh=)`,
`jit_train_step`) over the conftest's 8 virtual CPU devices; the port
runs `train_step` over a mesh of as many 'cpu' entries.  Both start
from the reference's initial state on that mesh, carried over as numpy
(`convert.load_reference_train_state`), and take three steps on the
same numpy batches; two meshes have a 'tensor' axis of 2 (heads, kv
heads, d_ff and vocab split; the reference's GSPMD partitions them),
and the fused CE runs vocab-parallel over one of them.  Tolerances (f32 on both sides, summed in different
orders): loss and grad_norm of every step within rtol 1e-5; both AdamW
moments after step 3 within rtol 1e-5 / atol 1e-6; the params after
step 3 within rtol 1e-5 / atol PARAM_ATOL = 3e-5, a few times the
summation noise that Adam amplifies.  Adam divides each moment by the
root of the other, so a near-zero gradient whose summation noise is a
large part of it moves a parameter by a visibly different amount: the
reference's own sharded step against its own unsharded step from the
same state differs by up to 8.7e-6 after 3 steps on these meshes (data
8), while its moments agree within 2e-8.  The port against the
reference reads at most 1.3e-5 on the params (data 8; 1e-6 to 6.9e-6
on the other cases) and 2.1e-8 on the moments.  A parameter that Adam
did not move would be off by about lr a step, 3e-4 each.
A mesh of one position is bit-equal to mesh=None.
"""
from __future__ import annotations

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel.sharding import token_batch_sharding
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.parallel import mesh as mesh_lib

B, S, STEPS = 8, 16, 3
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 3e-5

# name -> (MeshConfig kwargs, sequence_parallel)
MESHES = {
    'data8': (dict(data=8), 'ring'),
    'fsdp4': (dict(data=1, fsdp=4), 'ring'),
    'fsdp2-seq2-ring': (dict(data=1, fsdp=2, sequence=2), 'ring'),
    'data2-seq4-ulysses': (dict(data=2, sequence=4), 'ulysses'),
    'data2-fsdp2-seq2': (dict(data=2, fsdp=2, sequence=2), 'ring'),
    'data4-tensor2': (dict(data=4, tensor=2), 'ring'),
    'fsdp2-seq2-tensor2-ring': (dict(data=1, fsdp=2, sequence=2, tensor=2),
                                'ring'),
}


def _meshes(axes):
    """(reference mesh, port mesh) of one layout over as many devices as
    it needs."""
    n = int(np.prod(list(axes.values())))
    return (jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n]),
            mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n))


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
    """(params, mu, nu, count, step) of a reference TrainState, numpy."""
    adam = _adam(jstate.opt_state)
    return (_numpy(jstate.params), _numpy(adam.mu), _numpy(adam.nu),
            int(adam.count), int(jstate.step))


def _flat(cfg, params, mu, nu):
    out = {}
    for prefix, tree in (('', params), ('mu/', mu), ('nu/', nu)):
        for k, v in convert._flat_port_leaves(cfg, tree).items():  # pylint: disable=protected-access
            out[prefix + k] = v
    return out


def _port_flat(state):
    snap = train.snapshot(state)
    out = {}
    for prefix, leaves in (('', snap.params), ('mu/', snap.mu),
                           ('nu/', snap.nu)):
        for path, t in leaves:
            out[prefix + '/'.join(path)] = t.numpy()
    return out, snap.count


def _run_both(name, axes, sp_mode, tc, masked, seed):
    jcfg = jax_configs.get_config(name, sequence_parallel=sp_mode)
    cfg = configs.get_config(name, sequence_parallel=sp_mode)
    jmesh, mesh = _meshes(axes)
    jtcfg = jax_train.TrainConfig(**tc)
    tcfg = train.TrainConfig(**tc)
    jstate, shardings = jax_train.create_train_state(
        jcfg, jtcfg, mesh=jmesh, batch_size=B, seq_len=S)
    state, placements = train.create_train_state(cfg, tcfg, mesh=mesh,
                                                 seed=1)
    params, mu, nu, count, step = _reference_state(jstate)
    convert.load_reference_train_state(state, params, mu, nu, count=count,
                                       step=step)
    jstep = jax_train.jit_train_step(shardings, token_batch_sharding(jmesh),
                                     jtcfg)
    step_fn = train.make_train_step(tcfg)
    for i, batch in enumerate(_batches(seed, masked)):
        jstate, jm = jstep(jstate, batch)
        state, m = step_fn(state, {k: torch.tensor(v)
                                   for k, v in batch.items()})
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL, err_msg=f'step {i} {key}')
    want = _flat(cfg, *_reference_state(jstate)[:3])
    got, got_count = _port_flat(state)
    assert got_count == STEPS and state.step == STEPS
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        if key.startswith(('mu/', 'nu/')):
            np.testing.assert_allclose(got[key], leaf, rtol=RTOL, atol=ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], leaf, rtol=RTOL,
                                       atol=PARAM_ATOL, err_msg=key)
    return state, placements


@pytest.mark.parametrize('mesh_name', sorted(MESHES))
def test_sharded_steps_match_reference(mesh_name):
    axes, sp_mode = MESHES[mesh_name]
    state, placements = _run_both('tiny', axes, sp_mode, {}, False,
                                  seed=len(mesh_name))
    assert state.shards is not None
    assert set(placements) == {n for n, _ in state.model.named_parameters()}


def test_fused_ce_and_accumulation_on_a_mesh():
    _run_both('tiny', dict(data=2, fsdp=2, sequence=2), 'ring',
              {'fused_ce': True, 'vocab_chunk': 96, 'accum_steps': 2},
              masked=True, seed=7)


def test_fused_ce_and_accumulation_on_a_tensor_mesh():
    """The fused CE, vocab-parallel over the tensor ranks' head columns,
    with accumulation over a masked batch."""
    _run_both('tiny', dict(data=2, sequence=2, tensor=2), 'ring',
              {'fused_ce': True, 'vocab_chunk': 96, 'accum_steps': 2},
              masked=True, seed=7)


def test_moe_trains_under_fsdp():
    _run_both('tiny-moe', dict(data=1, fsdp=2), 'ring', {}, False, seed=8)


def test_one_device_mesh_is_bit_equal_to_no_mesh():
    cfg = configs.get_config('tiny')
    tcfg = train.TrainConfig(fused_ce=True, vocab_chunk=96, accum_steps=2)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(), ['cpu'])
    meshed, placements = train.create_train_state(cfg, tcfg, mesh=mesh,
                                                  seed=3)
    plain, none = train.create_train_state(cfg, tcfg, device='cpu', seed=3)
    assert none is None and meshed.shards is None
    assert all(p.is_replicated() for p in placements.values())
    for batch in _batches(9, masked=True):
        batch = {k: torch.tensor(v) for k, v in batch.items()}
        _, m1 = train.train_step(meshed, batch, tcfg)
        _, m2 = train.train_step(plain, batch, tcfg)
        assert all(torch.equal(m1[k], m2[k]) for k in m1)
    a, b = _port_flat(meshed)[0], _port_flat(plain)[0]
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_sharded_init_gathers_to_the_unsharded_init():
    """create_train_state(mesh=) draws every leaf as init_params does,
    on the mesh's first device, and every position holds its slice."""
    cfg = configs.get_config('tiny-moe')
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=2, fsdp=2,
                                                   sequence=2), ['cpu'] * 8)
    state, placements = train.create_train_state(cfg, mesh=mesh, seed=5)
    plain, _ = train.create_train_state(cfg, device='cpu', seed=5)
    for name, p in plain.model.named_parameters():
        assert torch.equal(state.shards.gather(name, 'cpu'), p), name
        placement = placements[name]
        for pos in range(mesh.size):
            blk = placement.block(pos, p.dim())
            held = state.shards.blocks[name][blk]
            assert torch.equal(held, p[placement.index(pos, p.shape)])
    # fsdp 2 halves every leaf's embed dim; data and sequence replicate.
    per_position = state.shards.position_bytes()
    total = sum(p.numel() * 4 for p in plain.model.parameters())
    assert len(set(per_position)) == 1 and per_position[0] < total


def test_mesh_of_several_devices_recomputes_reentrantly(monkeypatch):
    """A mesh of several positions recomputes each layer with the
    reentrant checkpoint (one recompute inside one autograd node,
    whatever device threads the backward runs on), on one device as on
    several, and gives the bits of the step without remat.  The
    selective 'dots' policy is refused there."""
    from skypilot_tpu_torch.models import transformer  # pylint: disable=import-outside-toplevel
    tokens = torch.tensor(np.random.default_rng(4).integers(0, 256, (4, 17)))
    checkpoint = transformer.torch_checkpoint.checkpoint
    flags = []

    def spy(*args, **kwargs):
        flags.append(kwargs.get('use_reentrant'))
        return checkpoint(*args, **kwargs)

    monkeypatch.setattr(transformer.torch_checkpoint, 'checkpoint', spy)
    runs = []
    for remat in (True, False):
        cfg = configs.get_config('tiny', remat=remat)
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(fsdp=2, sequence=2),
                                   ['cpu'] * 4)
        state, _ = train.create_train_state(cfg, mesh=mesh, seed=1)
        metrics = [train.train_step(state, {'tokens': tokens})[1]
                   for _ in range(2)]
        runs.append((metrics, _port_flat(state)[0]))
    assert flags == [True] * (2 * cfg.n_layers)
    for a, b in zip(runs[0][0], runs[1][0]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(np.array_equal(runs[0][1][k], runs[1][1][k])
               for k in runs[0][1])
    state, _ = train.create_train_state(
        cfg.replace(remat=True, remat_policy='dots'), mesh=mesh, seed=1)
    with pytest.raises(NotImplementedError, match='dots'):
        train.train_step(state, {'tokens': tokens})
