"""A copy of each replicated block on every device entry that holds it
(parallel/sharding.py `Placement.holders`, `transformer.ShardedParams`,
models/train.py's copy sum), against the reference's sharded state on
the CPU.

The port's CPU stand-in for cards is a list of indexed CPU entries
(`cpu:0 ... cpu:3`): distinct `torch.device`s, so each keeps its own
copies, as each of the reference's virtual CPU devices (the conftest's
`xla_force_host_platform_device_count`) keeps its own shard.  A list
that repeats one entry (`['cpu'] * 4`) keeps one copy a block, as
before.

On data 2 x sequence 2 Ulysses, fsdp 2 x sequence 2 ring and sequence
2 x tensor 2 ring (test_torch_replicas_pipeline.py runs the same checks
on two pipeline layouts) both sides start from the reference's initial
state and take two steps on the same numpy batches (tiny, f32):
- `holders` gives, for every leaf, the positions whose reference
  device holds a shard of it, grouped by the slice they hold;
- the copy at every position equals the reference's shard on that
  device: `mu` and `nu` within rtol 1e-5 / atol 1e-6,
  test_torch_sharded_train.py's bounds, the parameters within rtol
  1e-5 / atol PARAM_ATOL = 1e-4 (Adam's amplified summation noise,
  measured below);
- every copy is bit-equal to its owner (`train.check_copies`);
- loss and grad_norm equal the one-copy mesh's (`['cpu'] * 4` from the
  same state) within rtol 1e-6, and every leaf and moment within rtol
  1e-5 / atol 1e-6 (measured: 1.9e-7 on the parameters).
A step saved from copies is byte-equal to the one-copy mesh's files of
the same state and restores onto fsdp 2 and onto no mesh.  About 25 s
alone.
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
from skypilot_tpu.parallel import pipeline as jax_pipeline
from skypilot_tpu.parallel.sharding import token_batch_sharding
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline

B, S, STEPS = 4, 16, 2
RTOL, ATOL = 1e-5, 1e-6
# Parameters against the reference: one element of fsdp 2 x sequence 2's
# embedding reads 4.6e-5 off after two steps, in the one-copy run as in
# the copies (Adam amplifies the summation noise of a near-zero
# gradient); a copy that missed an update would be off by lr, 3e-4.
PARAM_ATOL = 1e-4
ONE_COPY_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5

# name -> (MeshConfig kwargs, sequence_parallel, microbatches on a
# pipeline); the pipeline layouts run in test_torch_replicas_pipeline.py.
LAYOUTS = {
    'data2-seq2-ulysses': (dict(data=2, sequence=2), 'ulysses', 1),
    'fsdp2-seq2-ring': (dict(data=1, fsdp=2, sequence=2), 'ring', 1),
    'seq2-tensor2-ring': (dict(data=1, sequence=2, tensor=2), 'ring', 1),
    'pipeline2-data2': (dict(data=2, pipeline=2), 'ring', 2),
    'pipeline2-tensor2': (dict(data=1, pipeline=2, tensor=2), 'ring', 2),
}
MESH_LAYOUTS = ('data2-seq2-ulysses', 'fsdp2-seq2-ring', 'seq2-tensor2-ring')


def indexed(n):
    """n distinct CPU entries: the CPU tests' stand-in for n cards."""
    return [f'cpu:{i}' for i in range(n)]


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


def _trees(jstate):
    """(params, mu, nu) of a reference TrainState, as jax arrays."""
    adam = _adam(jstate.opt_state)
    return tuple(nn.meta.unbox(t) for t in (jstate.params, adam.mu, adam.nu))


def _device_views(cfg, tree, devices):
    """[{port leaf path: array}] one a device: the leaf with that
    device's shard in place and NaN where the device holds nothing."""
    views = []
    for dev in devices:
        def view(leaf, dev=dev):
            out = np.full(leaf.shape, np.nan, np.float32)
            for shard in leaf.addressable_shards:
                if shard.device == dev:
                    out[shard.index] = np.asarray(shard.data)
            return out
        views.append(convert._flat_port_leaves(  # pylint: disable=protected-access
            cfg, jax.tree.map(view, tree)))
    return views


def _region(mask):
    """The slices a boolean mask covers (None where it is empty), one
    a dim, normalised as `range` triples."""
    if not mask.any():
        return None
    out = []
    for d in range(mask.ndim):
        hit = np.flatnonzero(mask.any(axis=tuple(
            i for i in range(mask.ndim) if i != d)))
        out.append((int(hit[0]), int(hit[-1]) + 1, 1))
    return tuple(out)


def _norm(index, shape):
    return tuple(s.indices(n) for s, n in zip(index, shape))


def _batches(seed):
    rng = np.random.default_rng(seed)
    return [{'tokens': rng.integers(0, 256, (B, S + 1)).astype(np.int32)}
            for _ in range(STEPS)]


def _port_run(cfg, axes, m, devices, init, batches):
    """A port state on `devices` from the reference's initial state,
    after STEPS steps -> (state, [(loss, grad_norm)])."""
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), devices)
    tcfg = train.TrainConfig()
    if axes.get('pipeline', 1) > 1:
        state, _ = pipeline.create_pipeline_train_state(
            cfg, tcfg, mesh=mesh, batch_size=B, seq_len=S)
        step = pipeline.pipeline_train_step(cfg, mesh, m, tcfg)
    else:
        state, _ = train.create_train_state(cfg, tcfg, mesh=mesh, seed=1)
        step = train.make_train_step(tcfg)
    params, mu, nu, count, at = init
    convert.load_reference_train_state(state, params, mu, nu, count=count,
                                       step=at)
    metrics = []
    for batch in batches:
        state, got = step(state, {'tokens': torch.tensor(batch['tokens'])})
        metrics.append((float(got['loss']), float(got['grad_norm'])))
    return state, metrics


def _run(name, seed):
    axes, sp_mode, m = LAYOUTS[name]
    jcfg = jax_configs.get_config('tiny', sequence_parallel=sp_mode)
    cfg = configs.get_config('tiny', sequence_parallel=sp_mode)
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    jtcfg = jax_train.TrainConfig()
    if axes.get('pipeline', 1) > 1:
        jstate, shardings = jax_pipeline.create_pipeline_train_state(
            jcfg, jtcfg, mesh=jmesh, batch_size=B, seq_len=S)
        jstep = jax.jit(jax_pipeline.pipeline_train_step(jcfg, jmesh, m),
                        in_shardings=(shardings, None),
                        out_shardings=(shardings, None))
    else:
        jstate, shardings = jax_train.create_train_state(
            jcfg, jtcfg, mesh=jmesh, batch_size=B, seq_len=S)
        jstep = jax_train.jit_train_step(shardings,
                                         token_batch_sharding(jmesh), jtcfg)
    adam = _adam(jstate.opt_state)
    init = (*(jax.tree.map(np.asarray, t) for t in _trees(jstate)),
            int(adam.count), int(jstate.step))
    batches = _batches(seed)
    jmetrics = []
    with jmesh:
        for batch in batches:
            jstate, jm = jstep(jstate, batch)
            jmetrics.append((float(jm['loss']), float(jm['grad_norm'])))
    devices = list(jmesh.devices.flat)
    views = [_device_views(cfg, tree, devices) for tree in _trees(jstate)]
    state, metrics = _port_run(cfg, axes, m, indexed(n), init, batches)
    one, one_metrics = _port_run(cfg, axes, m, ['cpu'] * n, init, batches)
    return dict(state=state, metrics=metrics, one_copy=one_metrics,
                one_copy_state=one, jmetrics=jmetrics, views=views)


def cached_runs():
    """fn(layout name) -> `_run`'s result, each layout run once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(name, seed=sorted(LAYOUTS).index(name))
        return cache[name]
    return get


@pytest.fixture(scope='module')
def runs():
    return cached_runs()


def _leaves(state):
    """(port leaf path, parameter name) of every leaf."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [('/'.join(path), names[id(p)])
            for path, p in train.param_paths(state.model)]


def check_holders(r):
    """`holders` of every leaf: the positions whose reference device
    holds a shard of it, grouped by the slice they hold, each keeping
    its copy on its own entry."""
    shards = r['state'].shards
    params = r['views'][0]
    for path, leaf in _leaves(r['state']):
        shape = tuple(shards.shapes[leaf])
        placement = shards.placements[leaf]
        groups = {}
        for pos, view in enumerate(params):
            region = _region(~np.isnan(view[path]))
            if region is not None:
                groups.setdefault(region, []).append(pos)
        want = {_norm(placement.index(pos[0], shape), shape): pos
                for pos in placement.holders(len(shape)).values()}
        assert want == groups, path
        assert [list(held) for held in shards.copies[leaf].values()] == [
            [shards.mesh.devices[p] for p in pos] for pos in want.values()]


def check_copies_against_reference(r):
    """The copy every position reads, against the reference's shard on
    that position's device: parameters, exp_avg and exp_avg_sq."""
    state = r['state']
    shards = state.shards
    np.testing.assert_allclose(r['metrics'], r['jmetrics'], rtol=RTOL)
    checked = 0
    for path, leaf in _leaves(state):
        placement = shards.placements[leaf]
        shape = shards.shapes[leaf]
        for pos in filter(placement.holds, range(shards.mesh.size)):
            blk = placement.block(pos, len(shape))
            copy = shards.copies[leaf][blk][shards.mesh.devices[pos]]
            opt = state.optimizer.state[copy]
            index = placement.index(pos, shape)
            for views, got, atol in (
                    (r['views'][0], copy, PARAM_ATOL),
                    (r['views'][1], opt['exp_avg'], ATOL),
                    (r['views'][2], opt['exp_avg_sq'], ATOL)):
                want = views[pos][path][index]
                assert not np.isnan(want).any(), (path, pos)
                np.testing.assert_allclose(got.detach().numpy(), want,
                                           rtol=RTOL, atol=atol,
                                           err_msg=f'{path} at {pos}')
            checked += 1
    # Every position of the mesh holds its own copy of what it reads.
    assert checked == sum(
        1 for leaf in shards.placements for held in
        shards.copies[leaf].values() for _ in held)


def check_bit_equal_copies(r):
    state = r['state']
    copies = sum(len(held) - 1 for blocks in state.shards.copies.values()
                 for held in blocks.values())
    assert copies > 0
    assert train.check_copies(state) == copies
    assert int(state.optimizer.state[state.shards.parameters()[-1]][
        'step']) == STEPS


def check_one_copy(r):
    """Loss and grad_norm of every step within rtol 1e-6 of the
    one-copy mesh's, and the whole state within rtol 1e-5 / atol 1e-6
    (the copies' sum adds its order, nothing more)."""
    np.testing.assert_allclose(r['metrics'], r['one_copy'],
                               rtol=ONE_COPY_RTOL)
    got, want = (train.snapshot(r[k]) for k in ('state', 'one_copy_state'))
    for (path, a), (_, b) in zip(got.params + got.mu + got.nu,
                                 want.params + want.mu + want.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg='/'.join(path))


@pytest.mark.parametrize('name', MESH_LAYOUTS)
def test_holders_are_the_reference_devices_of_each_shard(runs, name):
    check_holders(runs(name))


@pytest.mark.parametrize('name', MESH_LAYOUTS)
def test_every_copy_equals_the_reference_shard_on_its_device(runs, name):
    check_copies_against_reference(runs(name))


@pytest.mark.parametrize('name', MESH_LAYOUTS)
def test_copies_are_bit_equal_to_their_owners(runs, name):
    check_bit_equal_copies(runs(name))


@pytest.mark.parametrize('name', MESH_LAYOUTS)
def test_step_equals_the_one_copy_mesh(runs, name):
    check_one_copy(runs(name))


def test_check_copies_sees_a_copy_that_drifts():
    cfg = configs.get_config('tiny')
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=2), indexed(2))
    state, _ = train.create_train_state(cfg, mesh=mesh, seed=2)
    train.train_step(state, {'tokens': torch.tensor(_batches(8)[0]['tokens'])})
    assert train.check_copies(state) == len(list(state.model.parameters()))
    owner, other = state.shards.replicas()[-1]
    with torch.no_grad():
        other.view(-1)[0] += 1e-6
    with pytest.raises(ValueError, match='differs from its owner'):
        train.check_copies(state)
    with torch.no_grad():
        other.copy_(owner)
    state.optimizer.state[other]['exp_avg'].view(-1)[0] += 1e-9
    with pytest.raises(ValueError, match='differs from its owner'):
        train.check_copies(state)


def test_fused_ce_and_accumulation_with_copies():
    """The fused CE over a masked batch with two accumulation
    microbatches on data 2 x sequence 2: the copies' sum runs once after
    both backwards, before the division by the denominator; two steps'
    loss and grad_norm within rtol 1e-6 of the one-copy mesh's, the
    copies bit-equal."""
    cfg = configs.get_config('tiny')
    tcfg = train.TrainConfig(fused_ce=True, vocab_chunk=96, accum_steps=2)
    axes = mesh_lib.MeshConfig(data=2, sequence=2)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(STEPS):
        tokens = rng.integers(0, 256, (B, S + 1))
        batches.append({'inputs': torch.tensor(tokens[:, :-1]),
                        'targets': torch.tensor(tokens[:, 1:]),
                        'mask': torch.tensor((rng.random((B, S)) > 0.25
                                              ).astype(np.float32))})
    metrics = []
    for devices in (indexed(4), ['cpu'] * 4):
        state, _ = train.create_train_state(
            cfg, tcfg, mesh=mesh_lib.build_mesh(axes, devices), seed=6)
        metrics.append([[float(m[k]) for k in ('loss', 'grad_norm')]
                        for m in (train.train_step(state, b, tcfg)[1]
                                  for b in batches)])
        assert train.check_copies(state) == (
            3 * len(list(state.model.parameters()))
            if devices[0] != devices[1] else 0)
    np.testing.assert_allclose(metrics[0], metrics[1], rtol=ONE_COPY_RTOL)


def test_repeated_entries_keep_one_copy():
    cfg = configs.get_config('tiny')
    axes = mesh_lib.MeshConfig(data=2, sequence=2)
    plain = mesh_lib.build_mesh(axes, ['cpu'] * 4)
    state, places = train.create_train_state(cfg, mesh=plain, seed=0)
    shards = state.shards
    for leaf, placement in places.items():
        ndim = len(shards.shapes[leaf])
        assert {blk: pos[0] for blk, pos in placement.holders(ndim).items()
                } == placement.owners(ndim) == {(0,) * ndim: 0}
        assert all(len(held) == 1 for held in shards.copies[leaf].values())
    assert len(shards.parameters()) == len(list(state.model.parameters()))
    assert shards.device_bytes() == [sum(shards.position_bytes()) // 4]
    assert train.check_copies(state) == 0
    pairs = mesh_lib.build_mesh(axes, ['cpu:0', 'cpu:0', 'cpu:1', 'cpu:1'])
    state, places = train.create_train_state(cfg, mesh=pairs, seed=0)
    for leaf, placement in places.items():
        ndim = len(shards.shapes[leaf])
        assert placement.holders(ndim) == {(0,) * ndim: [0, 2]}
        assert list(state.shards.copies[leaf][(0,) * ndim]) == [
            torch.device('cpu:0'), torch.device('cpu:1')]
    assert len(state.shards.parameters()) == 2 * len(
        list(state.model.parameters()))
    assert state.shards.device_bytes() == [shards.device_bytes()[0]] * 2
    # fsdp splits the embed dim: the entries pair with the fsdp ranks,
    # so each block still has one copy, on its own entry.
    fsdp = mesh_lib.build_mesh(mesh_lib.MeshConfig(fsdp=2, sequence=2),
                               ['cpu:0', 'cpu:0', 'cpu:1', 'cpu:1'])
    state, places = train.create_train_state(cfg, mesh=fsdp, seed=0)
    embed = places['embed.embedding'].holders(2)
    assert embed == {(0, 0): [0], (0, 1): [2]}
    assert [list(h) for h in state.shards.copies['embed.embedding'].values()
            ] == [[torch.device('cpu:0')], [torch.device('cpu:1')]]


def _files(directory, step):
    out = {}
    for name in ('params.safetensors', 'optimizer.safetensors'):
        with open(f'{directory}/{step}/{name}', 'rb') as f:
            out[name] = f.read()
    return out


def test_a_step_saved_from_copies_restores_anywhere(tmp_path):
    """data 2 x sequence 2 on indexed entries, two steps, saved; the
    same state restored onto the one-copy mesh writes byte-equal files;
    the step restores onto fsdp 2 and onto no mesh with the same leaves,
    and onto the indexed mesh with every copy filled."""
    cfg = configs.get_config('tiny', sequence_parallel='ulysses')
    axes = mesh_lib.MeshConfig(data=2, sequence=2)
    state, _ = train.create_train_state(
        cfg, mesh=mesh_lib.build_mesh(axes, indexed(4)), seed=4)
    for batch in _batches(5):
        train.train_step(state, {'tokens': torch.tensor(batch['tokens'])})
    saved = train.snapshot(state)
    checkpoints.save_train_step(str(tmp_path / 'copies'), 0, saved)
    abstract, shardings = train.abstract_train_state(
        cfg, mesh=mesh_lib.build_mesh(axes, ['cpu'] * 4))
    one, _ = checkpoints.restore_sharded(str(tmp_path / 'copies'), abstract,
                                         shardings)
    checkpoints.save_train_step(str(tmp_path / 'one'), 0, train.snapshot(one))
    assert _files(tmp_path / 'copies', 0) == _files(tmp_path / 'one', 0)
    assert train.state_digest(one) == train.state_digest(state)
    targets = {'fsdp2': mesh_lib.build_mesh(
        mesh_lib.MeshConfig(data=1, fsdp=2), ['cpu'] * 2),
               'copies': mesh_lib.build_mesh(axes, indexed(4))}
    for label, mesh in targets.items():
        abstract, shardings = train.abstract_train_state(cfg, mesh=mesh)
        restored, start = checkpoints.restore_sharded(
            str(tmp_path / 'copies'), abstract, shardings)
        assert start == 1 and restored.step == STEPS, label
        again = train.snapshot(restored)
        for (path, a), (_, b) in zip(saved.params + saved.mu + saved.nu,
                                     again.params + again.mu + again.nu):
            assert torch.equal(a, b), (label, path)
    assert train.check_copies(restored) == 3 * len(
        list(restored.model.parameters()))
    plain, _ = train.create_train_state(cfg, device='cpu', seed=0)
    plain, start = checkpoints.restore_or_init(plain,
                                               str(tmp_path / 'copies'))
    assert start == 1
    assert train.state_digest(plain) == train.state_digest(state)
