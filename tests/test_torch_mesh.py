"""The port's meshes, placements, gang environment and collective
preflight (parallel/) against the reference's, on the CPU.

The reference builds its meshes over the conftest's 8 virtual CPU
devices; the port over as many 'cpu:i' entries, entry i standing for
the reference's device i.  Mesh shapes, axis order, device order,
error messages, slice topologies and elastic configs must be equal;
for every leaf of tiny and tiny-moe (tiny alone on the meshes with a
'tensor' axis), each mesh position's slice must equal the reference's
`addressable_shards[i].index` for the same position; the preflight returns the reference's keys and sizes and
fails on the same "sick" numbers with the same message.
"""
from __future__ import annotations

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import exceptions as ref_exceptions
from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.parallel import distributed as ref_distributed
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import preflight as ref_preflight
from skypilot_tpu.parallel import sharding as ref_sharding
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import preflight
from skypilot_tpu_torch.parallel import sharding

# (MeshConfig kwargs, number of devices, num_slices)
MESH_GRID = [
    (dict(data=-1, tensor=2), 8, 1),          # test_compute's cases
    (dict(data=-1, fsdp=2, tensor=2), 8, 2),
    (dict(data=3, tensor=2), 8, 1),
    (dict(data=-1), 8, 1),
    (dict(data=1, sequence=8), 8, 1),
    (dict(data=2, sequence=4), 8, 1),
    (dict(data=2, fsdp=2, sequence=2), 8, 1),
    (dict(data=1, fsdp=4), 4, 1),
    (dict(data=-1, fsdp=-1), 8, 1),
    (dict(data=-1, fsdp=3), 8, 1),
    (dict(data=-1, pipeline=2, fsdp=2), 8, 1),
    (dict(data=-1, sequence=2), 8, 2),
    (dict(data=-1, sequence=3), 8, 2),
    (dict(data=-1, fsdp=-1, tensor=2), 8, 2),
]


def _port_devices(n):
    return [f'cpu:{d.id}' for d in jax.devices()[:n]]


def _result(fn):
    try:
        return fn()
    except ValueError as e:
        return ('ValueError', str(e))


@pytest.mark.parametrize('case', range(len(MESH_GRID)))
def test_build_mesh_matches_reference(case):
    kw, n, slices = MESH_GRID[case]
    want = _result(lambda: jax_mesh.build_mesh(
        jax_mesh.MeshConfig(**kw), devices=jax.devices()[:n],
        num_slices=slices))
    got = _result(lambda: mesh_lib.build_mesh(
        mesh_lib.MeshConfig(**kw), _port_devices(n), num_slices=slices))
    if isinstance(want, tuple):
        assert got == want
        return
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    assert [str(d) for d in got.devices] == [
        f'cpu:{d.id}' for d in want.devices.flat]
    for pos in range(got.size):
        assert got.position(**got.coords(pos)) == pos


def test_mesh_infer_and_topology_match_reference():
    for sizes, total in (([-1, 2], 8), ([-1, -1], 8), ([3, -1], 8),
                         ([2, 2], 8), ([2, 4], 8), ([1, -1], 1)):
        assert (_result(lambda: mesh_lib._infer(sizes, total, 'axes')) ==  # pylint: disable=protected-access
                _result(lambda: jax_mesh._infer(sizes, total, 'axes')))  # pylint: disable=protected-access
    for name in ('tpu-v5p-64', 'tpu-v5e-8', 'tpu-v2-8', 'v4-16', 'v6e-256',
                 'tpu-v3-32', 'h100-8', 'tpu-v9-8', 'tpu-v5p'):
        got = _result(lambda: mesh_lib.slice_topology(name))
        want = _result(lambda: jax_mesh.slice_topology(name))
        if isinstance(want, tuple):
            assert got == want
        else:
            assert (got.generation, got.num_chips, got.num_hosts,
                    got.chips_per_host, got.accelerator_name) == (
                want.generation, want.num_chips, want.num_hosts,
                want.chips_per_host, want.accelerator_name)
    assert mesh_lib.DCN_AXES == jax_mesh.DCN_AXES
    assert mesh_lib.ICI_AXES == jax_mesh.ICI_AXES


def test_elastic_mesh_config_matches_reference():
    configs_ = [dict(data=-1, fsdp=4), dict(data=2, fsdp=-1),
                dict(data=-1, fsdp=-1), dict(data=-1, fsdp=2, tensor=2),
                dict(data=1, fsdp=8), dict(sequence=-1),
                dict(data=-1, sequence=2, tensor=2)]
    for kw in configs_:
        for n in range(0, 17):
            got = _result(lambda: mesh_lib.elastic_mesh_config(
                mesh_lib.MeshConfig(**kw), n))
            want = _result(lambda: jax_mesh.elastic_mesh_config(
                jax_mesh.MeshConfig(**kw), n))
            if isinstance(want, tuple):
                assert got == want, (kw, n)
            else:
                assert got.axis_sizes() == want.axis_sizes(), (kw, n)


def _spec(pspec, ndim):
    out = []
    for entry in tuple(pspec) + (None,) * (ndim - len(pspec)):
        out.append(() if entry is None else
                   (entry,) if isinstance(entry, str) else tuple(entry))
    return tuple(out)


@pytest.mark.parametrize('axes', [dict(data=-1, tensor=2),
                                  dict(data=2, fsdp=2, sequence=2),
                                  dict(data=1, fsdp=8)])
def test_logical_sharding_matches_reference(axes):
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes))
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * 8)
    names = [('batch', 'seq', 'embed'), ('embed', 'vocab'),
             ('vocab', 'embed'), ('embed', 'heads', 'head_dim'),
             ('expert', 'embed', 'mlp'), ('batch', None), ('layers', 'embed'),
             ('batch', 'batch', 'embed'), (None,), ()]
    for logical in names:
        want = ref_sharding.logical_sharding(jmesh, *logical).spec
        got = sharding.logical_sharding(mesh, *logical)
        assert got.spec == _spec(want, len(logical)), logical
    for fn in ('batch_sharding', 'token_batch_sharding',
               'head_kernel_sharding', 'replicated'):
        want = getattr(ref_sharding, fn)(jmesh).spec
        got = getattr(sharding, fn)(mesh)
        assert got.spec == _spec(want, len(got.spec)), fn
    assert sharding.LOGICAL_AXIS_RULES == ref_sharding.LOGICAL_AXIS_RULES


PLACEMENT_MESHES = {'fsdp4': dict(data=1, fsdp=4),
                    'data2-fsdp2-seq2': dict(data=2, fsdp=2, sequence=2),
                    'fsdp8': dict(data=1, fsdp=8)}


# Tensor meshes: 'heads', 'kv_heads', 'mlp' and 'vocab' on 'tensor' (a
# dense config here; an MoE config's tensor placement, its expert stacks'
# 'mlp' too, is tests/test_torch_moe_tensor.py's).
TENSOR_PLACEMENT_MESHES = {'data4-tensor2': dict(data=4, tensor=2),
                           'fsdp2-seq2-tensor2': dict(data=1, fsdp=2,
                                                      sequence=2, tensor=2)}


@pytest.mark.parametrize('mesh_name', sorted(TENSOR_PLACEMENT_MESHES))
def test_tensor_placement_equals_reference_shards(mesh_name):
    test_placement_equals_reference_shards(
        'tiny', mesh_name, TENSOR_PLACEMENT_MESHES[mesh_name])


@pytest.mark.parametrize('mesh_name', sorted(PLACEMENT_MESHES))
@pytest.mark.parametrize('name', ['tiny', 'tiny-moe'])
def test_placement_equals_reference_shards(name, mesh_name, axes=None):
    axes = axes or PLACEMENT_MESHES[mesh_name]
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n)
    jstate, _ = jax_train.create_train_state(
        jax_configs.get_config(name), mesh=jmesh, batch_size=8, seq_len=16)
    ref_leaves = {tuple(k.key for k in path): leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(
                      nn.meta.unbox(jstate.params))[0]}
    state, placements = train.create_train_state(
        configs.get_config(name), mesh=mesh, seed=0)
    position = {d.id: p for p, d in enumerate(jmesh.devices.flat)}
    names = {id(p): n for n, p in state.model.named_parameters()}
    checked = set()
    for path, p in train.param_paths(state.model):
        stacked = path[0].startswith('layer_')
        ref_path = (('layers', 'layer') + path[1:]) if stacked else path
        leaf = ref_leaves[ref_path]
        placement = placements[names[id(p)]]
        assert len(leaf.addressable_shards) == n
        for shard in leaf.addressable_shards:
            index = shard.index[1:] if stacked else shard.index
            got = placement.index(position[shard.device.id], p.shape)
            assert got == tuple(index), (path, shard.device)
        checked.add(ref_path)
    assert checked == set(ref_leaves)


@pytest.fixture(scope='module')
def meshes():
    return (jax_mesh.build_mesh(jax_mesh.MeshConfig(data=-1, tensor=2),
                                devices=jax.devices()[:8]),
            mesh_lib.build_mesh(mesh_lib.MeshConfig(data=-1, tensor=2),
                                ['cpu'] * 8))


def test_probe_reports_all_nontrivial_axes(meshes):
    jmesh, mesh = meshes
    want = ref_preflight.probe_collectives(jmesh, bandwidth_mb=1,
                                           repeats=2)
    got = preflight.probe_collectives(mesh, bandwidth_mb=1, repeats=2)
    assert set(got) == set(want) == {'data', 'tensor'}
    for axis, stats in got.items():
        assert set(stats) == set(want[axis])
        assert stats['size'] == want[axis]['size']
        assert stats['psum_latency_ms'] > 0 and stats['psum_gbps'] > 0


def test_probe_sums_for_real(meshes):
    _, mesh = meshes
    groups = preflight._groups(mesh, 'data')  # pylint: disable=protected-access
    assert sorted(len(g) for g in groups) == [4, 4]
    buffers = [torch.full((8,), float(p)) for p in range(mesh.size)]
    preflight._all_reduce(mesh, groups, buffers)  # pylint: disable=protected-access
    for group in groups:
        total = float(sum(group))
        for pos in group:
            assert torch.equal(buffers[pos], torch.full((8,), total))


def test_check_passes_on_healthy_fabric_and_fails_as_reference(meshes):
    jmesh, mesh = meshes
    preflight.check_collectives(
        mesh, results=preflight.probe_collectives(mesh, bandwidth_mb=1,
                                                  repeats=2))
    sick = {'data': {'size': 4.0, 'psum_latency_ms': 1e9,
                     'psum_gbps': 1e-6}}
    with pytest.raises(ref_exceptions.SkyTpuError, match='preflight') as want:
        ref_preflight.check_collectives(jmesh, results=sick)
    with pytest.raises(exceptions.SkyTpuError, match='preflight') as got:
        preflight.check_collectives(mesh, results=sick)
    assert str(got.value) == str(want.value)


def test_gang_environment(monkeypatch):
    for name in ('SKYTPU_NUM_HOSTS', 'SKYTPU_NUM_SLICES', 'SKYTPU_HOST_RANK',
                 'SKYTPU_COORDINATOR_ADDRESS'):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_from_env() is False
    assert ref_distributed.initialize_from_env() is False
    monkeypatch.setenv('SKYTPU_NUM_SLICES', '2')
    monkeypatch.setenv('SKYTPU_HOST_RANK', '3')
    for fn in ('num_slices', 'num_hosts', 'host_rank'):
        assert getattr(distributed, fn)() == getattr(ref_distributed, fn)()
    monkeypatch.setenv('SKYTPU_NUM_HOSTS', '2')
    monkeypatch.setenv('SKYTPU_COORDINATOR_ADDRESS', '127.0.0.1:1')
    assert distributed.num_hosts() == ref_distributed.num_hosts() == 2
    # A gang no longer raises NotImplementedError (A17f): the host joins
    # the hosts' group.  A rank outside the gang is refused, and a host
    # that cannot reach the coordinator raises once its timeout passed;
    # neither leaves a group behind, and no mesh spans hosts then.
    with pytest.raises(ValueError, match='outside 0..1'):
        distributed.initialize_from_env(device='cpu')
    monkeypatch.setenv('SKYTPU_HOST_RANK', '1')
    with pytest.raises(RuntimeError, match='timed out'):
        distributed.initialize_from_env(device='cpu', timeout=1)
    assert not torch.distributed.is_initialized()
    assert distributed.gang() == (1, 0)
    assert mesh_lib.build_mesh(mesh_lib.MeshConfig(), ['cpu']).hosts == 1


@pytest.mark.parametrize('axes', [dict(data=2, fsdp=2, sequence=2),
                                  dict(data=8), dict(data=1, fsdp=4)])
def test_sharded_prefetch_places_rows_as_the_reference(axes):
    """prefetch_to_device(sharding=token_batch_sharding(mesh)) yields
    each batch rank's rows: the rows every reference device holds of
    the same batch, for each of that rank's positions, in order."""
    from skypilot_tpu.data import prefetch as ref_prefetch
    from skypilot_tpu_torch.data import prefetch
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n)
    rng = np.random.default_rng(n)
    batches = [{'tokens': rng.integers(0, 256, (8, 17)).astype(np.int32)}
               for _ in range(3)]
    placement = sharding.token_batch_sharding(mesh)
    with prefetch.prefetch_to_device(iter(batches),
                                     sharding=placement) as got:
        got = list(got)
    want = list(ref_prefetch.prefetch_to_device(
        iter(batches), sharding=ref_sharding.token_batch_sharding(jmesh)))
    position = {d.id: p for p, d in enumerate(jmesh.devices.flat)}
    owners = placement.owners(2)
    for mine, ref in zip(got, want):
        blocks = mine['tokens']
        assert len(blocks) == len(owners)
        for shard in ref['tokens'].addressable_shards:
            blk = placement.block(position[shard.device.id], 2)
            rank = list(owners).index(blk)
            np.testing.assert_array_equal(blocks[rank].numpy(),
                                          np.asarray(shard.data))
