"""The port's slice serving (sequence-parallel) against the JAX package,
on the CPU.

The same seeded inputs go through the reference and the port:

- `ring_attention` / `ulysses_attention` on 2- and 4-rank meshes,
  causal and not, with and without GQA, and on degenerate meshes (a
  size-1 sequence axis, no sequence axis): within atol 2e-4 / rtol
  2e-3 of the reference's on the conftest's virtual devices (the port's
  ranks are CPU entries of one mesh); Ulysses's divisibility errors
  word for word.
- `decode.prefill_sp`: its cache against the reference's `prefill_sp`
  and the port's own `prefill` (same tolerance); the MoE and batch
  refusals.
- `slice_axes` over a grid of hosts, presets and pins (results and
  errors), `Command.to_json` bytes, the reference's coordinator cases,
  the four `skytpu_slice_*` metric families (registered only once a
  slice is built, so a single-host replica has none).
- `SliceReplicaEngine(num_hosts=2, sequence=2)`: greedy tokens equal
  to the reference's slice engine and to the port's single engine,
  float and int8 pools, two SP prefills; an MoE slice at tensor 1
  (C5), float and int8 pools, spec 0 and 3: the reference's slice
  engine's tokens, no SP prefill, a follower's state and pool equal to
  rank 0's; `stats()['slice']` with the reference's keys; a `FollowerExecutor` mirrors the engine's state,
  tables and pool, spec ticks and SP prefills included; a rank that
  raises fails the replica as a unit and /health answers 503 with
  `slice` on both fronts.
- The CLI: `build_parser()`'s slice flags and environment defaults
  equal what the reference's `main` hands its ModelServer; a tensor
  factor above 1 (a slice's default layout, `tensor=2`) serves the
  reference's tokens (tests/test_torch_tensor.py holds the rest of the
  tensor axis).
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import socket
import subprocess
import sys
import threading
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.ops import sp_common as jax_sp_common
from skypilot_tpu.ops.ring_attention import \
    ring_attention as jax_ring_attention
from skypilot_tpu.ops.ulysses_attention import \
    ulysses_attention as jax_ulysses_attention
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.serve import coordinator as jax_coordinator
from skypilot_tpu.serve import slice_replica as jax_slice
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.ops import ring_attention
from skypilot_tpu_torch.ops import sp_common
from skypilot_tpu_torch.ops import ulysses_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import async_server
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import coordinator
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.serve import slice_replica

ATOL, RTOL = 2e-4, 2e-3
# Two long prompts over the SP threshold (32) and a short one (chunked).
PROMPTS = [list(range(1, 49)), list(range(5, 70)), [3, 1, 4, 1, 5]]
ENGINE_KW = dict(max_len=128, slots=2, prefill_chunk=16, kv_pages=48,
                 page_size=8)


@pytest.fixture(scope='module')
def setup():
    jcfg = jax_configs.get_config('tiny')
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    cfg = configs.get_config('tiny')
    model = convert.from_jax_params(
        cfg, jax.tree.map(np.asarray, params), device='cpu')
    return jcfg, params, cfg, model


def _meshes(kind: str, sp: int):
    """(reference Mesh, port Mesh) of one layout."""
    if kind == 'sequence':
        return (jax_mesh.build_mesh(jax_mesh.MeshConfig(sequence=sp),
                                    devices=jax.devices()[:sp]),
                mesh_lib.build_mesh(mesh_lib.MeshConfig(sequence=sp),
                                    ['cpu'] * sp))
    if kind == 'size-1 axis':
        return (jax_mesh.build_mesh(
            jax_mesh.MeshConfig(sequence=1, tensor=2),
            devices=jax.devices()[:2]),
            mesh_lib.build_mesh(mesh_lib.MeshConfig(sequence=1, tensor=2),
                                ['cpu'] * 2))
    assert kind == 'no axis'
    return (jax.sharding.Mesh(np.array(jax.devices()[:1]), ('tensor',)),
            mesh_lib.Mesh(['cpu'], {'tensor': 1}))


def _qkv(h, h_kv, s=32, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((1, h, s, d), (1, h_kv, s, d),
                               (1, h_kv, s, d)))


OPS = {'ring': (jax_ring_attention, ring_attention.ring_attention),
       'ulysses': (jax_ulysses_attention,
                   ulysses_attention.ulysses_attention)}


# ------------------------------------------------------------ the ops


@pytest.mark.parametrize('heads', [(4, 2), (4, 4)], ids=['gqa', 'mha'])
@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
@pytest.mark.parametrize('sp', [2, 4])
@pytest.mark.parametrize('op', sorted(OPS))
def test_sp_attention_matches_reference(op, sp, causal, heads):
    q, k, v = _qkv(*heads, seed=sp)
    jmesh, mesh = _meshes('sequence', sp)
    jfn, fn = OPS[op]
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mesh=jmesh, causal=causal))
    got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             mesh=mesh, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('layout', ['size-1 axis', 'no axis'])
@pytest.mark.parametrize('op', sorted(OPS))
def test_sp_attention_on_degenerate_meshes(op, layout):
    q, k, v = _qkv(4, 2)
    jmesh, mesh = _meshes(layout, 1)
    jfn, fn = OPS[op]
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mesh=jmesh))
    got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_ring_launches_the_hops_the_reference_takes(monkeypatch):
    """A causal ring over sp ranks makes sp (sp + 1) / 2 flash calls (a
    later chunk launches nothing): causal on the diagonal, full on the
    earlier chunks."""
    calls = []
    flash = ring_attention.flash_attention_with_lse

    def spy(q, k, v, *, causal, sm_scale):
        calls.append(causal)
        return flash(q, k, v, causal=causal, sm_scale=sm_scale)

    monkeypatch.setattr(ring_attention, 'flash_attention_with_lse', spy)
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2))
    _, mesh = _meshes('sequence', 4)
    ring_attention.ring_attention(q, k, v, mesh=mesh)
    assert sorted(calls) == [False] * 6 + [True] * 4
    calls.clear()
    ring_attention.ring_attention(q, k, v, mesh=mesh, causal=False)
    assert calls == [False] * 16


@pytest.mark.parametrize('h,sp,layout', [(3, 2, 'sequence'),
                                         (6, 4, 'sequence')])
def test_ulysses_divisibility_error_equals_reference(h, sp, layout):
    q, k, v = _qkv(h, h)
    jmesh, mesh = _meshes(layout, sp)
    with pytest.raises(ValueError) as want:
        jax_ulysses_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), mesh=jmesh)
    with pytest.raises(ValueError) as got:
        ulysses_attention.ulysses_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mesh=mesh)
    assert str(got.value) == str(want.value)
    # The body's own check (the shard_map body's, called from a manual
    # region in the reference) words it by the axis alone.
    qs = [torch.zeros(1, h, 4, 8)] * sp
    with pytest.raises(ValueError, match=rf'divisible by the .sequence. '
                                         rf'axis \({sp}\)'):
        ulysses_attention.ulysses_attention_shards(
            qs, qs, qs, [torch.device('cpu')] * sp, causal=True,
            sm_scale=1.0)


def test_sp_degree_and_partition():
    for layout, sp in (('sequence', 2), ('sequence', 4),
                       ('size-1 axis', 1), ('no axis', 1)):
        jmesh, mesh = _meshes(layout, sp)
        assert (sp_common.sp_degree(mesh, 'sequence') ==
                jax_sp_common.sp_degree(jmesh, 'sequence') == sp)
    assert sp_common.sp_degree(None, 'sequence') == 1
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(sequence=2, tensor=2),
                               ['cpu:0', 'cpu:1', 'cpu:2', 'cpu:3'])
    # Row-major: the sequence ranks sit at tensor index 0.
    assert [(s.rank, str(s.device), s.start, s.stop)
            for s in sp_common.sp_partition(mesh, 'sequence', 8)] == [
        (0, 'cpu:0', 0, 4), (1, 'cpu:2', 4, 8)]
    with pytest.raises(ValueError, match='not divisible'):
        sp_common.sp_partition(mesh, 'sequence', 7)
    with pytest.raises(ValueError, match='multiply'):
        mesh_lib.Mesh(['cpu'] * 3, {'sequence': 2, 'tensor': 1})


# ---------------------------------------------------------- prefill_sp


@pytest.mark.parametrize('sp', [1, 2, 4])
def test_prefill_sp_matches_reference_and_prefill(setup, sp):
    jcfg, params, cfg, model = setup
    prompt = np.arange(1, 49, dtype=np.int32)[None]
    jmesh = jax_slice.build_slice_mesh(sp, jcfg, sequence=sp)
    want = jax.jit(lambda p, t: jax_decode.prefill_sp(
        jcfg, p, t, mesh=jmesh, max_len=64))(params, jnp.asarray(prompt))
    mesh = slice_replica.build_slice_mesh(sp, cfg, sequence=sp,
                                          device='cpu')
    got = decode.prefill_sp(cfg, model, torch.from_numpy(prompt),
                            mesh=mesh, max_len=64)
    _, own = decode.prefill(cfg, model, torch.from_numpy(prompt),
                            max_len=64)
    assert got['index'] == int(want['index']) == 48
    for leaf in ('k', 'v'):
        assert got[leaf].shape == own[leaf].shape == (2, 1, 2, 64, 16)
        np.testing.assert_allclose(got[leaf].numpy(),
                                   np.asarray(want[leaf]),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[leaf].numpy(), own[leaf].numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_prefill_sp_refusals_equal_reference(setup):
    jcfg, params, cfg, model = setup
    jmesh = jax_slice.build_slice_mesh(2, jcfg, sequence=2)
    mesh = slice_replica.build_slice_mesh(2, cfg, sequence=2, device='cpu')
    for jc, c, tokens in ((dataclasses.replace(jcfg, n_experts=4),
                           cfg.replace(n_experts=4),
                           np.zeros((1, 8), np.int32)),
                          (jcfg, cfg, np.zeros((2, 8), np.int32))):
        with pytest.raises(ValueError) as want:
            jax_decode.prefill_sp(jc, params, jnp.asarray(tokens),
                                  mesh=jmesh, max_len=64)
        with pytest.raises(ValueError) as got:
            decode.prefill_sp(c, model, torch.from_numpy(tokens),
                              mesh=mesh, max_len=64)
        assert str(got.value) == str(want.value)
    # Sequence ranks on distinct cards read a copy of the weights on
    # their own card: a plain model is refused, a TensorParallel over the
    # mesh holds one copy a further card ('meta' stands in for a card).
    other = mesh_lib.build_mesh(mesh_lib.MeshConfig(sequence=2),
                                ['cpu', 'meta'])
    with pytest.raises(ValueError, match='TensorParallel over the mesh'):
        decode.prefill_sp(cfg, model, torch.zeros((1, 8), dtype=torch.int32),
                          mesh=other, max_len=64)
    spread = convert.to_tensor_parallel(cfg, model, other)
    assert spread.shard(0, 'cpu') is spread.ranks[0]
    copy = spread.shard(0, 'meta')
    assert copy.device == torch.device('meta')
    assert ([(n, p.shape) for n, p in copy.named_parameters()] ==
            [(n, p.shape) for n, p in model.named_parameters()])


# ----------------------------------------------------------- the layout


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ('ValueError', str(e))


@pytest.mark.parametrize('preset', ['tiny', 'tiny-gemma', 'llama3-8b',
                                    'qwen2-7b'])
def test_slice_axes_equal_reference(preset):
    jcfg = jax_configs.get_config(preset)
    cfg = configs.get_config(preset)
    pins = [dict()] + [dict(sequence=s) for s in (1, 2, 3, 4)] + [
        dict(tensor=t) for t in (1, 2, 4, 8)] + [
        dict(sequence=2, tensor=2), dict(sequence=2, tensor=3)]
    for num_hosts in (0, 1, 2, 3, 4, 6, 8):
        for pin in pins:
            want = _outcome(lambda: jax_slice.slice_axes(num_hosts, jcfg,
                                                         **pin))
            got = _outcome(lambda: slice_replica.slice_axes(num_hosts, cfg,
                                                            **pin))
            assert got == want, (num_hosts, pin)


def test_slice_mesh_devices(setup):
    cfg = setup[2]
    mesh = slice_replica.build_slice_mesh(4, cfg, sequence=4, device='cpu')
    assert mesh.shape == {'sequence': 4, 'tensor': 1}
    assert mesh.devices == [torch.device('cpu')] * 4
    repeated = slice_replica.build_slice_mesh(
        2, cfg, sequence=2, devices=[torch.device('cuda', 0)] * 3)
    assert repeated.devices == [torch.device('cuda', 0)] * 2
    with pytest.raises(ValueError, match='needs 4 devices; have 2'):
        slice_replica.build_slice_mesh(4, cfg, sequence=4,
                                       devices=['cpu'] * 2)
    # An engine refuses a mesh of another device type than its own.
    with pytest.raises(ValueError, match='not all cpu devices'):
        batching_engine.ContinuousBatchingEngine(
            cfg, setup[3], mesh=repeated, device='cpu', **ENGINE_KW)


# -------------------------------------------------------- rank protocol


def _commands():
    return [('tick', 1, {}), ('admit', 7, {'slot': 2, 'tokens': 33}),
            ('tick', 9, {'spec': [[1, 2], [3, 4]]}),
            ('admit', 3, {'slot': 0, 'prompt': [5, 6], 'key': [7, 0],
                          'row': None, 'temperature': 0.5,
                          'request_id': 'r-1'})]


def test_command_json_equals_reference():
    for kind, seq, payload in _commands():
        got = coordinator.Command(kind=kind, seq=seq, payload=payload)
        want = jax_coordinator.Command(kind=kind, seq=seq, payload=payload)
        assert got.to_json() == want.to_json()
        back = coordinator.Command.from_json(want.to_json())
        assert (back.kind, back.seq, back.payload) == (kind, seq, payload)
    assert (coordinator.CMD_TICK, coordinator.CMD_ADMIT,
            coordinator.CMD_PREFILL, coordinator.CMD_RELEASE,
            coordinator.CMD_SHUTDOWN) == (
        jax_coordinator.CMD_TICK, jax_coordinator.CMD_ADMIT,
        jax_coordinator.CMD_PREFILL, jax_coordinator.CMD_RELEASE,
        jax_coordinator.CMD_SHUTDOWN)


_SLICE_FAMILIES = ('skytpu_slice_rank_ticks_total',
                   'skytpu_slice_rank_deaths_total',
                   'skytpu_slice_ranks_alive', 'skytpu_slice_sync_seconds')


def test_slice_metric_families_equal_reference():
    names = _SLICE_FAMILIES
    ref = {v.name: v for v in vars(jax_coordinator).values()
           if hasattr(v, 'kind') and hasattr(v, 'labelnames')}
    assert sorted(ref) == sorted(names)
    for name in names:
        ours = metrics.REGISTRY.get(name)
        assert ours is not None, name
        assert (ours.kind, ours.labelnames) == (ref[name].kind,
                                                ref[name].labelnames)
        if ours.kind == 'histogram':
            assert ours.buckets == ref[name].buckets


def test_single_host_server_registers_no_slice_families():
    """model_server imports the slice only for num_hosts > 1, as the
    reference does: a single-host replica's /metrics has no
    skytpu_slice_* family."""
    code = ('import skypilot_tpu_torch.serve.model_server\n'
            'from skypilot_tpu_torch.observability import metrics\n'
            'import sys\n'
            'print([n for n in ' + repr(_SLICE_FAMILIES) +
            ' if metrics.REGISTRY.get(n) is not None])\n'
            'print("skypilot_tpu_torch.serve.slice_replica" in '
            'sys.modules)\n')
    out = subprocess.run([sys.executable, '-c', code], check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ['[]', 'False']


class TestCoordinator:
    """The reference's coordinator cases (tests/unit/test_slice_replica.py
    TestCoordinator), on the port."""

    def test_local_broadcast_and_stats(self):
        coord = coordinator.SliceCoordinator(3)
        try:
            for _ in range(4):
                coord.tick()
            coord.broadcast(coordinator.CMD_ADMIT, slot=1, tokens=9)
            stats = coord.stats()
            assert stats['num_hosts'] == 3
            assert stats['ranks_alive'] == 3
            assert stats['degraded'] is False
            assert stats['sync_count'] == 5
            assert stats['sync_ms_mean'] > 0
            ref = jax_coordinator.SliceCoordinator(3)
            try:
                assert sorted(stats) == sorted(ref.stats())
            finally:
                ref.close()
        finally:
            coord.close()

    def test_follower_exception_is_rank_death_as_a_unit(self):
        executed = []

        def boom(cmd):
            executed.append(cmd.kind)
            if len(executed) >= 3:
                raise RuntimeError('host OOM')

        coord = coordinator.SliceCoordinator(
            2, channels=[coordinator.LocalRank(1, executor=boom)])
        try:
            coord.tick()
            coord.tick()
            with pytest.raises(coordinator.RankDead) as err:
                coord.tick()
            assert err.value.rank == 1
            assert coord.degraded and coord.dead_ranks == [1]
            # Every later command fails fast: a half-dead slice never
            # half-serves.
            with pytest.raises(coordinator.RankDead):
                coord.tick()
        finally:
            coord.close()

    def test_ack_timeout_is_rank_death(self):
        def hang(cmd):
            del cmd
            time.sleep(1)

        coord = coordinator.SliceCoordinator(
            2, channels=[coordinator.LocalRank(1, executor=hang)],
            ack_timeout=0.2)
        try:
            with pytest.raises(coordinator.RankDead, match='timeout'):
                coord.tick()
        finally:
            coord.close()

    def test_tcp_follower_roundtrip(self):
        """Commands out, acks back, shutdown ends the follower loop."""
        a, b = socket.socketpair()
        seen = []
        follower = threading.Thread(
            target=coordinator.follower_serve,
            args=(b, 1, lambda cmd: seen.append((cmd.kind, cmd.seq))),
            daemon=True)
        follower.start()
        coord = coordinator.SliceCoordinator(
            2, channels=[coordinator.TcpRank(1, a)])
        coord.tick()
        coord.broadcast(coordinator.CMD_PREFILL, tokens=128)
        assert coord.stats()['sync_count'] == 2
        coord.close()
        follower.join(timeout=5)
        assert not follower.is_alive()
        assert seen == [(coordinator.CMD_TICK, 1),
                        (coordinator.CMD_PREFILL, 2),
                        (coordinator.CMD_SHUTDOWN, 3)]

    def test_tcp_disconnect_is_rank_death(self):
        a, b = socket.socketpair()
        coord = coordinator.SliceCoordinator(
            2, channels=[coordinator.TcpRank(1, a)], ack_timeout=5.0)
        b.close()   # the follower host vanished
        with pytest.raises(coordinator.RankDead):
            coord.tick()
        coord.close()

    def test_accept_and_connect(self):
        """A follower process's path: connect with a hello, then the
        coordinator's TcpRank drives it (the request id of an ADMIT is
        bound into the follower's log records)."""
        from skypilot_tpu_torch.observability import logs
        with socket.socket() as probe:
            probe.bind(('127.0.0.1', 0))
            port = probe.getsockname()[1]
        seen = []

        def follower():
            sock = coordinator.follower_connect(f'127.0.0.1:{port}', 1,
                                                timeout=30)
            coordinator.follower_serve(sock, 1, lambda cmd: seen.append(
                (cmd.kind, logs.current_context().get('request_id'))))

        thread = threading.Thread(target=follower, daemon=True)
        thread.start()
        channels = coordinator.accept_followers(port, 1, timeout=30)
        coord = coordinator.SliceCoordinator(2, channels=channels)
        coord.broadcast(coordinator.CMD_ADMIT, slot=0, request_id='rid-7')
        coord.close()
        thread.join(timeout=5)
        assert not thread.is_alive()
        assert seen == [('admit', 'rid-7'), ('shutdown', None)]


# ------------------------------------------------------ the slice engine


def _greedy(engine, prompts=PROMPTS, n=8):
    return [engine.generate(p, n, timeout=120) for p in prompts]


def _moe_setup():
    """(reference config, params, port config, port model) of tiny-moe
    from the reference's seeded init."""
    jcfg = jax_configs.get_config('tiny-moe')
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    cfg = configs.get_config('tiny-moe')
    return jcfg, params, cfg, convert.from_jax_params(
        cfg, jax.tree.map(np.asarray, params), device='cpu')


@pytest.mark.parametrize('spec_tokens', [0, 3], ids=['spec0', 'spec3'])
@pytest.mark.parametrize('quantize_kv', [False, True],
                         ids=['float', 'int8'])
def test_moe_slice_engine_tokens_equal_reference(quantize_kv, spec_tokens):
    """C5: an MoE slice at tensor 1 takes the base engine's MoE prefill
    (no SP prefill), a plain model, and a follower that replays it
    mirrors rank 0's state; greedy tokens equal the reference's slice
    engine."""
    jcfg, params, cfg, model = _moe_setup()
    kw = dict(ENGINE_KW, quantize_kv=quantize_kv, spec_tokens=spec_tokens)
    ref = jax_slice.SliceReplicaEngine(jcfg, params, num_hosts=2,
                                       sequence=2, sp_threshold=32, **kw)
    try:
        want = _greedy(ref)
        ref_slice = ref.stats()['slice']
    finally:
        ref.stop()
    follower = slice_replica.FollowerExecutor(cfg, model, device='cpu',
                                              **kw)
    eng = slice_replica.SliceReplicaEngine(
        cfg, model, num_hosts=2, sequence=2, sp_threshold=32,
        rank_channels=[coordinator.LocalRank(1, follower)], device='cpu',
        **kw)
    try:
        got = _greedy(eng)
        stats = eng.stats()['slice']
        assert eng.model is model
        for k in eng._state:
            assert torch.equal(eng._state[k], follower._state[k]), k
        for k, leaf in eng._cache.items():
            theirs = follower._cache[k]
            pairs = ([(leaf[j], theirs[j]) for j in leaf]
                     if isinstance(leaf, dict) else [(leaf, theirs)])
            assert all(torch.equal(a, b) for a, b in pairs), k
    finally:
        eng.stop()
    assert got == want
    assert stats['sp_prefills'] == ref_slice['sp_prefills'] == 0
    assert stats['sp_degree'] == 2 and stats['tensor_degree'] == 1


@pytest.mark.parametrize('quantize_kv', [False, True],
                         ids=['float', 'int8'])
def test_slice_engine_tokens_equal_reference_and_single(setup, quantize_kv):
    jcfg, params, cfg, model = setup
    ref = jax_slice.SliceReplicaEngine(
        jcfg, params, num_hosts=2, sequence=2, sp_threshold=32,
        quantize_kv=quantize_kv, **ENGINE_KW)
    try:
        want = _greedy(ref)
        ref_stats = ref.stats()
    finally:
        ref.stop()
    eng = slice_replica.SliceReplicaEngine(
        cfg, model, num_hosts=2, sequence=2, sp_threshold=32,
        quantize_kv=quantize_kv, device='cpu', **ENGINE_KW)
    try:
        got = _greedy(eng)
        stats = eng.stats()
    finally:
        eng.stop()
    single = batching_engine.ContinuousBatchingEngine(
        cfg, model, quantize_kv=quantize_kv, device='cpu', **ENGINE_KW)
    try:
        one = _greedy(single)
    finally:
        single.stop()
    assert got == want == one
    assert sorted(stats['slice']) == sorted(ref_stats['slice'])
    assert stats['num_hosts'] == 2
    assert stats['slice']['sp_degree'] == 2
    assert stats['slice']['tensor_degree'] == 1
    assert stats['slice']['sp_prefills'] == 2
    assert stats['slice']['sync_count'] > 0
    assert all('slice_sync_ms' in s for s in stats['recent_spans'])


def test_dense_slice_engine_equals_single(setup):
    cfg, model = setup[2], setup[3]
    kw = dict(ENGINE_KW, kv_pages=None)
    eng = slice_replica.SliceReplicaEngine(
        cfg, model, num_hosts=4, sequence=4, sp_threshold=32,
        device='cpu', **kw)
    try:
        got = _greedy(eng)
        sp_prefills = eng.stats()['slice']['sp_prefills']
    finally:
        eng.stop()
    single = batching_engine.ContinuousBatchingEngine(cfg, model,
                                                      device='cpu', **kw)
    try:
        assert got == _greedy(single)
    finally:
        single.stop()
    assert sp_prefills == 2


class TestFollowerExecutor:
    """A follower replays rank 0's broadcasts on its own state: the
    sampler state and block tables bit for bit, the pool within float
    rounding (rank 0 may prefill sequence-parallel)."""

    GEOM = dict(max_len=64, slots=2, prefill_chunk=8, kv_pages=48,
                page_size=8)
    RUNS = (([3, 1, 4, 1, 5, 9, 2, 6], 8), ([7], 4),
            (list(range(1, 25)), 6))

    def _run(self, setup, spec_tokens, sp_threshold=None):
        cfg, model = setup[2], setup[3]
        follower = slice_replica.FollowerExecutor(
            cfg, model, spec_tokens=spec_tokens, device='cpu', **self.GEOM)
        eng = slice_replica.SliceReplicaEngine(
            cfg, model, num_hosts=2, sequence=2,
            rank_channels=[coordinator.LocalRank(1, follower)],
            sp_threshold=sp_threshold, spec_tokens=spec_tokens,
            device='cpu', **self.GEOM)
        try:
            outs = [eng.generate(p, n, timeout=300) for p, n in self.RUNS]
            for k in eng._state:
                assert torch.equal(eng._state[k], follower._state[k]), k
            for k in ('block_tables', 'lengths'):
                assert torch.equal(eng._cache[k], follower._cache[k]), k
            diff = (eng._cache['k'] - follower._cache['k']).abs().max()
            assert float(diff) < 1e-3
            assert follower._commands > 0
            if sp_threshold is not None:
                assert eng.stats()['slice']['sp_prefills'] == 1
        finally:
            eng.stop()
        return outs

    def test_follower_mirrors_engine_state(self, setup):
        self._run(setup, spec_tokens=0)

    def test_follower_mirrors_spec_ticks(self, setup):
        assert self._run(setup, 0) == self._run(setup, 3)

    def test_follower_mirrors_an_sp_prefill(self, setup):
        self._run(setup, spec_tokens=0, sp_threshold=20)

    def test_follower_release_parks_tables(self, setup):
        cfg, model = setup[2], setup[3]
        follower = slice_replica.FollowerExecutor(cfg, model, device='cpu',
                                                  **self.GEOM)
        eng = slice_replica.SliceReplicaEngine(
            cfg, model, num_hosts=2, sequence=2,
            rank_channels=[coordinator.LocalRank(1, follower)],
            device='cpu', **self.GEOM)
        try:
            eng.generate([3, 1, 4, 1, 5], 4, timeout=300)
            assert (follower._cache['block_tables'] == 0).all()
        finally:
            eng.stop()


def _dies_at(n):
    """An executor whose rank dies on its n-th command."""
    seen = []

    def executor(cmd):
        seen.append(cmd.kind)
        if len(seen) >= n:
            raise RuntimeError('host OOM')
    return executor


def test_rank_death_fails_the_replica_as_a_unit(setup):
    cfg, model = setup[2], setup[3]
    eng = slice_replica.SliceReplicaEngine(
        cfg, model, num_hosts=2, sequence=2, sp_threshold=10_000,
        rank_channels=[coordinator.LocalRank(1, _dies_at(6))],
        device='cpu', max_len=128, slots=2, prefill_chunk=16)
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


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else
                     json.dumps(body),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize('front', ['threaded', 'async'])
def test_slice_server_and_rank_death_over_http(setup, front):
    """A slice server's /generate equals the single engine's tokens and
    /health carries `slice`; after a rank dies, /health answers 503
    engine_failed with `slice` degraded."""
    cfg, model = setup[2], setup[3]
    server = model_server.ModelServer(
        'tiny', params=model, continuous_batching=True, max_len=64,
        max_batch=2, prefill_chunk=16, kv_pages=48, page_size=8,
        num_hosts=2, slice_sequence=2, sp_threshold=24, device='cpu')
    start = (async_server.start_background if front == 'async'
             else model_server.start_background)
    port, stop = start(server)
    single = batching_engine.ContinuousBatchingEngine(
        cfg, model, max_len=64, slots=2, prefill_chunk=16, kv_pages=48,
        page_size=8, device='cpu')
    try:
        for prompt in ([1, 2, 3, 4, 5], list(range(1, 45))):
            status, body = _http(port, 'POST', '/generate',
                                 {'prompt_ids': [prompt],
                                  'max_new_tokens': 6})
            assert status == 200
            assert body['tokens'] == [single.generate(prompt, 6)]
        status, health = _http(port, 'GET', '/health')
        assert status == 200
        assert health['num_hosts'] == 2
        assert health['slice']['ranks_alive'] == 2
        assert health['slice']['sp_prefills'] == 1
        # Rank 1's host dies on its next command.
        server.engine._coordinator._channels[0]._executor = _dies_at(1)
        status, _ = _http(port, 'POST', '/generate',
                          {'prompt_ids': [[9, 8, 7]], 'max_new_tokens': 4})
        assert status in (500, 503)
        status, health = _http(port, 'GET', '/health')
        assert status == 503
        assert health['status'] == 'engine_failed'
        assert health['slice']['degraded'] is True
        assert health['slice']['dead_ranks'] == [1]
    finally:
        single.stop()
        stop()
        server.close()


# ---------------------------------------------------------------- CLI

# Environment of the slice flags -> the value in the "set" case.
SLICE_ENV = {'SKYTPU_SERVE_REPLICA_NUM_HOSTS': '4',
             'SKYTPU_SLICE_SP_THRESHOLD': '2048'}
SLICE_KWARGS = ('tensor', 'num_hosts', 'sp_threshold', 'slice_sequence',
                'slice_tensor')


def _main_kwargs(monkeypatch, lib, argv):
    """The ModelServer kwargs `lib.main` builds from `argv` (its
    ModelServer and serve_forever patched to record, nothing served)."""
    seen = {}

    class Recorder:
        def __init__(self, model, **kwargs):
            seen.update(kwargs, model=model)

    monkeypatch.setattr(lib, 'ModelServer', Recorder)
    monkeypatch.setattr(lib, 'serve_forever', lambda *a, **k: None)
    monkeypatch.setattr(sys, 'argv', ['model_server'] + argv)
    lib.main()
    return {k: seen[k] for k in SLICE_KWARGS}


@pytest.mark.parametrize('argv', [
    [], ['--num-hosts', '2', '--slice-sequence', '2'],
    ['--num-hosts', '8', '--sp-threshold', '64', '--slice-tensor', '1'],
    ['--tensor', '2']], ids=['defaults', 'sequence', 'threshold', 'tensor'])
@pytest.mark.parametrize('state', ['set', 'unset'])
def test_slice_flags_equal_reference(monkeypatch, state, argv):
    from skypilot_tpu.serve import model_server as ref_server
    for name in SLICE_ENV:
        monkeypatch.delenv(name, raising=False)
        if state == 'set':
            monkeypatch.setenv(name, SLICE_ENV[name])
    argv = argv + ['--http-server', 'threaded']
    want = _main_kwargs(monkeypatch, ref_server, argv)
    assert _main_kwargs(monkeypatch, model_server, argv) == want


def test_tensor_factor_above_one_names_a16b(setup):
    """The calls that raised naming A16b before the tensor axis was
    ported now serve, with the reference's greedy tokens."""
    from skypilot_tpu.serve import model_server as ref_server
    jcfg, params, cfg, model = setup
    # tiny's default layout on 2 hosts is tensor=2.
    ref = jax_slice.SliceReplicaEngine(jcfg, params, num_hosts=2,
                                       sp_threshold=32, **ENGINE_KW)
    try:
        want = _greedy(ref, PROMPTS[1:])
    finally:
        ref.stop()
    eng = slice_replica.SliceReplicaEngine(cfg, model, num_hosts=2,
                                           sp_threshold=32, device='cpu',
                                           **ENGINE_KW)
    try:
        assert _greedy(eng, PROMPTS[1:]) == want
        assert eng.stats()['slice']['tensor_degree'] == 2
    finally:
        eng.stop()
    prompt = [[3, 1, 4, 1, 5]]
    assert (model_server.ModelServer('tiny', params=model, tensor=2,
                                     max_len=32, device='cpu'
                                     ).generate(prompt, 5) ==
            ref_server.ModelServer('tiny', max_len=32, max_batch=1,
                                   tensor=2).generate(prompt, 5))
    server = model_server.ModelServer(
        'tiny', params=model, num_hosts=2, continuous_batching=True,
        max_len=128, max_batch=2, prefill_chunk=16, kv_pages=48,
        page_size=8, sp_threshold=32, device='cpu')
    try:
        assert server.generate([PROMPTS[1]], 8) == [want[0]]
        assert server.health()[1]['slice']['tensor_degree'] == 2
    finally:
        server.close()
    with pytest.raises(ValueError, match='subsumes --tensor'):
        model_server.ModelServer('tiny', params=model, num_hosts=2,
                                 tensor=2, continuous_batching=True,
                                 device='cpu')
    with pytest.raises(ValueError, match='requires --continuous-batching'):
        model_server.ModelServer('tiny', params=model, num_hosts=2,
                                 device='cpu')
    # An MoE slice at tensor 1 (C5) serves the reference's tokens.
    jmoe, moe_params, moe, moe_model = _moe_setup()
    ref = jax_slice.SliceReplicaEngine(jmoe, moe_params, num_hosts=2,
                                       sequence=2, sp_threshold=32,
                                       **ENGINE_KW)
    try:
        want = _greedy(ref, PROMPTS[:1], 6)
    finally:
        ref.stop()
    eng = slice_replica.SliceReplicaEngine(moe, moe_model, num_hosts=2,
                                           sequence=2, sp_threshold=32,
                                           device='cpu', **ENGINE_KW)
    try:
        assert _greedy(eng, PROMPTS[:1], 6) == want
    finally:
        eng.stop()


def test_bench_prefill_prints_the_reference_keys(capsys):
    slice_replica.main(['--bench-prefill', '--num-hosts', '2',
                        '--prompt-len', '30', '--iters', '2',
                        '--device', 'cpu'])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == sorted(['num_hosts', 'sequence', 'tensor',
                                  'prompt_len', 'prefill_s',
                                  'prefill_s_all'])
    assert (out['num_hosts'], out['sequence'], out['tensor'],
            out['prompt_len']) == (2, 2, 1, 30)
    assert len(out['prefill_s_all']) == 2
