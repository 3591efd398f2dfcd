"""Tensor-parallel serving engines of the port against the JAX package,
on the CPU: slices whose layout has a tensor factor, the KV handoff
across tensor degrees, followers, weight swaps and the fronts.

- `SliceReplicaEngine` at num_hosts=2 in the default layout (tiny:
  tensor 2) and at num_hosts=4 (sequence 2 x tensor 2): greedy tokens
  byte-equal to the reference's slice engine (float and int8 pools),
  `stats()['slice']['tensor_degree']` as the reference's; the slice
  mesh orders its positions as the reference's; `prefill_sp` over
  sequence x tensor within atol 2e-4 / rtol 2e-3 of the reference's.
- Handoff: a frame imported into a tensor-2 engine and exported again
  is the tensor-1 engine's frame, byte for byte (the ranks' heads
  joined in rank order); a tensor-2 prefill export has the tensor-1
  and the reference's header and hashes, layer 0's pages byte-equal
  and every page within the tolerance (later layers read the
  row-parallel sums, whose f32 additions run in another order).
- A `FollowerExecutor` replays every tensor rank into its own pools;
  `swap_params` cuts a plain model into the engine's layout; both
  fronts serve a tensor replica.
"""
from __future__ import annotations

import json
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import handoff as jax_handoff
from skypilot_tpu.serve import model_server as ref_server
from skypilot_tpu.serve import slice_replica as jax_slice
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import async_server
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import coordinator
from skypilot_tpu_torch.serve import handoff
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
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=2), ['cpu'] * 2)
    return jcfg, params, cfg, model, convert.to_tensor_parallel(
        cfg, model, mesh)


def _greedy(engine, prompts=PROMPTS, n=8):
    return [engine.generate(p, n, timeout=120) for p in prompts]


# ---------------------------------------------------------------- slices


@pytest.mark.parametrize('quantize_kv', [False, True],
                         ids=['float', 'int8'])
@pytest.mark.parametrize('num_hosts', [2, 4])
def test_tensor_slice_tokens_equal_reference(setup, num_hosts, quantize_kv):
    """tiny's default layout: 2 hosts are tensor 2, 4 hosts sequence 2 x
    tensor 2 (n_kv_heads caps the tensor factor)."""
    jcfg, params, cfg, model, _ = setup
    ref = jax_slice.SliceReplicaEngine(
        jcfg, params, num_hosts=num_hosts, sp_threshold=32,
        quantize_kv=quantize_kv, **ENGINE_KW)
    try:
        want = _greedy(ref)
        ref_slice = ref.stats()['slice']
    finally:
        ref.stop()
    eng = slice_replica.SliceReplicaEngine(
        cfg, model, num_hosts=num_hosts, sp_threshold=32,
        quantize_kv=quantize_kv, device='cpu', **ENGINE_KW)
    try:
        got = _greedy(eng)
        stats = eng.stats()
    finally:
        eng.stop()
    assert isinstance(eng.model, tensor_parallel.TensorParallel)
    assert got == want
    for key in ('tensor_degree', 'sp_degree', 'sp_prefills'):
        assert stats['slice'][key] == ref_slice[key], key
    assert stats['slice']['tensor_degree'] == 2
    assert stats['tensor_degree'] == 2


@pytest.mark.parametrize('num_hosts,pin', [(4, {}), (4, {'tensor': 1}),
                                           (2, {'sequence': 1})])
def test_slice_mesh_positions_equal_reference(setup, num_hosts, pin):
    jcfg, _, cfg, _, _ = setup
    want = jax_slice.build_slice_mesh(num_hosts, jcfg, **pin)
    got = slice_replica.build_slice_mesh(
        num_hosts, cfg, devices=[f'meta:{i}' for i in range(num_hosts)],
        **pin)
    ids = [d.id for d in jax.devices()[:num_hosts]]
    for seq in range(want.shape['sequence']):
        for t in range(want.shape['tensor']):
            ref_dev = want.devices.reshape(
                want.shape['sequence'], want.shape['tensor'])[seq, t]
            pos = got.position(sequence=seq, tensor=t)
            assert got.devices[pos].index == ids.index(ref_dev.id)


def test_prefill_sp_over_sequence_and_tensor_matches_reference(setup):
    jcfg, params, cfg, model, _ = setup
    prompt = np.arange(1, 49, dtype=np.int32)[None]
    jmesh = jax_slice.build_slice_mesh(4, jcfg)
    want = jax.jit(lambda p, t: jax_decode.prefill_sp(
        jcfg, p, t, mesh=jmesh, max_len=64))(params, jnp.asarray(prompt))
    mesh = slice_replica.build_slice_mesh(4, cfg, device='cpu')
    assert mesh.shape == {'sequence': 2, 'tensor': 2}
    tp = convert.to_tensor_parallel(cfg, model, mesh)
    got = decode.prefill_sp(cfg, tp, torch.from_numpy(prompt), mesh=mesh,
                            max_len=64)
    assert got['index'] == 48
    for leaf in ('k', 'v'):
        assert [t.shape for t in got[leaf]] == [(2, 1, 1, 64, 16)] * 2
        np.testing.assert_allclose(torch.cat(got[leaf], 2).numpy(),
                                   np.asarray(want[leaf]), atol=ATOL,
                                   rtol=RTOL)


class TestTensorFollower:
    """A follower of a tensor slice replays rank 0's broadcasts through
    every tensor rank: state and tables bit for bit, each rank's pool
    within float rounding."""

    GEOM = dict(max_len=64, slots=2, prefill_chunk=8, kv_pages=48,
                page_size=8)

    @pytest.mark.parametrize('spec_tokens', [0, 3])
    def test_follower_mirrors_every_rank(self, setup, spec_tokens):
        cfg, model = setup[2], setup[3]
        mesh = slice_replica.build_slice_mesh(2, cfg, device='cpu')
        follower = slice_replica.FollowerExecutor(
            cfg, convert.to_tensor_parallel(cfg, model, mesh),
            spec_tokens=spec_tokens, device='cpu', **self.GEOM)
        eng = slice_replica.SliceReplicaEngine(
            cfg, model, num_hosts=2, mesh=mesh, sp_threshold=20,
            rank_channels=[coordinator.LocalRank(1, follower)],
            spec_tokens=spec_tokens, device='cpu', **self.GEOM)
        try:
            for p, n in (([3, 1, 4, 1, 5, 9, 2, 6], 8), ([7], 4),
                         (list(range(1, 25)), 6)):
                eng.generate(p, n, timeout=300)
            for k in eng._state:
                assert torch.equal(eng._state[k], follower._state[k]), k
            for k in ('block_tables', 'lengths'):
                assert torch.equal(eng._cache[k], follower._cache[k]), k
            assert len(follower._cache['k']) == 2
            for a, b in zip(eng._cache['k'], follower._cache['k']):
                assert float((a - b).abs().max()) < 1e-3
            assert eng.stats()['slice']['sp_prefills'] == 1
        finally:
            eng.stop()


# --------------------------------------------------------------- handoff


def _frame_arrays(frame):
    decoded = handoff.decode_binary(frame)
    return decoded, {k: v for k, v in decoded.items()
                     if isinstance(v, np.ndarray)}


@pytest.mark.parametrize('quantize_kv', [False, True], ids=['f32', 'int8'])
def test_handoff_wire_across_tensor_degrees(setup, quantize_kv):
    jcfg, params, cfg, model, tp = setup
    kw = dict(max_len=64, slots=2, kv_pages=32, page_size=8,
              quantize_kv=quantize_kv, device='cpu')
    one = batching_engine.ContinuousBatchingEngine(cfg, model, **kw)
    two = batching_engine.ContinuousBatchingEngine(cfg, tp, **kw)
    ref = ref_server.ModelServer('tiny', tensor=2, max_len=64, max_batch=2,
                                 continuous_batching=True, kv_pages=32,
                                 page_size=8, quantize_kv=quantize_kv)
    try:
        prompt = list(range(1, 40))
        frames = [e.export_prefill(prompt, binary=True)
                  for e in (one, two, ref._engine)]  # pylint: disable=protected-access
        decoded = [_frame_arrays(f) for f in frames]
        headers = [{k: v for k, v in d.items()
                    if not isinstance(v, np.ndarray)} for d, _ in decoded]
        assert headers[0] == headers[1] == headers[2]
        for i, (_, arrays) in enumerate(decoded[1:]):
            for name, arr in arrays.items():
                base = decoded[0][1][name]
                assert arr.shape == base.shape and arr.dtype == base.dtype
                if i == 0:   # the port at tensor 2: layer 0 as at tensor 1
                    assert arr[0].tobytes() == base[0].tobytes(), name
                if arr.dtype == np.int8:   # a rounding step apart at most
                    assert np.abs(arr.astype(np.int32) -
                                  base.astype(np.int32)).max() <= 1
                else:
                    np.testing.assert_allclose(arr, base, atol=ATOL,
                                               rtol=RTOL)
        # The layout: imported into each pool and exported again, the
        # tensor-1 frame comes back byte for byte from both.
        d = decoded[0][0]
        for e in (one, two):
            assert e.import_pages(d['hashes'], d['page_size'], d['k'],
                                  d['v'], k_scale=d.get('k_scale'),
                                  v_scale=d.get('v_scale')) == (4, 0)
        again = [e.export_prefix_pages(64, binary=True) for e in (one, two)]
        assert again[0] == again[1]
        assert _frame_arrays(again[1])[0]['hashes'] == d['hashes']
        jax_decoded = jax_handoff.decode_binary(again[1])
        np.testing.assert_array_equal(jax_decoded['k'], d['k'])
        # The request that follows adopts the imported pages as a prefix
        # hit, in every rank's pool.
        assert (two.generate(prompt, 6, timeout=120) ==
                one.generate(prompt, 6, timeout=120))
        assert two.stats()['prefix_cache_hits'] > 0
    finally:
        one.stop()
        two.stop()
        ref.close()


# ------------------------------------------------------ swaps and fronts


def test_swap_params_cuts_a_plain_model(setup):
    cfg, tp = setup[2], setup[4]
    other = init_params(cfg, seed=3, device='cpu')
    kw = dict(max_len=128, slots=2, kv_pages=48, page_size=8, device='cpu')
    eng = batching_engine.ContinuousBatchingEngine(cfg, tp, **kw)
    fresh = batching_engine.ContinuousBatchingEngine(cfg, other, **kw)
    try:
        assert eng.swap_params(other) == 1
        assert isinstance(eng.model, tensor_parallel.TensorParallel)
        assert eng.model.layout() == tp.layout()
        assert _greedy(eng) == _greedy(fresh)
        with pytest.raises(ValueError, match='tensor layout'):
            mesh4 = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=1),
                                        ['cpu'])
            eng.swap_params(convert.to_tensor_parallel(cfg, other, mesh4))
    finally:
        eng.stop()
        fresh.stop()


@pytest.mark.parametrize('front', ['threaded', 'async'])
def test_both_fronts_serve_a_tensor_replica(setup, front):
    cfg, model = setup[2], setup[3]
    server = model_server.ModelServer(
        'tiny', params=model, tensor=2, continuous_batching=True,
        max_len=64, max_batch=2, kv_pages=32, page_size=8, device='cpu')
    start = (async_server.start_background if front == 'async'
             else model_server.start_background)
    port, stop = start(server)
    single = batching_engine.ContinuousBatchingEngine(
        cfg, model, max_len=64, slots=2, kv_pages=32, page_size=8,
        device='cpu')
    try:
        body = json.dumps({'prompt_ids': [PROMPTS[2]],
                           'max_new_tokens': 6}).encode()
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate', data=body,
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            tokens = json.loads(resp.read())['tokens']
        assert tokens == [single.generate(PROMPTS[2], 6)]
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/health',
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        assert health['engine']['tensor_degree'] == 2
    finally:
        single.stop()
        stop()
        server.close()


def test_bench_prefill_takes_a_tensor_factor(capsys):
    slice_replica.main(['--bench-prefill', '--num-hosts', '4', '--tensor',
                        '2', '--prompt-len', '40', '--iters', '1',
                        '--device', 'cpu'])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out['num_hosts'], out['sequence'], out['tensor']) == (4, 2, 2)


def test_weights_swap_restores_onto_the_shards(setup, tmp_path):
    """POST /weights_swap's path on a tensor server: the newest step is
    read straight into the ranks' slices and swapped in; the tokens are
    a fresh tensor server's on those weights."""
    from skypilot_tpu_torch.data import checkpoints
    cfg, model = setup[2], setup[3]
    other = init_params(cfg, seed=5, device='cpu')
    checkpoints.save_params(str(tmp_path), 3, convert.param_tree(other))
    kw = dict(tensor=2, continuous_batching=True, max_len=128, max_batch=2,
              kv_pages=48, page_size=8, device='cpu')
    server = model_server.ModelServer('tiny', params=model, **kw)
    fresh = model_server.ModelServer('tiny', checkpoint_dir=str(tmp_path),
                                     **kw)
    try:
        out = server.weights_swap({'checkpoint_dir': str(tmp_path)})
        assert (out['weight_version'], out['step']) == (1, 3)
        assert isinstance(server.params, tensor_parallel.TensorParallel)
        assert ([server.generate([p], 6) for p in PROMPTS] ==
                [fresh.generate([p], 6) for p in PROMPTS])
    finally:
        server.close()
        fresh.close()
