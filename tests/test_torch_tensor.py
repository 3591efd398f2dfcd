"""The port's tensor-parallel serving (the 'tensor' mesh axis) against
the JAX package, on the CPU.

The reference shards `tiny` over 2 of the conftest's virtual devices
(`ModelServer(tensor=2)`: its logical-axis rules, GSPMD); the port
cuts the same tree into two ranks (`convert.to_tensor_parallel`, CPU
entries of one mesh) and joins them by hand (models/tensor_parallel.py).
tiny's n_kv_heads of 2 caps the degree at 2.  The same numpy inputs go
through both:

- the shards: each rank's leaves equal the reference's
  `addressable_shards` of the same tree, bit for bit, and a checkpoint
  restore reads only each rank's slice of a split leaf;
- the layer math: prefill, the paged tick and the dense tick at tensor
  2 within atol 2e-4 / rtol 2e-3 of the reference's tensor-2 functions
  on its 2-device mesh (f32 on both sides; the row-parallel sums add
  in another order);
- greedy tokens of `ModelServer('tiny', tensor=2)` equal to the
  reference's in every mode: `generate`, paged and dense continuous
  batching, int8 KV, spec k = 2, prefix reuse, a restored checkpoint;
  seeded sampled tokens equal to tensor 1's within the port;
- the refusals (quantize + tensor, an MoE model's too, an indivisible
  degree, too few devices) and the flags against the reference's
  `main`.  MoE at tensor 2 is tests/test_torch_moe_tensor.py.

Slices, handoff and followers are in tests/test_torch_tensor_serving.py.
"""
from __future__ import annotations

import functools
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel.sharding import \
    LOGICAL_AXIS_RULES as JAX_LOGICAL_AXIS_RULES
from skypilot_tpu.serve import model_server as ref_server
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.utils import safetensors_io

ATOL, RTOL = 2e-4, 2e-3
PROMPTS = [[3, 1, 4, 1, 5], list(range(1, 30)), [7, 2, 9]]


def _jax_setup(name):
    jcfg = jax_configs.get_config(name)
    model = JaxTransformer(jcfg)
    tokens = jnp.zeros((1, 8), jnp.int32)
    params = nn.meta.unbox(model.init(jax.random.PRNGKey(0),
                                      tokens)['params'])
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(tensor=2),
                                devices=jax.devices()[:2])
    abstract = jax.eval_shape(
        lambda rng: model.init(rng, tokens)['params'],
        jax.random.PRNGKey(0))
    shardings = nn.meta.unbox(nn.logical_to_mesh_sharding(
        nn.get_partition_spec(abstract), jmesh, JAX_LOGICAL_AXIS_RULES))
    return jcfg, params, jax.device_put(params, shardings), jmesh


@functools.lru_cache(maxsize=None)
def _build(name):
    jcfg, params, sharded, jmesh = _jax_setup(name)
    cfg = configs.get_config(name)
    tree = jax.tree.map(np.asarray, params)
    model = convert.from_jax_params(cfg, tree, device='cpu')
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=2), ['cpu'] * 2)
    tp = convert.to_tensor_parallel(cfg, tree, mesh)
    return dict(name=name, jcfg=jcfg, params=params, sharded=sharded,
                jmesh=jmesh, cfg=cfg, tree=tree, model=model, mesh=mesh,
                tp=tp)


@pytest.fixture(scope='module', params=['tiny', 'tiny-qwen'])
def setup(request):
    return _build(request.param)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=ATOL, rtol=RTOL)


def _joined(leaf):
    """A tensor-parallel cache leaf in the tensor-1 layout."""
    return torch.cat(leaf, dim=2) if isinstance(leaf, list) else leaf


# ---------------------------------------------------------------- shards


def test_rank_shards_equal_reference_shards(setup):
    """Rank t's leaves are the reference's shard on the device at mesh
    position tensor=t, bit for bit (the reference replicates a q/k/v
    bias, the port cuts it with its kernel's heads)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(setup['sharded'])
    ranks = [convert.to_jax_params(r) for r in setup['tp'].ranks]
    devices = list(setup['jmesh'].devices.flat)
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        for shard in leaf.addressable_shards:
            t = devices.index(shard.device)
            got = ranks[t]
            for key in keys:
                got = got[key]
            want = np.asarray(shard.data)
            if keys[-1] == 'bias':
                want = want[shard.index[:-2] + (
                    slice(t * want.shape[-2] // 2,
                          (t + 1) * want.shape[-2] // 2), slice(None))]
            assert got.tobytes() == want.tobytes(), keys
    tp = setup['tp']
    assert tp.rank_cfg.n_heads == setup['cfg'].n_heads // 2
    assert tp.rank_cfg.head_dim == setup['cfg'].head_dim
    assert tp.n_elements() == sum(
        p.numel() for p in setup['model'].parameters())


def test_shards_cut_from_the_model_equal_the_tree_cut(setup):
    from_model = convert.to_tensor_parallel(setup['cfg'], setup['model'],
                                            setup['mesh'])
    for a, b in zip(from_model.ranks, setup['tp'].ranks):
        for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                      b.named_parameters()):
            assert na == nb and torch.equal(pa, pb), na


def test_cache_placements_equal_reference(setup):
    """The per-rank pools the engine builds (init_paged_cache, int8 too,
    and init_slot_cache over the TensorParallel) have the shapes of the
    reference's addressable shards of its cache placements; tables and
    lengths stay single tensors."""
    from skypilot_tpu.parallel import sharding as jax_sharding
    jmesh, mesh, cfg, tp = (setup['jmesh'], setup['mesh'], setup['cfg'],
                            setup['tp'])
    shape = (2, 4, 2, 8, 16)
    for name in ('slot_cache_sharding', 'page_pool_sharding'):
        want = getattr(jax_sharding, name)(jmesh)
        got = getattr(sharding, name)(mesh)
        ref_index = want.addressable_devices_indices_map(shape)
        for t, dev in enumerate(jmesh.devices.flat):
            assert (got.index(mesh.position(tensor=t), shape) ==
                    ref_index[dev]), name
    ref_q = jax_sharding.page_pool_sharding(jmesh)
    ref_scale = jax_sharding.page_scale_sharding(jmesh)
    kv_shape = (cfg.n_layers, 12, cfg.n_kv_heads, 8, cfg.head_dim)
    paged = decode.init_paged_cache(cfg, 12, 8, 3, 4, quantize_kv=True,
                                    device='cpu', model=tp)
    for name in ('k', 'v'):
        assert len(paged[name]) == 2
        for leaf, dev in zip(paged[name], jmesh.devices.flat):
            assert leaf['q'].shape == ref_q.shard_shape(kv_shape)
            assert leaf['q'].dtype == torch.int8
            assert leaf['scale'].shape == ref_scale.shard_shape(
                kv_shape[:-1])
            assert bool((leaf['scale'] == 1).all())
            assert leaf['q'].is_contiguous()
    for key in ('block_tables', 'lengths'):
        assert isinstance(paged[key], torch.Tensor)
    float_pool = decode.init_paged_cache(cfg, 12, 8, 3, 4, device='cpu',
                                         model=tp)
    assert [leaf.shape for leaf in float_pool['k']] == [
        ref_q.shard_shape(kv_shape)] * 2
    ref_slot = jax_sharding.slot_cache_sharding(jmesh)
    slots = decode.init_slot_cache(cfg, 3, 32, device='cpu', model=tp)
    slot_shape = (cfg.n_layers, 3, cfg.n_kv_heads, 32, cfg.head_dim)
    assert [leaf.shape for leaf in slots['v']] == [
        ref_slot.shard_shape(slot_shape)] * 2
    assert isinstance(slots['lengths'], torch.Tensor)


def test_restore_reads_each_ranks_slice_only(tmp_path, monkeypatch):
    """A checkpoint restored onto tensor shards reads rank t's slice of
    each split leaf straight from the file (no whole leaf is made), and
    serves the reference's tokens (the reference's
    test_sharded_restore_streams_to_devices)."""
    setup = _build('tiny')
    checkpoints.save_params(str(tmp_path), 1,
                            convert.param_tree(setup['model']))
    read = []
    real = safetensors_io.to_torch

    def recording(arr, dtype_str):
        read.append(arr.size)
        return real(arr, dtype_str)

    monkeypatch.setattr(safetensors_io, 'to_torch', recording)
    server = model_server.ModelServer('tiny', checkpoint_dir=str(tmp_path),
                                      max_len=32, max_batch=1, tensor=2,
                                      device='cpu')
    assert isinstance(server.params, tensor_parallel.TensorParallel)
    # Every element read lands in a rank: what the ranks hold, no more.
    assert sum(read) == sum(p.numel() for rank in server.params.ranks
                            for p in rank.parameters())
    ref = ref_server.ModelServer('tiny', max_len=32, max_batch=1, tensor=2)
    prompt = [[5, 3, 2, 1]]
    assert server.generate(prompt, 4) == ref.generate(prompt, 4)


# ------------------------------------------------------------ layer math


def _jit(fn):
    return jax.jit(fn)


def test_prefill_and_decode_step_match_reference(setup):
    jcfg, cfg = setup['jcfg'], setup['cfg']
    tokens = np.random.default_rng(0).integers(
        0, 256, (2, 12)).astype(np.int32)
    jl, jc = _jit(lambda p, t: jax_decode.prefill(jcfg, p, t, max_len=32))(
        setup['sharded'], jnp.asarray(tokens))
    tl, tc = decode.prefill(cfg, setup['tp'], torch.tensor(tokens),
                            max_len=32)
    _close(tl, jl)
    for name in ('k', 'v'):
        assert isinstance(tc[name], list) and len(tc[name]) == 2
        _close(_joined(tc[name]), jc[name])
    step = np.array([[7], [9]], np.int32)
    jl, _ = _jit(lambda p, t, c: jax_decode.decode_step(jcfg, p, t, c))(
        setup['sharded'], jnp.asarray(step), jc)
    tl, _ = decode.decode_step(cfg, setup['tp'], torch.tensor(step), tc)
    _close(tl, jl)


def test_dense_tick_matches_reference(setup):
    jcfg, cfg, tp = setup['jcfg'], setup['cfg'], setup['tp']
    js = jax_decode.init_slot_cache(jcfg, 2, 32)
    ts = decode.init_slot_cache(cfg, 2, 32, device='cpu', model=tp)
    prompt = np.arange(1, 11, dtype=np.int32)[None]
    _, jpre = _jit(lambda p, t: jax_decode.prefill(jcfg, p, t, max_len=32))(
        setup['sharded'], jnp.asarray(prompt))
    _, tpre = decode.prefill(cfg, tp, torch.tensor(prompt), max_len=32)
    js = jax_decode.insert_prefill(js, 1, jpre, 10)
    ts = decode.insert_prefill(ts, 1, tpre, 10)
    tokens = np.array([[4], [6]], np.int32)
    step = _jit(lambda p, t, c: jax_decode.batched_step(jcfg, p, t, c))
    for _ in range(4):
        jl, js = step(setup['sharded'], jnp.asarray(tokens), js)
        tl, ts = decode.batched_step(cfg, tp, torch.tensor(tokens), ts)
        _close(tl, jl)
        for name in ('k', 'v'):
            _close(_joined(ts[name]), js[name])
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert tl.argmax(-1).tolist() == tokens[:, 0].tolist()


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
def test_paged_tick_matches_reference(setup, quantized):
    jcfg, cfg, tp = setup['jcfg'], setup['cfg'], setup['tp']
    jp = jax_decode.init_paged_cache(jcfg, 16, 4, 2, 6,
                                     quantize_kv=quantized)
    tpg = decode.init_paged_cache(cfg, 16, 4, 2, 6, quantize_kv=quantized,
                                  device='cpu', model=tp)
    leaf = tpg['k'][0]['q'] if quantized else tpg['k'][0]
    assert leaf.shape == (cfg.n_layers, 16, cfg.n_kv_heads // 2, 4,
                          cfg.head_dim) and leaf.is_contiguous()
    table = np.zeros((2, 6), np.int32)
    table[0, :3] = [3, 1, 7]
    table[1, :2] = [2, 5]
    lengths = np.array([0, 5], np.int32)
    jp = dict(jp, block_tables=jnp.asarray(table),
              lengths=jnp.asarray(lengths))
    tpg['block_tables'][:] = torch.tensor(table)
    tpg['lengths'][:] = torch.tensor(lengths)
    tokens = np.array([[4], [6]], np.int32)
    step = _jit(lambda p, t, c: jax_decode.paged_batched_step(
        jcfg, p, t, c, kernel='gather'))
    for _ in range(5):
        jl, jp = step(setup['sharded'], jnp.asarray(tokens), jp)
        tl, tpg = decode.paged_batched_step(cfg, tp, torch.tensor(tokens),
                                            tpg)
        _close(tl, jl)
        for name in ('k', 'v'):
            if quantized:
                got = torch.cat([r['q'] for r in tpg[name]], dim=2)
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(jp[name]['q']))
            else:
                _close(_joined(tpg[name]), jp[name])
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]


# --------------------------------------------------------- greedy tokens

MODES = {
    'generate': dict(),
    'paged': dict(continuous_batching=True, kv_pages=32, page_size=8),
    'dense': dict(continuous_batching=True),
    'int8 kv': dict(continuous_batching=True, kv_pages=32, page_size=8,
                    quantize_kv=True),
    'spec 2': dict(continuous_batching=True, kv_pages=32, page_size=8,
                   spec_tokens=2),
}


def _server_tokens(server, prompts, n=6):
    try:
        return [server.generate([p], n) for p in prompts]
    finally:
        server.close()


@pytest.mark.parametrize('mode', list(MODES))
def test_greedy_tokens_equal_reference_server(setup, mode):
    kw = dict(max_len=64, max_batch=2, **MODES[mode])
    want = _server_tokens(ref_server.ModelServer(setup['name'], tensor=2,
                                                 **kw), PROMPTS)
    server = model_server.ModelServer(setup['name'], params=setup['model'],
                                      tensor=2, device='cpu', **kw)
    assert isinstance(server.params, tensor_parallel.TensorParallel)
    if server.engine is not None:
        assert server.engine.stats()['tensor_degree'] == 2
    assert _server_tokens(server, PROMPTS) == want


def test_prefix_reuse_equals_reference(setup):
    """The second prompt shares two full pages with the first and adopts
    them from every rank's pool."""
    kw = dict(max_len=64, max_batch=2, continuous_batching=True,
              kv_pages=32, page_size=8)
    shared = list(range(1, 20))
    prompts = [shared + [3], shared + [9, 8, 7]]
    ref = ref_server.ModelServer(setup['name'], tensor=2, **kw)
    server = model_server.ModelServer(setup['name'], params=setup['model'],
                                      tensor=2, device='cpu', **kw)
    hits = server.engine
    got = _server_tokens(server, prompts)
    assert hits.stats()['prefix_cache_hits'] > 0
    assert got == _server_tokens(ref, prompts)


def test_sampled_tokens_equal_tensor_one(setup):
    """Seeded sampling draws the port's own keys: tensor 2 equals tensor
    1 within the port."""
    kw = dict(max_len=64, max_batch=2, continuous_batching=True,
              kv_pages=32, page_size=8, device='cpu')
    out = []
    for tensor in (1, 2):
        server = model_server.ModelServer(setup['name'], tensor=tensor,
                                          params=setup['model'], **kw)
        try:
            out.append([server.generate([p], 8, temperature=0.8, top_k=20,
                                        seed=11) for p in PROMPTS])
        finally:
            server.close()
    assert out[0] == out[1]


# ------------------------------------------------------------- refusals


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_equal_reference(setup):
    name, model = setup['name'], setup['model']
    assert (_error(lambda: model_server.ModelServer(
        name, quantize='int8', tensor=2, device='cpu')) ==
        _error(lambda: ref_server.ModelServer(name, quantize='int8',
                                              tensor=2)))
    assert (_error(lambda: model_server.ModelServer(
        name, params=model, tensor=4, device='cpu')) ==
        _error(lambda: ref_server.ModelServer(name, tensor=4)))
    assert (_error(lambda: model_server.ModelServer(
        name, params=model, tensor=2, tensor_devices=['cpu'],
        device='cpu')) == 'tensor=2 needs 2 devices; have 1.')
    assert _error(lambda: ref_server.ModelServer(name, tensor=16)) == (
        'tensor=16 needs 16 devices; have 8.')
    # MoE serves at tensor 2 (tests/test_torch_moe_tensor.py); with int8
    # weights it is refused as the reference refuses it.
    assert (_error(lambda: model_server.ModelServer(
        'tiny-moe', quantize='int8', tensor=2, device='cpu')) ==
        _error(lambda: ref_server.ModelServer('tiny-moe', quantize='int8',
                                              tensor=2)))
    with pytest.raises(ValueError, match='tensor layout'):
        # A plain model on a mesh that needs ranks.
        from skypilot_tpu_torch.serve import batching_engine
        batching_engine.ContinuousBatchingEngine(
            setup['cfg'], model, mesh=setup['mesh'], device='cpu')


def test_tensor_flags_equal_reference(monkeypatch):
    seen = {}

    def recorder(store):
        class Recorder:
            def __init__(self, model, **kwargs):
                store.update(kwargs, model=model)
        return Recorder

    argv = ['--tensor', '2', '--http-server', 'threaded']
    for lib, store in ((ref_server, {}), (model_server, seen)):
        monkeypatch.setattr(lib, 'ModelServer', recorder(store))
        monkeypatch.setattr(lib, 'serve_forever', lambda *a, **k: None)
        monkeypatch.setattr(sys, 'argv', ['model_server'] + argv + (
            ['--tensor-devices', 'cpu,cpu'] if lib is model_server else []))
        lib.main()
        if lib is ref_server:
            want = store
    assert seen['tensor'] == want['tensor'] == 2
    assert seen['tensor_devices'] == ['cpu', 'cpu']
    assert seen['slice_devices'] is None


def test_rank_config_and_degree_checks():
    cfg = configs.get_config('llama3-8b')
    rcfg = tensor_parallel.rank_config(cfg, 4)
    assert (rcfg.n_heads, rcfg.n_kv_heads, rcfg.d_ff, rcfg.vocab_size,
            rcfg.head_dim) == (8, 2, 3584, 32064, 128)
    assert tensor_parallel.rank_config(cfg, 1) is cfg
    with pytest.raises(ValueError, match='must divide n_kv_heads'):
        tensor_parallel.rank_config(cfg, 16)
    # An MoE config: d_ff (each expert's) splits, the experts do not.
    moe = tensor_parallel.rank_config(configs.get_config('mixtral-8x7b'), 2)
    assert (moe.n_heads, moe.n_kv_heads, moe.d_ff, moe.n_experts,
            moe.expert_top_k) == (16, 4, 7168, 8, 2)
