"""MoE under the tensor axis: the port's tensor-parallel MoE block,
serving and training against the JAX package, on the CPU (tiny-moe,
f32).

The reference shards tiny-moe over 2 of the conftest's virtual devices
(its logical-axis rules: the expert stacks' 'mlp' axis on 'tensor', the
router replicated; GSPMD); the port cuts the same tree into two ranks
(`convert.to_tensor_parallel`) and joins them by hand
(`decode._tp_moe_mlp`).  tiny-moe's 2 kv heads cap the degree at 2.

- The shards: each rank's router and stacks (every leaf) equal the
  reference's `addressable_shards`, bit for bit; a sharded train
  state's `ShardedParams.gather(tensor=t)` is the slice the reference's
  placement gives tensor rank t; seeded weights drawn onto the ranks
  (`convert.init_tensor_parallel`) equal the unsharded init cut.
- The block: `_tp_moe_mlp` at s = 1 and s = 5 (and the training
  dispatch) at tensor 2 within atol 2e-4 / rtol 2e-3 of the reference's
  `_moe_mlp` on its 2-device mesh (the ranks' partials add in another
  order); at one rank bit-equal to the block as it was before it took
  ranks (`_moe_mlp_before`, kept here as the oracle).
- Greedy tokens of `ModelServer('tiny-moe', tensor=2)` equal the
  reference's in `generate`, paged and dense continuous batching, int8
  KV and spec k = 2; `stats()` reports the tensor degree.  A burst
  submitted at once (several slots' rows in one MoE block) gives the
  reference engine's tokens on its tensor-2 mesh: the legacy loop,
  paged, spec k = 2.
- A tiny-moe slice at 2 hosts in its default layout (tensor 2, a
  follower over `LocalRank`) gives the reference slice engine's
  tokens; the follower's state and pools are bit-equal to rank 0's.
- Training: a tensor-2 mesh step (data 2 x tensor 2, sequence 2 x
  tensor 2 ring and Ulysses) equals the unsharded step within rtol
  1e-5; `train_llama --model tiny-moe --tensor 2` gives the losses of
  `examples/train_llama.py --model tiny-moe --tensor 2` within rtol
  1e-5, and its sharded checkpoint restores onto tensor 1 and back.
"""
from __future__ import annotations

import functools
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
import torch.nn.functional as F

from skypilot_tpu.callbacks import base as ref_callbacks
from skypilot_tpu.data import checkpoints as ref_checkpoints
from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel.sharding import \
    LOGICAL_AXIS_RULES as JAX_LOGICAL_AXIS_RULES
from skypilot_tpu.serve import model_server as ref_server
from skypilot_tpu.serve import slice_replica as jax_slice
from skypilot_tpu_torch import train_llama
from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import coordinator
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.serve import slice_replica

NAME = 'tiny-moe'
ATOL, RTOL = 2e-4, 2e-3
PROMPTS = [[3, 1, 4, 1, 5], list(range(1, 30)), [7, 2, 9]]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n)


@pytest.fixture(scope='module')
def setup():
    """The reference's seeded tiny-moe, unsharded and on its tensor-2
    mesh, and the port's model and tensor-2 cut of the same tree."""
    jcfg = jax_configs.get_config(NAME)
    module = JaxTransformer(jcfg)
    tokens = jnp.zeros((1, 8), jnp.int32)
    params = nn.meta.unbox(module.init(jax.random.PRNGKey(0),
                                       tokens)['params'])
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(tensor=2),
                                devices=jax.devices()[:2])
    abstract = jax.eval_shape(
        lambda rng: module.init(rng, tokens)['params'],
        jax.random.PRNGKey(0))
    shardings = nn.meta.unbox(nn.logical_to_mesh_sharding(
        nn.get_partition_spec(abstract), jmesh, JAX_LOGICAL_AXIS_RULES))
    cfg = configs.get_config(NAME)
    tree = jax.tree.map(np.asarray, params)
    model = convert.from_jax_params(cfg, tree, device='cpu')
    mesh = _mesh(tensor=2)
    return dict(jcfg=jcfg, params=params,
                sharded=jax.device_put(params, shardings), jmesh=jmesh,
                cfg=cfg, model=model, mesh=mesh,
                tp=convert.to_tensor_parallel(cfg, tree, mesh))


# ---------------------------------------------------------------- shards


def test_rank_stacks_equal_reference_shards(setup):
    """Rank t's router, expert stacks and every other leaf are the
    reference's shard on the device at mesh position tensor=t."""
    flat, _ = jax.tree_util.tree_flatten_with_path(setup['sharded'])
    ranks = [convert.to_jax_params(r) for r in setup['tp'].ranks]
    devices = list(setup['jmesh'].devices.flat)
    seen = set()
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        for shard in leaf.addressable_shards:
            got = ranks[devices.index(shard.device)]
            for key in keys:
                got = got[key]
            assert got.tobytes() == np.asarray(shard.data).tobytes(), keys
        seen.add(keys[-1])
    assert set(moe_lib.STACKS) <= seen
    cfg, rcfg = setup['cfg'], setup['tp'].rank_cfg
    moe = setup['tp'].ranks[1].layers[0].moe_mlp
    assert tuple(moe.gate_proj.shape) == (cfg.n_experts, cfg.d_model,
                                          cfg.d_ff // 2)
    assert tuple(moe.down_proj.shape) == (cfg.n_experts, cfg.d_ff // 2,
                                          cfg.d_model)
    assert moe.router.kernel.dtype == torch.float32
    assert rcfg.n_experts == cfg.n_experts and rcfg.d_ff == cfg.d_ff // 2


@pytest.mark.parametrize('axes', [dict(data=4, tensor=2),
                                  dict(data=1, fsdp=2, sequence=2, tensor=2)],
                         ids=['data4-tensor2', 'fsdp2-seq2-tensor2'])
def test_sharded_gather_is_the_reference_placement(axes):
    """A sharded tiny-moe train state places every leaf as the
    reference's `addressable_shards` do, and `ShardedParams.gather(name,
    device, tensor=t)` is the full leaf cut along the dims 'tensor'
    splits (the stacks' d_ff; E and the router whole)."""
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    jstate, _ = jax_train.create_train_state(
        jax_configs.get_config(NAME), mesh=jmesh, batch_size=8, seq_len=16)
    ref = {tuple(k.key for k in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(
               nn.meta.unbox(jstate.params))[0]}
    mesh = _mesh(**axes)
    state, placements = train.create_train_state(configs.get_config(NAME),
                                                 mesh=mesh, seed=0)
    position = {d.id: p for p, d in enumerate(jmesh.devices.flat)}
    names = {id(p): name for name, p in state.model.named_parameters()}
    split = set()
    for path, p in train.param_paths(state.model):
        stacked = path[0].startswith('layer_')
        leaf = ref[(('layers', 'layer') + path[1:]) if stacked else path]
        name = names[id(p)]
        placement = placements[name]
        full = state.shards.gather(name, 'cpu')
        spec = placement.spec + ((),) * (p.dim() - len(placement.spec))
        for shard in leaf.addressable_shards:
            pos = position[shard.device.id]
            index = tuple(shard.index[1:] if stacked else shard.index)
            assert placement.index(pos, p.shape) == index, (name, pos)
            cut = tuple(ix if 'tensor' in ax else slice(None)
                        for ix, ax in zip(index, spec))
            got = state.shards.gather(name, 'cpu',
                                      tensor=mesh.coords(pos)['tensor'])
            assert torch.equal(got, full[cut]), (name, pos)
            if got.shape != full.shape:
                split.add(name)
    stacks = {f'layers.{i}.moe_mlp.{s}' for s in moe_lib.STACKS
              for i in range(configs.get_config(NAME).n_layers)}
    assert {name for name in split if 'moe_mlp' in name} == stacks


@pytest.mark.parametrize('name', [NAME, 'tiny-qwen'])
def test_seeded_ranks_equal_the_unsharded_init_cut(name):
    cfg = configs.get_config(name)
    mesh = _mesh(tensor=2)
    drawn = convert.init_tensor_parallel(cfg, mesh, seed=3)
    cut = convert.to_tensor_parallel(
        cfg, init_params(cfg, seed=3, device='cpu'), mesh)
    for a, b in zip(drawn.ranks, cut.ranks):
        pairs = list(zip(a.named_parameters(), b.named_parameters()))
        assert pairs
        for (na, pa), (nb, pb) in pairs:
            assert na == nb and pa.dtype == pb.dtype, na
            assert torch.equal(pa, pb), na


# ------------------------------------------------------------- the block


def _moe_mlp_before(x, moe, cfg, *, capacity=False):
    """The port's one-device MoE block before it took tensor ranks, op
    for op (the oracle of the one-rank case)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    logits = (tokens.to(torch.float32) @
              moe.router.kernel.to(torch.float32))
    if s > 1 or capacity:
        stacks = [moe.stack(name, torch.float32)
                  if isinstance(getattr(moe, name), moe_lib.QuantStack)
                  else getattr(moe, name) for name in moe_lib.STACKS]
        out, _ = moe_lib.moe_apply(tokens, logits, *stacks, cfg)
        return out.to(x.dtype).reshape(b, s, d)
    _, gate_vals, gate_idx = moe_lib.route(logits, cfg.expert_top_k)
    gates = torch.sum(
        F.one_hot(gate_idx, cfg.n_experts).to(torch.float32) *
        gate_vals[..., None], dim=1)
    xt = tokens.to(torch.float32)
    h = moe_lib.act_fn(cfg)(xt @ moe.stack('gate_proj', torch.float32))
    h = h * (xt @ moe.stack('up_proj', torch.float32))
    out_e = h @ moe.stack('down_proj', torch.float32)
    out = torch.einsum('ne,end->nd', gates, out_e)
    return out.to(x.dtype).reshape(b, s, d)


@functools.lru_cache(maxsize=None)
def _reference_block(s):
    return jax.jit(lambda p, x: jax_decode._moe_mlp(  # pylint: disable=protected-access
        x, jax.tree.map(lambda a: a[0], p['layers']['layer']['moe_mlp']),
        jax_configs.get_config(NAME)))


@pytest.mark.parametrize('s', [1, 5])
def test_tensor_block_matches_reference_and_one_rank_is_bit_equal(setup, s):
    cfg, tp = setup['cfg'], setup['tp']
    x = np.random.RandomState(s).randn(3, s, cfg.d_model).astype(np.float32)
    want = _reference_block(s)(setup['sharded'], jnp.asarray(x))
    xt = torch.from_numpy(x)
    got = decode._tp_moe_mlp(  # pylint: disable=protected-access
        tp.rank_cfg, [r.layers[0].moe_mlp for r in tp.ranks], [xt, xt])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    moe = setup['model'].layers[0].moe_mlp
    for capacity in (False, True):
        one = decode._tp_moe_mlp(cfg, [moe], [xt], capacity=capacity)  # pylint: disable=protected-access
        assert torch.equal(one, _moe_mlp_before(xt, moe, cfg,
                                                capacity=capacity))
    # The training dispatch over the ranks equals the one-rank dispatch
    # within float rounding (the expert outputs' partials add in f32).
    two = decode._tp_moe_mlp(  # pylint: disable=protected-access
        tp.rank_cfg, [r.layers[0].moe_mlp for r in tp.ranks], [xt, xt],
        capacity=True)
    np.testing.assert_allclose(
        two.numpy(),
        decode._tp_moe_mlp(cfg, [moe], [xt], capacity=True).numpy(),  # pylint: disable=protected-access
        atol=ATOL, rtol=RTOL)


def test_one_rank_bf16_block_is_bit_equal():
    """bf16 activations and stacks, where each rounding shows."""
    cfg = configs.get_config(NAME, dtype=torch.bfloat16)
    model = init_params(cfg, seed=1, device='cpu')
    moe = model.layers[0].moe_mlp
    for s in (1, 6):
        x = torch.randn(2, s, cfg.d_model,
                        generator=torch.Generator().manual_seed(s)
                        ).to(torch.bfloat16)
        for capacity in (False, True):
            assert torch.equal(
                decode._tp_moe_mlp(cfg, [moe], [x], capacity=capacity),  # pylint: disable=protected-access
                _moe_mlp_before(x, moe, cfg, capacity=capacity))


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
    want = _server_tokens(ref_server.ModelServer(NAME, tensor=2, **kw),
                          PROMPTS)
    server = model_server.ModelServer(NAME, params=setup['model'],
                                      tensor=2, device='cpu', **kw)
    assert isinstance(server.params, tensor_parallel.TensorParallel)
    assert server.params.tp == 2
    if server.engine is not None:
        assert server.engine.stats()['tensor_degree'] == 2
    assert _server_tokens(server, PROMPTS) == want


# Submitted at once to a 3-slot engine: one admission takes three, so
# ticks carry several slots' rows through the MoE block (a verify tick
# dispatches all B * (k + 1) rows, as the reference does).
BURST = (([3, 1, 4, 1, 5, 9, 2, 6], 6), ([7], 4), (list(range(5, 18)), 5),
         (list(range(1, 25)), 7))
ENGINE_MODES = {'legacy': dict(pipelined=False),
                'paged': dict(kv_pages=48, page_size=8),
                'spec 2': dict(kv_pages=48, page_size=8, spec_tokens=2)}


def _burst(engine):
    try:
        # The queue's (re-entrant) lock held: the worker pops nothing
        # until every request is queued.
        with engine._cond:  # pylint: disable=protected-access
            handles = [engine.submit(p, n) for p, n in BURST]
        return [list(h.result(timeout=300)) for h in handles]
    finally:
        engine.stop()


@pytest.mark.parametrize('mode', list(ENGINE_MODES))
def test_engine_burst_equals_reference_engine(setup, mode):
    from skypilot_tpu.serve import batching_engine as jax_engine
    from skypilot_tpu_torch.serve import batching_engine
    kw = dict(max_len=64, slots=3, prefill_chunk=8, **ENGINE_MODES[mode])
    want = _burst(jax_engine.ContinuousBatchingEngine(
        setup['jcfg'], setup['sharded'], mesh=setup['jmesh'], **kw))
    got = _burst(batching_engine.ContinuousBatchingEngine(
        setup['cfg'], setup['tp'], device='cpu', **kw))
    assert got == want
    assert [len(t) for t in got] == [n for _, n in BURST]


# ----------------------------------------------------------------- slice

ENGINE_KW = dict(max_len=128, slots=2, prefill_chunk=16, kv_pages=48,
                 page_size=8)
SLICE_PROMPTS = [list(range(1, 49)), list(range(5, 70)), [3, 1, 4, 1, 5]]


@pytest.mark.parametrize('quantize_kv', [False, True],
                         ids=['float', 'int8'])
def test_moe_slice_default_layout_equals_reference(setup, quantize_kv):
    """2 hosts of tiny-moe lay out as tensor 2 (the reference's
    default); rank 0 prefills each whole prompt over its tensor ranks
    and a follower replays it over its own."""
    cfg, model = setup['cfg'], setup['model']
    kw = dict(ENGINE_KW, quantize_kv=quantize_kv)
    ref = jax_slice.SliceReplicaEngine(setup['jcfg'], setup['params'],
                                       num_hosts=2, sp_threshold=32, **kw)
    try:
        want = [ref.generate(p, 8, timeout=120) for p in SLICE_PROMPTS]
        ref_slice = ref.stats()['slice']
    finally:
        ref.stop()
    mesh = slice_replica.build_slice_mesh(2, cfg, device='cpu')
    assert dict(mesh.shape) == {'sequence': 1, 'tensor': 2}
    follower = slice_replica.FollowerExecutor(
        cfg, convert.to_tensor_parallel(cfg, model, mesh), device='cpu',
        **kw)
    eng = slice_replica.SliceReplicaEngine(
        cfg, model, num_hosts=2, mesh=mesh, sp_threshold=32,
        rank_channels=[coordinator.LocalRank(1, follower)], device='cpu',
        **kw)
    try:
        got = [eng.generate(p, 8, timeout=120) for p in SLICE_PROMPTS]
        stats = eng.stats()
        assert isinstance(eng.model, tensor_parallel.TensorParallel)
        for k in eng._state:
            assert torch.equal(eng._state[k], follower._state[k]), k
        for k, leaf in eng._cache.items():
            theirs = follower._cache[k]
            if not isinstance(leaf, list):
                assert torch.equal(leaf, theirs), k
                continue
            assert len(leaf) == len(theirs) == 2
            for a, b in zip(leaf, theirs):
                pairs = ([(a[j], b[j]) for j in a]
                         if isinstance(a, dict) else [(a, b)])
                assert all(torch.equal(x, y) for x, y in pairs), k
    finally:
        eng.stop()
    assert got == want
    for key in ('tensor_degree', 'sp_degree', 'sp_prefills'):
        assert stats['slice'][key] == ref_slice[key], key
    assert stats['slice']['tensor_degree'] == stats['tensor_degree'] == 2
    assert stats['slice']['sp_prefills'] == 0


# -------------------------------------------------------------- training


@pytest.mark.parametrize('axes,mode', [
    (dict(data=2, tensor=2), 'ring'),
    (dict(data=1, sequence=2, tensor=2), 'ring'),
    (dict(data=1, sequence=2, tensor=2), 'ulysses')],
    ids=['data2-tensor2', 'seq2-tensor2-ring', 'seq2-tensor2-ulysses'])
def test_tensor_mesh_step_equals_the_unsharded_step(axes, mode):
    """The capacity dispatch runs over the global batch on both sides;
    the ranks' expert partials add in f32."""
    cfg = configs.get_config(NAME, sequence_parallel=mode)
    tcfg = train.TrainConfig()
    tokens = torch.tensor(np.random.default_rng(6).integers(0, 256, (4, 17)))
    plain, _ = train.create_train_state(cfg, tcfg, device='cpu', seed=2)
    meshed, _ = train.create_train_state(cfg, tcfg, seed=2,
                                         mesh=_mesh(**axes))
    assert meshed.shards.rank_cfg.d_ff == cfg.d_ff // 2
    for _ in range(2):
        _, want = train.train_step(plain, {'tokens': tokens}, tcfg)
        _, got = train.train_step(meshed, {'tokens': tokens}, tcfg)
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5)


B, S, STEPS = 8, 16, 3


@pytest.fixture
def hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path / 'bench_logs'))
    monkeypatch.delenv(checkpoints.ENV_CHECKPOINT_DIR, raising=False)
    monkeypatch.setattr(callbacks, '_instance', None)
    monkeypatch.setattr(ref_callbacks, '_instance', None)


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


def test_cli_tensor_2_matches_reference_example(hermetic, tmp_path,
                                                monkeypatch, capsys):
    """`--tensor 2` over 8 CPU entries is data 4 x tensor 2, as the
    reference lays out its 8 virtual devices; both start from the
    reference's initial params over one token file.  The final state,
    saved, restores onto tensor 1 and, saved again, back onto tensor 2
    with the same leaves."""
    del hermetic
    tokens = str(tmp_path / 'tokens.bin')
    loader.write_token_file(
        tokens, np.random.default_rng(5).integers(0, 256, 8192))
    jcfg = jax_configs.get_config(NAME)
    params = jax.tree.map(np.asarray, nn.meta.unbox(JaxTransformer(
        jcfg).init(jax.random.PRNGKey(0),
                   jnp.zeros((B, S), jnp.int32))['params']))
    ref_init = str(tmp_path / 'ref_init')
    with ref_checkpoints.AsyncCheckpointManager(ref_init) as mgr:
        mgr.save(0, jax_train.TrainState.create(
            apply_fn=JaxTransformer(jcfg).apply, params=params,
            tx=jax_train.make_optimizer(jax_train.TrainConfig())))
    port_init = str(tmp_path / 'port_init')
    checkpoints.save_params(port_init, 0, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), params))
    common = ['--model', NAME, '--batch-size', str(B), '--seq-len', str(S),
              '--steps', str(STEPS), '--tensor', '2', '--data', tokens]
    want = _reference_cli(common + ['--init-from', ref_init], monkeypatch)
    history, state = train_llama.run(common + [
        '--init-from', port_init, '--device', 'cpu', '--mesh-devices',
        ','.join(['cpu'] * 8)])
    assert "'data': 4" in capsys.readouterr().out
    got = [(h['loss'], h['grad_norm']) for h in history]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5)

    cfg = configs.get_config(NAME)
    saved = str(tmp_path / 'tensor2')
    with checkpoints.AsyncCheckpointManager(saved) as mgr:
        mgr.save(STEPS, state)
    abstract, shardings = train.abstract_train_state(
        cfg, mesh=_mesh(data=2))
    one, start = checkpoints.restore_sharded(saved, abstract, shardings)
    assert start == STEPS + 1 and one.shards.rank_cfg == cfg
    _assert_equal(one, state)
    again = str(tmp_path / 'tensor1')
    with checkpoints.AsyncCheckpointManager(again) as mgr:
        mgr.save(STEPS, one)
    abstract, shardings = train.abstract_train_state(
        cfg, mesh=_mesh(data=4, tensor=2))
    two, _ = checkpoints.restore_sharded(again, abstract, shardings)
    assert two.shards.rank_cfg.d_ff == cfg.d_ff // 2
    _assert_equal(two, state)
