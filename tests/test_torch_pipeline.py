"""Pipeline-parallel training (parallel/pipeline.py) against the
reference's GPipe schedule, on the CPU.

The reference runs `pipeline_loss_fn` jitted over the conftest's
virtual CPU devices; the port runs its schedule over a mesh of as many
'cpu' entries.  Both read the same parameters (the reference's init,
stage-split, carried over by `convert.from_jax_params` and cut onto
the port's mesh by `ShardedParams.from_model`) and the same numpy
tokens (`tiny`, batch 4 x 33).  Tolerances, f32 on both sides: losses
within rtol 2e-5 (the reference's own pipeline-vs-plain tolerance),
merged gradients within rtol 5e-4 / atol 5e-5, and after one
`pipeline_train_step` the loss and grad norm within rtol 1e-5 and
every parameter within rtol 1e-5 / atol 3e-5: Adam's first step moves
a parameter by lr g / (|g| + eps), so a gradient near eps whose
summation noise is a visible part of it moves by a visibly different
amount (1 element of 4096 reads 2.4e-6; test_torch_sharded_train.py
bounds the same noise at 3e-5), while a parameter that did not step
would be off by about lr, 3e-4.
An MoE model's pipelined loss depends on the microbatch count (the
capacity dispatch runs over one microbatch), so `tiny-moe` is held to
the reference's pipelined loss, not the unpipelined one.
"""
from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import pipeline as jax_pipeline
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.models import transformer
from skypilot_tpu_torch.models.transformer import ShardedParams
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline

B, S = 4, 32
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
STEP_RTOL, STEP_ATOL = 1e-5, 3e-5


def _meshes(axes):
    """(reference mesh, port mesh) of one layout, data=1 unless given."""
    axes = {'data': 1, **axes}
    n = int(np.prod(list(axes.values())))
    return (jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n]),
            mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n))


def _tokens(seed, b=B, s=S, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)


def _reference_params(name, s=S, **overrides):
    jcfg = jax_configs.get_config(name, **overrides)
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((B, s), jnp.int32))['params'])
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope='module')
def tiny():
    """(reference params, stage-split at 2, numpy tokens)."""
    params = _reference_params('tiny')
    return params, jax_pipeline.split_stage_params(params, 2), _tokens(1)


def _reference_loss(name, split, tokens, axes, m, **overrides):
    jcfg = jax_configs.get_config(name, **overrides)
    jmesh, _ = _meshes(axes)
    return float(jax.jit(lambda p, t: jax_pipeline.pipeline_loss_fn(
        jcfg, p, t, mesh=jmesh, num_microbatches=m))(split, tokens))


def _port(name, split, axes, **overrides):
    """(cfg, shards, mesh): the reference's stage-split params on the
    port's mesh."""
    cfg = configs.get_config(name, **overrides)
    _, mesh = _meshes(axes)
    model = convert.from_jax_params(cfg, split, device='cpu',
                                    trainable=True)
    return cfg, ShardedParams.from_model(model, mesh), mesh


def _port_loss(name, split, tokens, axes, m, **overrides):
    cfg, shards, mesh = _port(name, split, axes, **overrides)
    return float(pipeline.pipeline_loss_fn(
        cfg, shards, torch.tensor(tokens), mesh=mesh,
        num_microbatches=m).detach())


def _grads(shards):
    """{parameter name: its gradient, whole}."""
    out = {}
    for name, shape in shards.shapes.items():
        full = torch.zeros(shape)
        for t, idx in shards.pieces(name):
            full[idx] = t.grad
        out[name] = full.numpy()
    return out


def _by_path(model, leaves):
    """{parameter name: x} -> {port tree path joined with '/': x}."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {'/'.join(path): leaves[names[id(p)]]
            for path, p in train.param_paths(model)}


def test_split_merge_roundtrip(tiny):
    params, split, _ = tiny
    port_split = pipeline.split_stage_params(params, 2)
    jax.tree.map(np.testing.assert_array_equal, port_split, split)
    jax.tree.map(np.testing.assert_array_equal,
                 pipeline.merge_stage_params(port_split), params)
    # The unstacked layout (`param_tree`'s `layer_{i}`, torch leaves)
    # splits to the same tree.
    model = convert.from_jax_params(configs.get_config('tiny'), params,
                                    device='cpu', trainable=True)
    torch_split = pipeline.split_stage_params(convert.param_tree(model), 2)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a.detach().numpy(), b), torch_split, split)
    # from_jax_params reads a stage-split tree as the stacked one.
    again = convert.from_jax_params(configs.get_config('tiny'), split,
                                    device='cpu', trainable=True)
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize('num_microbatches', [1, 2, 4])
def test_pipeline_loss_matches_reference(tiny, num_microbatches):
    _, split, tokens = tiny
    axes = {'pipeline': 2}
    want = _reference_loss('tiny', split, tokens, axes, num_microbatches)
    got = _port_loss('tiny', split, tokens, axes, num_microbatches)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_pipeline_grads_match_reference(tiny):
    _, split, tokens = tiny
    jcfg = jax_configs.get_config('tiny')
    jmesh, _ = _meshes({'pipeline': 2})
    jgrads = jax.jit(jax.grad(lambda p: jax_pipeline.pipeline_loss_fn(
        jcfg, p, tokens, mesh=jmesh, num_microbatches=2)))(split)
    want = convert._flat_port_leaves(  # pylint: disable=protected-access
        jcfg, jax.tree.map(np.asarray,
                           jax_pipeline.merge_stage_params(jgrads)))
    cfg, shards, mesh = _port('tiny', split, {'pipeline': 2})
    pipeline.pipeline_loss_fn(cfg, shards, torch.tensor(tokens), mesh=mesh,
                              num_microbatches=2).backward()
    got = _by_path(shards.model, _grads(shards))
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        np.testing.assert_allclose(got[key], leaf, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)


def test_pipeline_forward_matches_reference(tiny):
    """data 2 x pipeline 2 at M = 2: the logits, put back in the global
    row order from the batch ranks' microbatch-major rows, equal the
    reference's pipeline_forward (atol 2e-4 / rtol 2e-3, the port's
    logits tolerance)."""
    _, split, tokens = tiny
    axes = {'data': 2, 'pipeline': 2}
    jcfg = jax_configs.get_config('tiny')
    jmesh, _ = _meshes(axes)
    want = np.asarray(jax.jit(lambda p, t: jax_pipeline.pipeline_forward(
        jcfg, p, t, mesh=jmesh, num_microbatches=2))(split, tokens[:, :-1]))
    cfg, shards, mesh = _port('tiny', split, axes)
    got = pipeline.pipeline_forward(cfg, shards,
                                    torch.tensor(tokens[:, :-1]), mesh=mesh,
                                    num_microbatches=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-3,
                               atol=2e-4)


# name -> (mesh axes, sequence_parallel, microbatches)
COMPOSED = {
    'data2': ({'data': 2, 'pipeline': 2}, 'ring', 2),
    'fsdp2': ({'pipeline': 2, 'fsdp': 2}, 'ring', 2),
    'tensor2': ({'pipeline': 2, 'tensor': 2}, 'ring', 2),
    'sequence2-ring': ({'pipeline': 2, 'sequence': 2}, 'ring', 2),
    'sequence2-ulysses': ({'pipeline': 2, 'sequence': 2}, 'ulysses', 2),
}


@pytest.mark.parametrize('case', sorted(COMPOSED))
def test_pipeline_composes_with_mesh_axes(tiny, case):
    _, split, tokens = tiny
    axes, mode, m = COMPOSED[case]
    want = _reference_loss('tiny', split, tokens, axes, m,
                           sequence_parallel=mode)
    got = _port_loss('tiny', split, tokens, axes, m, sequence_parallel=mode)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_pipeline_sp_ulysses_gqa():
    """pipeline 2 x sequence 4 on tiny (2 kv heads, broadcast up to the
    4 sequence ranks): Ulysses equals the reference's pipelined loss and
    the ring; `run_pipeline_train_step` takes the same step either way."""
    axes = {'pipeline': 2, 'sequence': 4}
    params = _reference_params('tiny', s=64)
    split = jax_pipeline.split_stage_params(params, 2)
    tokens = _tokens(5, b=2, s=64)
    want = _reference_loss('tiny', split, tokens, axes, 2,
                           sequence_parallel='ulysses')
    got = {mode: _port_loss('tiny', split, tokens, axes, 2,
                            sequence_parallel=mode)
           for mode in ('ulysses', 'ring')}
    assert configs.get_config('tiny').n_kv_heads == 2
    np.testing.assert_allclose(got['ulysses'], want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got['ulysses'], got['ring'], rtol=1e-4)
    _, mesh = _meshes(axes)
    steps = [pipeline.run_pipeline_train_step(
        configs.get_config('tiny', sequence_parallel=mode),
        train.TrainConfig(), mesh, batch=2, seq=64, num_microbatches=2)
        for mode in ('ulysses', 'ring')]
    assert np.isfinite(steps[0])
    assert steps[0] == pytest.approx(steps[1], rel=1e-4)


def test_pipeline_gemma_family_parity():
    """Tied, scaled embeddings and the +1 norm: the ends the pipeline
    runs on stage 0 and the last stage."""
    params = _reference_params('tiny-gemma', s=16)
    split = jax_pipeline.split_stage_params(params, 2)
    tokens = _tokens(7, s=16)
    want = _reference_loss('tiny-gemma', split, tokens, {'pipeline': 2}, 2)
    got = _port_loss('tiny-gemma', split, tokens, {'pipeline': 2}, 2)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize('axes', [{'pipeline': 2},
                                  {'pipeline': 2, 'sequence': 2}],
                         ids=['pipeline2', 'pipeline2-sequence2'])
def test_moe_dispatches_per_microbatch(axes):
    """tiny-moe at M = 2 holds the reference's pipelined loss: the
    capacity dispatch runs over one microbatch's rows (and, with a
    sequence axis, over one sequence rank's chunk), so it differs from
    the loss at M = 1."""
    params = _reference_params('tiny-moe')
    split = jax_pipeline.split_stage_params(params, 2)
    tokens = _tokens(3)
    want = {m: _reference_loss('tiny-moe', split, tokens, axes, m)
            for m in (1, 2)}
    got = {m: _port_loss('tiny-moe', split, tokens, axes, m)
           for m in (1, 2)}
    for m in (1, 2):
        np.testing.assert_allclose(got[m], want[m], rtol=LOSS_RTOL)
    # The test tells the two apart: M = 2 moves the loss by 5x its
    # tolerance or more.
    assert abs(want[2] - want[1]) > 5 * LOSS_RTOL * abs(want[1])


def test_stage_param_shardings_compose():
    """pipeline 2 x tensor 2: every position holds exactly the slice of
    each leaf that the reference's stage_param_shardings gives its
    device (layer i on stage i's positions, cut over 'tensor'; the
    embedding replicated over 'pipeline', its vocab over 'tensor')."""
    jcfg = jax_configs.get_config('tiny')
    cfg = configs.get_config('tiny')
    jmesh, mesh = _meshes({'pipeline': 2, 'tensor': 2})
    jshard = jax_pipeline.stage_param_shardings(jcfg, jmesh, 2)
    places = pipeline.stage_param_shardings(cfg, mesh, 2)
    shapes = jax.tree.map(lambda a: a.shape,
                          pipeline.split_stage_params(
                              _reference_params('tiny'), 2))
    devices = list(jmesh.devices.flat)
    meta = transformer.Transformer(cfg, device='meta', trainable=True)
    names = {id(p): n for n, p in meta.named_parameters()}
    paths = train.param_paths(meta)
    assert len(paths) == len(places)
    for path, p in paths:
        name = names[id(p)]
        if path[0].startswith('layer_'):
            layer = int(path[0][len('layer_'):])
            node, shape = jshard['layers']['layer'], shapes['layers']['layer']
            for key in path[1:]:
                node, shape = node[key], shape[key]
            index = node.devices_indices_map(shape)
            for pos, dev in enumerate(devices):
                stage = index[dev][0]
                assert places[name].holds(pos) == (stage.start <= layer <
                                                   stage.stop), (name, pos)
                if places[name].holds(pos):
                    assert places[name].index(pos, p.shape) == \
                        index[dev][2:], (name, pos)
        else:
            node, shape = jshard, shapes
            for key in path:
                node, shape = node[key], shape[key]
            index = node.devices_indices_map(shape)
            for pos, dev in enumerate(devices):
                assert places[name].holds(pos)
                assert places[name].index(pos, p.shape) == index[dev], name
    q = places['layers.1.attn.q_proj.kernel']
    assert q.at == (('pipeline', 1),) and ('tensor',) in q.spec
    assert ('tensor',) in places['embed.embedding'].spec
    assert jshard['layers']['layer']['attn']['q_proj'][
        'kernel'].spec[0] == 'pipeline'
    # The shape-only alias: layers by stage, replicated within it.
    alias = pipeline.pipeline_param_shardings(
        transformer.Transformer(cfg, device='meta', trainable=True), mesh)
    assert alias['layers.0.mlp.up_proj.kernel'].at == (('pipeline', 0),)
    assert all(p.is_replicated() for n, p in alias.items()
               if not n.startswith('layers.'))


def _reference_step(axes, m):
    """The reference's stage-split state and one jitted pipelined step
    on numpy tokens -> (state before, state after, metrics, tokens)."""
    jcfg = jax_configs.get_config('tiny')
    jmesh, _ = _meshes(axes)
    tcfg = jax_train.TrainConfig()
    state, shardings = jax_pipeline.create_pipeline_train_state(
        jcfg, tcfg, mesh=jmesh, batch_size=B, seq_len=S)
    before = jax.tree.map(np.asarray, state)
    tokens = _tokens(11)
    step = jax.jit(jax_pipeline.pipeline_train_step(jcfg, jmesh, m),
                   in_shardings=(shardings, None),
                   out_shardings=(shardings, None))
    with jmesh:
        after, metrics = step(state, {'tokens': tokens})
    return before, jax.tree.map(np.asarray, after), metrics, tokens


def _adam(opt_state):
    if hasattr(opt_state, 'mu'):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam(sub)
            if found is not None:
                return found
    return None


def test_pipeline_train_step_matches_reference():
    """One pipeline_train_step at pipeline 2 x tensor 2 (M = 2) from the
    reference's initial state: loss, grad norm and the updated
    parameters."""
    axes, m = {'pipeline': 2, 'tensor': 2}, 2
    before, after, jmetrics, tokens = _reference_step(axes, m)
    cfg = configs.get_config('tiny')
    _, mesh = _meshes(axes)
    state, places = pipeline.create_pipeline_train_state(
        cfg, train.TrainConfig(), mesh=mesh, batch_size=B, seq_len=S)
    assert places['layers.0.attn.q_proj.kernel'].at == (('pipeline', 0),)
    adam = _adam(before.opt_state)
    convert.load_reference_train_state(
        state, before.params, adam.mu, adam.nu, count=int(adam.count),
        step=int(before.step))
    step = pipeline.pipeline_train_step(cfg, mesh, m)
    state, metrics = step(state, {'tokens': torch.tensor(tokens)})
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=STEP_RTOL, err_msg=key)
    want = convert._flat_port_leaves(cfg, after.params)  # pylint: disable=protected-access
    got = {'/'.join(path): t.numpy()
           for path, t in train.snapshot(state).params}
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        np.testing.assert_allclose(got[key], leaf, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)
    assert state.step == 1


def test_train_step_on_a_pipeline_mesh_is_the_schedule(monkeypatch):
    """`train.train_step` on a pipeline mesh runs the GPipe schedule with
    accum_steps microbatches: one reentrant checkpoint per (stage,
    microbatch) under remat, the bits of `pipeline_train_step`, and
    each stage's positions hold only their layers."""
    cfg = configs.get_config('tiny', remat=True)
    _, mesh = _meshes({'pipeline': 2, 'fsdp': 2})
    tokens = torch.tensor(_tokens(13))
    checkpoint = pipeline.torch_checkpoint.checkpoint
    flags = []

    def spy(*args, **kwargs):
        flags.append(kwargs.get('use_reentrant'))
        return checkpoint(*args, **kwargs)

    monkeypatch.setattr(pipeline.torch_checkpoint, 'checkpoint', spy)
    runs = []
    for make in (lambda: train.make_train_step(
                     train.TrainConfig(accum_steps=2)),
                 lambda: pipeline.pipeline_train_step(cfg, mesh, 2)):
        state, _ = train.create_train_state(cfg, mesh=mesh, seed=2)
        runs.append(make()(state, {'tokens': tokens})[1])
    assert flags == [True] * (2 * 2) * 2
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    per_position = state.shards.position_bytes()
    layer0 = sum(p.numel() * 4 for n, p in state.model.named_parameters()
                 if n.startswith('layers.0.'))
    layer1 = sum(p.numel() * 4 for n, p in state.model.named_parameters()
                 if n.startswith('layers.1.'))
    # fsdp 2 halves the embed dim; stage 0 = positions 0, 1.
    assert per_position[0] - per_position[2] == (layer0 - layer1) // 2
    assert layer0 == layer1


def test_fused_ce_and_mask_on_a_pipeline_mesh():
    """The fused CE over a masked batch on pipeline 2 x fsdp 2 at M = 2:
    three steps' losses and grad norms equal the one-device step's
    (rtol 1e-5): the mask and targets follow the inputs' microbatch
    rows."""
    cfg = configs.get_config('tiny')
    tcfg = train.TrainConfig(fused_ce=True, vocab_chunk=96, accum_steps=2)
    _, mesh = _meshes({'pipeline': 2, 'fsdp': 2})
    piped, _ = train.create_train_state(cfg, tcfg, mesh=mesh, seed=4)
    plain, _ = train.create_train_state(cfg, tcfg, device='cpu', seed=4)
    rng = np.random.default_rng(17)
    for _ in range(3):
        tokens = rng.integers(0, 256, (B, S + 1))
        batch = {'inputs': torch.tensor(tokens[:, :-1]),
                 'targets': torch.tensor(tokens[:, 1:]),
                 'mask': torch.tensor((rng.random((B, S)) > 0.25
                                       ).astype(np.float32))}
        _, got = train.train_step(piped, batch, tcfg)
        _, want = train.train_step(plain, batch, tcfg)
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=STEP_RTOL, err_msg=key)


def test_checkpoint_restores_onto_a_pipeline_mesh(tmp_path):
    """A pipeline state's step written whole (`snapshot`) restores onto
    another pipeline mesh (`abstract_train_state` + `restore_sharded`)
    bit-equal, each layer's blocks on its stage's positions."""
    from skypilot_tpu_torch.data import checkpoints
    cfg = configs.get_config('tiny')
    _, mesh = _meshes({'pipeline': 2, 'fsdp': 2})
    state, _ = train.create_train_state(cfg, mesh=mesh, seed=6)
    train.train_step(state, {'tokens': torch.tensor(_tokens(19))},
                     train.TrainConfig(accum_steps=2))
    saved = train.snapshot(state)
    checkpoints.save_train_step(str(tmp_path), 0, saved)
    _, other = _meshes({'pipeline': 2, 'tensor': 2})
    abstract, shardings = train.abstract_train_state(cfg, mesh=other)
    restored, start = checkpoints.restore_sharded(str(tmp_path), abstract,
                                                  shardings)
    assert start == 1
    again = train.snapshot(restored)
    for (path, a), (_, b) in zip(saved.params + saved.mu + saved.nu,
                                 again.params + again.mu + again.nu):
        assert torch.equal(a, b), path
    owners = shardings['layers.1.attn.q_proj.kernel'].owners(3)
    assert all(other.coords(pos)['pipeline'] == 1 for pos in owners.values())


def test_pipeline_rejects_bad_shapes(tiny):
    params, split, tokens = tiny
    cfg, shards, mesh = _port('tiny', split, {'pipeline': 2})
    with pytest.raises(ValueError, match='not divisible'):
        pipeline.pipeline_loss_fn(cfg, shards, torch.tensor(tokens),
                                  mesh=mesh, num_microbatches=3)
    with pytest.raises(ValueError, match='not divisible'):
        pipeline.split_stage_params(params, 3)
    with pytest.raises(ValueError, match='not divisible'):
        train.create_train_state(cfg, mesh=_meshes({'pipeline': 3})[1])
    with pytest.raises(ValueError, match='not divisible'):
        pipeline.create_pipeline_train_state(
            cfg, mesh=_meshes({'pipeline': 2, 'sequence': 2})[1],
            batch_size=B, seq_len=33)


def test_check_mesh_refuses_the_expert_axis():
    cfg = configs.get_config('tiny-moe')
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=2,
                                                   expert=2), ['cpu'] * 4)
    with pytest.raises(NotImplementedError, match='A17g'):
        train.create_train_state(cfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match='A17g'):
        pipeline.stage_param_shardings(cfg, mesh, 2)


def test_pipeline_entry_points_raise_without_cuda(monkeypatch):
    from skypilot_tpu_torch import profile_pipeline
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    mesh = mesh_lib.Mesh(['cuda:0'] * 2, {'data': 1, 'pipeline': 2})
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pipeline.run_pipeline_train_step(
            configs.get_config('tiny'), None, mesh, batch=2, seq=8,
            num_microbatches=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        profile_pipeline.main([])
