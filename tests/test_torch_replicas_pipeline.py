"""A copy of each replicated block on every device entry that holds it,
under a pipeline: test_torch_replicas.py's checks on pipeline 2 x data
2 and pipeline 2 x tensor 2 at two microbatches, against the
reference's jitted `pipeline_train_step` on the conftest's virtual CPU
devices, the port on indexed CPU entries (one a reference device), with
that file's tolerances: `holders` against the devices of each shard,
every copy against the reference's shard on its device after two
steps, copies bit-equal to their owners, the step equal to the
one-copy mesh's.

Then the pipeline's ends: the embedding, final norm and head have a
copy on each stage's entry and the last stage reads its own head
copy; the Gemma preset's tied embedding, read on stage 0 (the lookup)
and on the last stage (the head), takes the reference's
`pipeline_loss_fn` gradient from the copies' sum.  About 20 s alone.
"""
from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_replicas as replicas
from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import pipeline as jax_pipeline
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.models.transformer import ShardedParams
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline

B, S = replicas.B, replicas.S
GRAD_RTOL, GRAD_ATOL = replicas.GRAD_RTOL, replicas.GRAD_ATOL
PIPE_LAYOUTS = ('pipeline2-data2', 'pipeline2-tensor2')
indexed = replicas.indexed
_batches = replicas._batches  # pylint: disable=protected-access


@pytest.fixture(scope='module')
def runs():
    return replicas.cached_runs()


@pytest.mark.parametrize('name', PIPE_LAYOUTS)
def test_holders_are_the_reference_devices_of_each_shard(runs, name):
    replicas.check_holders(runs(name))


@pytest.mark.parametrize('name', PIPE_LAYOUTS)
def test_every_copy_equals_the_reference_shard_on_its_device(runs, name):
    replicas.check_copies_against_reference(runs(name))


@pytest.mark.parametrize('name', PIPE_LAYOUTS)
def test_copies_are_bit_equal_to_their_owners(runs, name):
    replicas.check_bit_equal_copies(runs(name))


@pytest.mark.parametrize('name', PIPE_LAYOUTS)
def test_step_equals_the_one_copy_mesh(runs, name):
    replicas.check_one_copy(runs(name))


def _gemma_split():
    jcfg = jax_configs.get_config('tiny-gemma')
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))['params'])
    return jcfg, jax_pipeline.split_stage_params(
        jax.tree.map(np.asarray, params), 2)


def test_pipeline_head_has_a_copy_on_the_last_stage():
    """pipeline 2 on two indexed entries: the embedding, final norm and
    head have a copy on each stage's entry, the layers one on their
    stage's; the last stage's forward reads its own head copy (the
    owner, on stage 0, gets no gradient from the backward), and the
    copy sum hands it to the owner."""
    cfg = configs.get_config('tiny')
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=2),
                               indexed(2))
    state, places = train.create_train_state(cfg, mesh=mesh, seed=3)
    shards = state.shards
    for leaf in ('embed.embedding', 'final_norm.scale', 'lm_head.kernel'):
        assert list(shards.copies[leaf][(0,) * len(shards.shapes[leaf])]) \
            == [torch.device('cpu:0'), torch.device('cpu:1')], leaf
    assert places['layers.1.mlp.up_proj.kernel'].holders(2) == {(0, 0): [1]}
    layers = sum(p.numel() * 4 for n, p in state.model.named_parameters()
                 if n.startswith('layers.'))
    ends = sum(p.numel() * 4 for n, p in state.model.named_parameters()
               if not n.startswith('layers.'))
    assert shards.device_bytes() == [ends + layers // 2] * 2
    tokens = torch.tensor(_batches(6)[0]['tokens'])
    owner, last = shards.copies['lm_head.kernel'][(0, 0)].values()
    pipeline.pipeline_loss_fn(cfg, shards, tokens, mesh=mesh,
                              num_microbatches=2).backward()
    assert owner.grad is None and last.grad is not None
    want = last.grad.clone()
    shards.sum_copy_grads()
    assert torch.equal(owner.grad, want) and last.grad is None


def test_tied_embedding_copies_sum_to_the_reference_gradient():
    """tiny-gemma at pipeline 2 on two indexed entries: the embedding is
    read on stage 0 (the lookup) and on stage 1 (the tied head), each
    from its own copy; the copies' sum equals the reference's
    `pipeline_loss_fn` gradient (GRAD_RTOL / GRAD_ATOL, as
    test_torch_pipeline.py holds the merged gradients), and so does
    every other leaf."""
    jcfg, split = _gemma_split()
    tokens = _batches(7)[0]['tokens']
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(data=1, pipeline=2),
                                devices=jax.devices()[:2])
    jgrads = jax.jit(jax.grad(lambda p: jax_pipeline.pipeline_loss_fn(
        jcfg, p, tokens, mesh=jmesh, num_microbatches=2)))(split)
    cfg = configs.get_config('tiny-gemma')
    want = convert._flat_port_leaves(  # pylint: disable=protected-access
        cfg, jax.tree.map(np.asarray,
                          jax_pipeline.merge_stage_params(jgrads)))
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=2),
                               indexed(2))
    shards = ShardedParams.from_model(
        convert.from_jax_params(cfg, split, device='cpu', trainable=True),
        mesh)
    pipeline.pipeline_loss_fn(cfg, shards, torch.tensor(tokens), mesh=mesh,
                              num_microbatches=2).backward()
    embed = list(shards.copies['embed.embedding'][(0, 0)].values())
    assert [t.grad is not None for t in embed] == [True, True]
    parts = [t.grad.clone() for t in embed]
    shards.sum_copy_grads()
    assert torch.equal(embed[0].grad, parts[0] + parts[1])
    names = {id(p): n for n, p in shards.model.named_parameters()}
    got = {}
    for path, p in train.param_paths(shards.model):
        full = torch.zeros(p.shape)
        for t, idx in shards.pieces(names[id(p)]):
            full[idx] = t.grad
        got['/'.join(path)] = full.numpy()
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        np.testing.assert_allclose(got[key], leaf, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)
