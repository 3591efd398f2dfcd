"""The tensor axis of training (models/transformer.py, losses.py,
tensor_parallel.py over a mesh with tensor > 1), on the CPU, tiny, f32.

- The vocab-parallel fused CE (a list of the tensor ranks' kernel
  column blocks) against `fused_linear_cross_entropy` on the joined
  kernel: the loss within rtol 1e-5 and the gradients of the hidden
  states and of every kernel block within atol 1e-6 / rtol 1e-5 (f32,
  the ranks' partial sums added in another order), masked and not;
  no op builds a [b, s, V] tensor, nor one of b * s * V elements.
- `tensor_parallel.reduce_sum` leaves its f32 partials unchanged (each
  is its own `.to` on the sum's device) and hands each partial the
  sum's gradient.
- `ShardedParams.gather(name, device, tensor=t)` is tensor rank t's
  slice of the full leaf (the reference's placement: heads, kv heads,
  d_ff and vocab on 'tensor'), and `tree` binds each rank's narrow
  meta model; a mesh's step over tensor 2 (ring or Ulysses) equals the
  unsharded step's loss and grad_norm within rtol 1e-5
  (tests/test_torch_sharded_train.py holds it to the reference's
  sharded step).
- Refusals: tensor 4 on tiny and tiny-moe (their 2 kv heads) with the
  reference's divisibility message; tiny-moe takes tensor 2
  (tests/test_torch_moe_tensor.py trains it).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import losses
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.parallel import mesh as mesh_lib

RTOL, ATOL = 1e-5, 1e-6


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), ['cpu'] * n)


class _Shapes(TorchDispatchMode):
    """Records the shape of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize('masked', [False, True], ids=['unmasked', 'masked'])
@pytest.mark.parametrize('tp', [2, 4])
def test_vocab_parallel_fused_ce_matches_the_joined_kernel(tp, masked):
    b, s, d, vocab, chunk = 4, 16, 32, 256, 48
    rng = np.random.default_rng(tp + masked)
    hidden = torch.tensor(rng.standard_normal((b, s, d)), dtype=torch.float32)
    kernel = torch.tensor(rng.standard_normal((d, vocab)) * 0.3,
                          dtype=torch.float32)
    targets = torch.tensor(rng.integers(0, vocab, (b, s)))
    mask = (torch.tensor((rng.random((b, s)) > 0.3).astype(np.float32))
            if masked else None)
    h1 = hidden.clone().requires_grad_()
    k1 = kernel.clone().requires_grad_()
    want = losses.fused_linear_cross_entropy(h1, k1, targets, mask,
                                             vocab_chunk=chunk)
    want.backward()
    h2 = hidden.clone().requires_grad_()
    blocks = [k.clone().requires_grad_()
              for k in kernel.chunk(tp, dim=1)]
    with _Shapes() as seen:
        got = losses.fused_linear_cross_entropy(h2, blocks, targets, mask,
                                                vocab_chunk=chunk)
        got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=RTOL)
    np.testing.assert_allclose(h2.grad.numpy(), h1.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(torch.cat([k.grad for k in blocks], 1).numpy(),
                               k1.grad.numpy(), rtol=RTOL, atol=ATOL)
    assert seen.shapes
    assert all(np.prod(shape) < b * s * vocab and shape[-1:] != (vocab,)
               for shape in seen.shapes), max(seen.shapes, key=np.prod)


def test_reduce_sum_leaves_its_partials_unchanged():
    rng = np.random.default_rng(3)
    parts = [torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32,
                          requires_grad=True) for _ in range(3)]
    before = [p.detach().clone() for p in parts]
    total = tensor_parallel.reduce_sum([p * 1.0 for p in parts], 'cpu',
                                       torch.float32)
    assert torch.equal(total, (before[0] + before[1]) + before[2])
    inputs = [p * 1.0 for p in parts]
    snap = [t.detach().clone() for t in inputs]
    tensor_parallel.reduce_sum(inputs, 'cpu', torch.float32)
    assert all(torch.equal(t, c) for t, c in zip(inputs, snap))
    g = torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32)
    total.backward(g)
    assert all(torch.equal(p.grad, g) for p in parts)
    assert all(torch.equal(p, c) for p, c in zip(parts, before))
    # bf16 partials: f32 adds, rounded once.
    halves = [p.detach().to(torch.bfloat16) for p in parts]
    got = tensor_parallel.reduce_sum(halves, 'cpu', torch.bfloat16)
    want = sum(h.to(torch.float32) for h in halves).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_tensor_rank_gathers_its_slice():
    cfg = configs.get_config('tiny')
    mesh = _mesh(data=1, fsdp=2, tensor=2)
    state, placements = train.create_train_state(cfg, mesh=mesh, seed=5)
    plain, _ = train.create_train_state(cfg, device='cpu', seed=5)
    shards = state.shards
    assert shards.rank_cfg == tensor_parallel.rank_config(cfg, 2)
    assert len(shards.rank_models) == 2
    assert all(m.cfg == shards.rank_cfg for m in shards.rank_models)
    narrow = dict(shards.rank_models[0].named_parameters())
    for name, p in plain.model.named_parameters():
        placement = placements[name]
        for t in range(2):
            index = placement.index(mesh.position(tensor=t), p.shape)
            # Only the dims 'tensor' splits are cut; fsdp's are joined.
            index = tuple(
                ix if 'tensor' in axes else slice(None)
                for ix, axes in zip(index, placement.spec +
                                    ((),) * (p.dim() - len(placement.spec))))
            got = shards.gather(name, 'cpu', tensor=t)
            assert torch.equal(got, p[index]), (name, t)
            assert got.shape == narrow[name].shape, name
    tree = shards.tree('layers.0.attn.', ['cpu', 'cpu'])
    assert sorted({k.split('.', 1)[0] for k in tree}) == ['0', '1']
    per_position = shards.position_bytes()
    total = sum(p.numel() * 4 for p in plain.model.parameters())
    assert len(set(per_position)) == 1 and per_position[0] < total / 2


@pytest.mark.parametrize('axes,mode', [
    (dict(data=2, tensor=2), 'ring'),
    (dict(data=1, sequence=2, tensor=2), 'ulysses')],
    ids=['data2-tensor2', 'seq2-tensor2-ulysses'])
@pytest.mark.parametrize('fused', [False, True], ids=['loss_fn', 'fused'])
def test_tensor_mesh_step_equals_the_unsharded_step(fused, axes, mode):
    """Ulysses at tensor 2 runs a rank's 2 q heads over sp 2 with its
    one kv head broadcast (`broadcast_gqa_if_indivisible`)."""
    cfg = configs.get_config('tiny', sequence_parallel=mode)
    tcfg = train.TrainConfig(fused_ce=fused, vocab_chunk=96)
    tokens = torch.tensor(np.random.default_rng(6).integers(0, 256, (4, 17)))
    plain, _ = train.create_train_state(cfg, tcfg, device='cpu', seed=2)
    meshed, _ = train.create_train_state(cfg, tcfg, seed=2,
                                         mesh=_mesh(**axes))
    for _ in range(2):
        _, want = train.train_step(plain, {'tokens': tokens}, tcfg)
        _, got = train.train_step(meshed, {'tokens': tokens}, tcfg)
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=RTOL)


def test_refusals_name_the_divisibility_and_a16c():
    tiny = configs.get_config('tiny')
    with pytest.raises(ValueError, match=r'tensor=4 must divide n_kv_heads '
                                         r'\(2\)'):
        train.create_train_state(tiny, mesh=_mesh(data=1, tensor=4))
    with pytest.raises(ValueError, match='tensor=4 must divide'):
        train.abstract_train_state(tiny, mesh=_mesh(data=1, tensor=4))
    # An MoE config takes tensor 2 (its stacks split on d_ff) and
    # refuses tensor 4 with the same divisibility message.
    moe = configs.get_config('tiny-moe')
    state, _ = train.create_train_state(moe, mesh=_mesh(data=1, tensor=2))
    assert state.shards.rank_cfg.d_ff == moe.d_ff // 2
    assert state.shards.rank_cfg.n_experts == moe.n_experts
    with pytest.raises(ValueError, match=r'tensor=4 must divide n_kv_heads '
                                         r'\(2\)'):
        train.create_train_state(moe, mesh=_mesh(data=1, tensor=4))
    with pytest.raises(NotImplementedError, match='A17g'):
        train.create_train_state(moe, mesh=_mesh(data=1, expert=2))
