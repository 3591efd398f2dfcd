"""The real-weights path on the card (int8 weights, checkpoints).  Every
test needs an NVIDIA GPU and skips without one; this file imports no
JAX, so it runs on a GPU host as it is:

    python -m pytest tests/test_torch_real_weights_gpu.py -q

- `quantize_params` on CUDA tensors is byte-equal to the same call on
  the CPU over the `small` preset's f32 tree (int8 values and scales).
- An int8-weight paged engine's greedy tokens equal those of the bf16
  model whose kernels are the dequantized values
  (`convert.dequantize_model`): both GEMMs see the same bf16 operands.
- `restore_params(..., device='cuda')` is bit-equal to the saved tree.
"""
from __future__ import annotations

import pytest
import torch

from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import quantize
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.serve import batching_engine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    return torch.device('cuda', 0)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def test_quantize_on_cuda_equals_cpu(cuda):
    cfg = configs.get_config('small', dtype=torch.float32)
    tree = convert.param_tree(init_params(cfg, seed=0, device=cuda))
    on_card = dict(_flat(quantize.quantize_params(tree)))
    on_host = dict(_flat(quantize.quantize_params(
        {k: v for k, v in convert._map_tree(  # pylint: disable=protected-access
            lambda t: t.cpu(), tree).items()})))
    assert sorted(on_card) == sorted(on_host)
    n_int8 = 0
    for key, value in on_host.items():
        got = on_card[key]
        assert got.device.type == 'cuda', key
        assert got.dtype == value.dtype, key
        assert torch.equal(got.cpu(), value), key
        n_int8 += value.dtype == torch.int8
    assert n_int8 == 7 * cfg.n_layers + 1


@pytest.mark.parametrize('quantize_kv', [False, True],
                         ids=['bf16-pool', 'int8-pool'])
def test_int8_engine_equals_dequantized_model(cuda, quantize_kv):
    cfg = configs.get_config('small')
    q8 = init_params(cfg, seed=0, device=cuda, quantize='int8')
    fp = convert.dequantize_model(q8)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 40, 1, 64)]
    tokens = []
    for model in (q8, fp):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=256, slots=4, prefill_chunk=64,
            kv_pages=96, page_size=16, quantize_kv=quantize_kv,
            device=cuda)
        try:
            reqs = [engine.submit(p, 12) for p in prompts]
            tokens.append([list(r.result(timeout=300)) for r in reqs])
        finally:
            engine.stop()
    assert tokens[0] == tokens[1]


def test_restore_on_cuda_is_bit_equal(cuda, tmp_path):
    cfg = configs.get_config('small')
    for quantized in (None, 'int8'):
        model = init_params(cfg, seed=3, device=cuda, quantize=quantized)
        tree = convert.param_tree(model)
        d = str(tmp_path / f'ckpt-{quantized}')
        checkpoints.save_params(d, 0, tree)
        restored = dict(_flat(checkpoints.restore_params(d, device=cuda)))
        want = dict(_flat(tree))
        assert sorted(restored) == sorted(want)
        for key, value in want.items():
            assert restored[key].device == value.device, key
            assert restored[key].dtype == value.dtype, key
            assert torch.equal(restored[key], value), key
