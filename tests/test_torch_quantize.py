"""The port's int8 weight-only quantization against the JAX reference,
on the CPU (models/quantize.py, the quantized Dense, the bridge).

- `quantize_params` of the port equals the reference's on the same
  tree: int8 bytes equal, scales equal, `quantization_report` equal;
  tiny, tiny-gemma (tied embedding, never quantized), tiny-qwen
  (biases stay float) and tiny-moe (expert stacks, router kept), in the
  scan and unstacked layouts, from numpy leaves and from torch tensors.
- `QuantDense.matrix(dtype)` is bitwise equal to `maybe_dequant` at f32
  and bf16.
- int8 prefill / chunk / decode logits within atol 2e-4 / rtol 2e-3 of
  `skypilot_tpu.models.decode` (the A2 tolerance; f32 on both sides);
  greedy tokens equal to the JAX engine's, paged and dense.
- The port's seeded int8 init is the quantization of its float init's
  f32 draws.
"""
from __future__ import annotations

import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models import quantize as jax_quantize
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import batching_engine as jax_engine
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import quantize
from skypilot_tpu_torch.models.transformer import QuantDense
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.serve import batching_engine

ATOL, RTOL = 2e-4, 2e-3
PROMPTS = (([3, 1, 4, 1, 5, 9, 2, 6], 6), ([7], 4),
           (list(range(5, 18)), 5), (list(range(1, 25)), 5))


@functools.lru_cache(maxsize=None)
def _ref(name: str, scan_layers: bool = True):
    jcfg = jax_configs.get_config(name, scan_layers=scan_layers)
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    return jcfg, params


def _host(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _flat(tree):
    return {jax.tree_util.keystr(p): _host(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize('scan_layers', [True, False],
                         ids=['scan', 'unstacked'])
@pytest.mark.parametrize('name', ['tiny', 'tiny-gemma', 'tiny-qwen',
                                  'tiny-moe'])
def test_quantize_params_matches_reference(name, scan_layers):
    _, params = _ref(name, scan_layers)
    ref = jax_quantize.quantize_params(params)
    want = _flat(ref)
    tree = jax.tree.map(np.asarray, params)
    tensors = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    for src in (tree, tensors):
        ours = quantize.quantize_params(src)
        got = _flat(ours)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            assert got[key].shape == value.shape, key
            assert got[key].tobytes() == value.tobytes(), key
        assert (quantize.quantization_report(ours) ==
                jax_quantize.quantization_report(ref))
    # What stays float: embeddings, norms, biases, the router.
    node = ours['layers']['layer'] if scan_layers else ours['layer_0']
    assert quantize.is_quantized_leaf(node['attn']['o_proj']['kernel'])
    assert not quantize.is_quantized_leaf(ours['embed']['embedding'])
    if name == 'tiny-qwen':
        assert not quantize.is_quantized_leaf(node['attn']['q_proj']['bias'])
    if name == 'tiny-moe':
        assert quantize.is_quantized_leaf(node['moe_mlp']['gate_proj'])
        assert not quantize.is_quantized_leaf(
            node['moe_mlp']['router']['kernel'])
    assert ('lm_head' in ours) == (name != 'tiny-gemma')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dense_matrix_bitwise_equals_maybe_dequant(dtype):
    """Every quantized Dense of a tiny model, and a kernel whose
    channels span six decades (bf16 rounding of the scale and of the
    product both show there)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, params = _ref('tiny')
    qtree = jax.tree.map(np.asarray, jax_quantize.quantize_params(params))
    model = convert.from_jax_params(configs.get_config('tiny'), qtree,
                                    device='cpu')
    rng = np.random.default_rng(7)
    wide = (rng.standard_normal((64, 4, 16)) *
            10.0 ** rng.uniform(-3, 3, (1, 4, 16))).astype(np.float32)
    leaf = jax_quantize._quantize_array(wide, (0,))  # pylint: disable=protected-access
    dense = QuantDense((64,), (4, 16), dtype=torch.float32, device='cpu')
    dense.qvalue.copy_(torch.from_numpy(np.array(leaf['qvalue'])))
    dense.scale.copy_(torch.from_numpy(np.array(leaf['scale'])))
    layer = qtree['layers']['layer']
    cases = [(dense, leaf)]
    cases += [(getattr(model.layers[1].attn, n),
               jax.tree.map(lambda a: a[1], layer['attn'][n]['kernel']))
              for n in ('q_proj', 'o_proj')]
    cases += [(model.layers[0].mlp.down_proj,
               jax.tree.map(lambda a: a[0],
                            layer['mlp']['down_proj']['kernel'])),
              (model.lm_head, qtree['lm_head']['kernel'])]
    for dense, leaf in cases:
        want = np.asarray(jax_quantize.maybe_dequant(
            jax.tree.map(jnp.asarray, leaf), jdt).astype(jnp.float32))
        got = dense.matrix(tdt)
        assert got.dtype == tdt
        got = got.to(torch.float32).numpy().reshape(want.shape)
        assert got.tobytes() == want.tobytes()


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv('SKYTPU_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('SKYTPU_DECODE_KERNEL', 'pallas')


def _quantized(name):
    jcfg, params = _ref(name)
    qparams = jax_quantize.quantize_params(params)
    model = convert.from_jax_params(
        configs.get_config(name), jax.tree.map(np.asarray, qparams),
        device='cpu')
    assert model.quantized
    return jcfg, qparams, configs.get_config(name), model


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('name', ['tiny', 'tiny-gemma', 'tiny-qwen'])
def test_int8_logits_match_jax(pallas, name):
    jcfg, qparams, tcfg, model = _quantized(name)
    toks = np.random.default_rng(2).integers(0, 256, (2, 13)).astype(
        np.int32)
    jl, jc = jax_decode.prefill(jcfg, qparams, jnp.asarray(toks[:, :8]),
                                max_len=32)
    tl, tc = decode.prefill(tcfg, model, torch.tensor(toks[:, :8]),
                            max_len=32)
    _close(tl, jl)
    jl, jc = jax_decode.prefill_chunk(jcfg, qparams,
                                      jnp.asarray(toks[:, 8:12]), jc)
    tl, tc = decode.prefill_chunk(tcfg, model,
                                  torch.tensor(toks[:, 8:12]), tc)
    _close(tl, jl)
    jl, jc = jax_decode.decode_step(jcfg, qparams,
                                    jnp.asarray(toks[:, 12:13]), jc)
    tl, tc = decode.decode_step(tcfg, model, torch.tensor(toks[:, 12:13]),
                                tc)
    _close(tl, jl)
    # int8 weights do change the logits: the float model's differ.
    fl, _ = decode.prefill(tcfg, convert.from_jax_params(
        tcfg, jax.tree.map(np.asarray, _ref(name)[1]), device='cpu'),
                           torch.tensor(toks[:, :8]), max_len=32)
    assert not torch.allclose(fl, decode.prefill(
        tcfg, model, torch.tensor(toks[:, :8]), max_len=32)[0], atol=ATOL)


def _jax_greedy(jcfg, qparams, **kw):
    saved = {k: os.environ.get(k) for k in
             ('SKYTPU_DECODE_KERNEL', 'SKYTPU_PALLAS_INTERPRET')}
    os.environ['SKYTPU_DECODE_KERNEL'] = 'pallas'
    os.environ['SKYTPU_PALLAS_INTERPRET'] = '1'
    try:
        engine = jax_engine.ContinuousBatchingEngine(
            jcfg, qparams, max_len=64, slots=2, prefill_chunk=8, **kw)
        try:
            return [engine.generate(p, n) for p, n in PROMPTS]
        finally:
            engine.stop()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize('mode', ['paged', 'dense'])
def test_int8_greedy_equals_jax_engine(mode):
    jcfg, qparams, tcfg, model = _quantized('tiny')
    kw = dict(kv_pages=48, page_size=8) if mode == 'paged' else {}
    want = _jax_greedy(jcfg, qparams, **kw)
    engine = batching_engine.ContinuousBatchingEngine(
        tcfg, model, max_len=64, slots=2, prefill_chunk=8, device='cpu',
        **kw)
    try:
        got = [engine.generate(p, n) for p, n in PROMPTS]
    finally:
        engine.stop()
    assert [list(map(int, t)) for t in got] == [
        list(map(int, t)) for t in want]


@pytest.mark.parametrize('name', ['tiny', 'tiny-qwen'])
def test_int8_init_quantizes_the_float_draws(name):
    """The seeded int8 init quantizes the same f32 draws the float init
    makes (one leaf at a time), so it equals quantize_params of the
    float model's f32 tree; biases, norms and the embedding are equal."""
    cfg = configs.get_config(name)
    fp = init_params(cfg, seed=5, device='cpu')
    q8 = init_params(cfg, seed=5, device='cpu', quantize='int8')
    assert q8.quantized and not fp.quantized
    want = _flat(quantize.quantize_params(
        jax.tree.map(lambda t: t.detach().clone(),
                     convert.param_tree(fp))))
    got = _flat(convert.param_tree(q8))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].tobytes() == value.tobytes(), key
    with pytest.raises(ValueError, match='quantize mode'):
        init_params(cfg, device='cpu', quantize='int4')


def test_dequantized_model_gives_the_int8_models_logits():
    """convert.dequantize_model: a float model whose kernels are the
    values the int8 model's calls dequantize to; its logits equal the
    int8 model's bit for bit (the chip check's reference for int8
    tokens), in f32 and with bf16 activations."""
    for dtype in (torch.float32, torch.bfloat16):
        cfg = configs.get_config('tiny-qwen', dtype=dtype)
        q8 = init_params(cfg, seed=2, device='cpu', quantize='int8')
        fp = convert.dequantize_model(q8)
        assert not fp.quantized
        toks = torch.tensor(np.random.default_rng(4).integers(
            0, 256, (2, 9)))
        a, _ = decode.prefill(cfg, q8, toks, max_len=16)
        b, _ = decode.prefill(cfg, fp, toks, max_len=16)
        assert torch.equal(a, b)
