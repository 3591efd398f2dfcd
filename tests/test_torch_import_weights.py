"""The port's HF safetensors importer against the reference's, on the
CPU (models/import_weights.py, utils/safetensors_io.py).

Tiny randomly-initialised HF models (torch CPU, `transformers`; skipped
without it) are saved as safetensors in tmp_path, as
tests/unit/test_import_weights.py does, then read by both packages:

- `config_from_hf`: equal configs field for field (llama plain,
  rope_scaling 'llama3' and 'linear', qwen2, gemma, mixtral), and the
  same exception types for unsupported scaling, an active sliding
  window, a missing tensor and a bad shape;
- `load_params`: the same tree, leaf for leaf bit-equal (f32, and bf16
  from a sharded index), Mixtral's expert stacks included;
- `convert`: the step it streams restores bit-equal to `load_params`;
  model_config.json written by either package reads back equal in the
  other;
- the port's logits on the imported weights within atol 2e-4 / rtol
  2e-3 of HF transformers' (Gemma 3e-4, as the reference's test);
- the port's long-context RoPE (`_rope_freqs`, 'llama3' and 'linear')
  equal to the reference's frequencies, prefill logits within the A2
  tolerance.
"""
from __future__ import annotations

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models import import_weights as ref_iw
from skypilot_tpu.models import transformer as jax_transformer
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import import_weights
from skypilot_tpu_torch.models import transformer

transformers = pytest.importorskip('transformers')

ATOL, RTOL = 2e-4, 2e-3
TOKENS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]]


def _llama(**kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=112,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, tie_word_embeddings=False)
    base.update(kw)
    return transformers.LlamaConfig(**base), transformers.LlamaForCausalLM


FAMILIES = {
    'llama': lambda: _llama(),
    'llama3-scaling': lambda: _llama(rope_scaling={
        'rope_type': 'llama3', 'factor': 8.0, 'low_freq_factor': 1.0,
        'high_freq_factor': 4.0, 'original_max_position_embeddings': 16}),
    'linear-scaling': lambda: _llama(
        rope_scaling={'type': 'linear', 'factor': 4.0}),
    'qwen2': lambda: (transformers.Qwen2Config(
        vocab_size=96, hidden_size=48, intermediate_size=80,
        num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=1e6,
        tie_word_embeddings=False), transformers.Qwen2ForCausalLM),
    'gemma': lambda: (transformers.GemmaConfig(
        vocab_size=128, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=12, max_position_embeddings=64, rope_theta=10000.0,
        hidden_activation='gelu_pytorch_tanh'),
        transformers.GemmaForCausalLM),
    'mixtral': lambda: (transformers.MixtralConfig(
        vocab_size=96, hidden_size=48, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rope_theta=1e6,
        tie_word_embeddings=False), transformers.MixtralForCausalLM),
}


def _save_hf(family, tmp_path):
    torch.manual_seed(0)
    cfg, cls = FAMILIES[family]()
    model = cls(cfg).eval()
    src = tmp_path / 'hf'
    model.save_pretrained(src, safe_serialization=True)
    (src / 'config.json').write_text(json.dumps(cfg.to_dict()))
    return str(src), model


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield '/'.join(prefix), tree


def _bits(x) -> bytes:
    if torch.is_tensor(x):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.name == 'bfloat16' else x).tobytes()


def _same_tree(ours, ref):
    a, b = dict(_flat(ours)), dict(_flat(ref))
    assert sorted(a) == sorted(b)
    for key, leaf in b.items():
        assert tuple(a[key].shape) == tuple(np.shape(leaf)), key
        assert _bits(a[key]) == _bits(leaf), key


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_load_params_and_config_match_reference(tmp_path, family):
    src, _ = _save_hf(family, tmp_path)
    hf = json.loads(open(f'{src}/config.json').read())
    ours, family_a = import_weights.config_from_hf(hf)
    ref, family_b = ref_iw.config_from_hf(hf)
    assert family_a == family_b
    assert ours.to_json_dict() == ref.to_json_dict()
    params, cfg = import_weights.load_params(src)
    ref_params, _ = ref_iw.load_params(src)
    assert cfg == ours
    _same_tree(params, ref_params)
    assert all(t.dtype == torch.float32 for _, t in _flat(params))
    if family == 'mixtral':
        # The tree becomes a serving MoE model, leaf for leaf (its
        # tokens against the reference: tests/test_torch_moe.py).
        model = convert.from_jax_params(cfg.replace(dtype=torch.float32),
                                        params, device='cpu')
        _same_tree(convert.to_jax_params(model), params)


@pytest.mark.parametrize('family', ['llama', 'llama3-scaling',
                                    'linear-scaling', 'qwen2', 'gemma'])
def test_logits_match_hf(tmp_path, family):
    src, hf_model = _save_hf(family, tmp_path)
    params, cfg = import_weights.load_params(src)
    cfg = cfg.replace(dtype=torch.float32, remat=False)
    model = convert.from_jax_params(cfg, params, device='cpu')
    with torch.no_grad():
        ours = model(torch.tensor(TOKENS)).numpy()
        theirs = hf_model(torch.tensor(TOKENS)).logits.float().numpy()
    np.testing.assert_allclose(ours, theirs,
                               atol=3e-4 if family == 'gemma' else ATOL,
                               rtol=RTOL)
    if cfg.rope_scaling_type is not None:
        # The scaling must change the forward.
        plain = convert.from_jax_params(
            cfg.replace(rope_scaling_type=None), params, device='cpu')
        with torch.no_grad():
            assert not np.allclose(plain(torch.tensor(TOKENS)).numpy(),
                                   theirs, atol=ATOL)


def test_sharded_index_in_bf16(tmp_path):
    """A sharded (index.json) checkpoint stored in BF16, read as raw
    bits: bf16 leaves bit-equal to the reference's ml_dtypes ones, and
    widened to f32 exactly."""
    from safetensors.torch import save_file
    cfg, cls = _llama(vocab_size=64, hidden_size=32, intermediate_size=48,
                      num_key_value_heads=4)
    torch.manual_seed(1)
    model = cls(cfg).eval().bfloat16()
    src = tmp_path / 'hf'
    src.mkdir()
    state = dict(model.state_dict())
    names = sorted(state)
    half = len(names) // 2
    weight_map = {}
    for fname, keys in (('model-00001-of-00002.safetensors', names[:half]),
                        ('model-00002-of-00002.safetensors', names[half:])):
        save_file({k: state[k].contiguous() for k in keys},
                  str(src / fname))
        weight_map.update({k: fname for k in keys})
    (src / 'model.safetensors.index.json').write_text(
        json.dumps({'weight_map': weight_map}))
    (src / 'config.json').write_text(json.dumps(cfg.to_dict()))
    ours, _ = import_weights.load_params(str(src), dtype='bfloat16')
    ref, _ = ref_iw.load_params(str(src), dtype='bfloat16')
    _same_tree(ours, ref)
    assert ours['embed']['embedding'].dtype == torch.bfloat16
    assert torch.equal(ours['embed']['embedding'],
                       model.model.embed_tokens.weight.detach())
    wide, _ = import_weights.load_params(str(src))
    assert torch.equal(wide['embed']['embedding'],
                       model.model.embed_tokens.weight.detach().float())


def test_same_errors_as_reference(tmp_path):
    base = {'model_type': 'llama', 'num_attention_heads': 4,
            'hidden_size': 32, 'vocab_size': 64, 'num_hidden_layers': 2,
            'intermediate_size': 48}
    cases = [dict(base, rope_scaling={'rope_type': 'yarn', 'factor': 4.0}),
             dict(base, model_type='qwen2', max_position_embeddings=8192,
                  sliding_window=1024, use_sliding_window=True),
             dict(base, model_type='mixtral', num_local_experts=4,
                  num_experts_per_tok=2, max_position_embeddings=8192,
                  sliding_window=1024),
             dict(base, model_type='bert')]
    for hf in cases:
        with pytest.raises(ValueError) as ref_err:
            ref_iw.config_from_hf(hf)
        with pytest.raises(ValueError) as our_err:
            import_weights.config_from_hf(hf)
        assert str(our_err.value) == str(ref_err.value)
    # Inert windows import.
    import_weights.config_from_hf(dict(cases[1], use_sliding_window=False))
    # A width the tensors do not have: a bad shape; a dropped tensor: a
    # missing one (KeyError, as the reference).
    src, _ = _save_hf('llama', tmp_path)
    good = open(f'{src}/config.json').read()
    bad = json.loads(good)
    bad['intermediate_size'] = 100
    open(f'{src}/config.json', 'w').write(json.dumps(bad))
    for loader in (ref_iw.load_params, import_weights.load_params):
        with pytest.raises(ValueError, match='shape'):
            loader(src)
    open(f'{src}/config.json', 'w').write(good)
    from safetensors.torch import load_file, save_file
    state = load_file(f'{src}/model.safetensors')
    del state['model.layers.1.mlp.up_proj.weight']
    save_file(state, f'{src}/model.safetensors')
    for loader in (ref_iw.load_params, import_weights.load_params):
        with pytest.raises(KeyError, match='up_proj'):
            loader(src)


@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
def test_convert_streams_the_loaded_tree(tmp_path, dtype):
    """convert writes step 0 leaf by leaf; it restores bit-equal to
    load_params, with the tokenizer files beside it and a
    model_config.json that the reference reads as its own config."""
    src, _ = _save_hf('qwen2', tmp_path)
    (tmp_path / 'hf' / 'tokenizer.model').write_bytes(b'')
    out = str(tmp_path / 'out')
    cfg = import_weights.convert(src, out, dtype=dtype)
    assert checkpoints.latest_step(out) == 0
    restored = checkpoints.restore_params(out, device='cpu')
    loaded, _ = import_weights.load_params(src, dtype=dtype)
    _same_tree(restored, loaded)
    assert (tmp_path / 'out' / 'tokenizer.model').exists()
    assert import_weights.load_model_config(out) == cfg
    ref_cfg = ref_iw.load_model_config(out)
    assert ref_cfg.to_json_dict() == cfg.to_json_dict()
    # Converting again replaces step 0 in place.
    import_weights.convert(src, out, dtype=dtype)
    assert checkpoints.latest_step(out) == 0
    assert sorted(p.name for p in (tmp_path / 'out').iterdir()) == [
        '0', 'model_config.json', 'tokenizer.model']


def test_model_config_json_across_packages(tmp_path):
    """model_config.json written by either package reads back equal in
    the other (every preset, and a scaled-RoPE config)."""
    names = sorted(configs.PRESETS)
    for name in names:
        for scaled in (False, True):
            kw = (dict(rope_scaling_type='llama3', rope_scaling_factor=8.0,
                       rope_original_max_len=16) if scaled else {})
            ours = configs.get_config(name, **kw)
            ref = jax_configs.get_config(name, **kw)
            d = tmp_path / f'{name}-{scaled}'
            d.mkdir()
            (d / 'model_config.json').write_text(
                json.dumps(ours.to_json_dict()))
            assert ref_iw.load_model_config(str(d)) == ref
            (d / 'model_config.json').write_text(
                json.dumps(ref.to_json_dict()))
            assert import_weights.load_model_config(str(d)) == ours
    assert import_weights.load_model_config(str(tmp_path)) is None


# ---------------------------------------------- long-context RoPE parity


SCALINGS = {
    'llama3': dict(rope_scaling_type='llama3', rope_scaling_factor=8.0,
                   rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
                   rope_original_max_len=16),
    'llama3.1-8b': dict(rope_theta=500000.0, rope_scaling_type='llama3',
                        rope_scaling_factor=8.0, rope_low_freq_factor=1.0,
                        rope_high_freq_factor=4.0,
                        rope_original_max_len=8192),
    'linear': dict(rope_scaling_type='linear', rope_scaling_factor=4.0),
}


@pytest.mark.parametrize('scaling', sorted(SCALINGS))
def test_rope_scaling_matches_reference(scaling):
    """`_rope_freqs` equal to the reference's for d 16 (tiny) and 128
    (Llama-3.1-8B's head), then tiny prefill logits within the A2
    tolerance with the scaling on."""
    kw = SCALINGS[scaling]
    for d in (16, 128):
        ours = transformer._rope_freqs(d, configs.get_config('tiny', **kw))  # pylint: disable=protected-access
        ref = np.asarray(jax_transformer._rope_freqs(  # pylint: disable=protected-access
            d, jax_configs.get_config('tiny', **kw)))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=0)
    jcfg = jax_configs.get_config('tiny', **kw)
    params = nn.meta.unbox(jax_transformer.Transformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    tcfg = configs.get_config('tiny', **kw)
    model = convert.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device='cpu')
    toks = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(
        np.int32)
    jl, _ = jax_decode.prefill(jcfg, params, jnp.asarray(toks), max_len=64)
    tl, _ = decode.prefill(tcfg, model, torch.tensor(toks), max_len=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    full = model(torch.tensor(toks)).detach().numpy()
    ref_full = jax_transformer.Transformer(jcfg).apply(
        {'params': params}, jnp.asarray(toks))
    np.testing.assert_allclose(full, np.asarray(ref_full), atol=ATOL,
                               rtol=RTOL)
