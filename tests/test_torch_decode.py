"""The port's decode path against the JAX reference, on the CPU.

Reference weights are carried across with convert.from_jax_params;
token inputs come from numpy with a seed.  Tolerances: logits within
atol 2e-4 / rtol 2e-3 (those of tests/unit/test_import_weights.py; f32
on both sides, summed in different orders), greedy tokens equal, int8
KV pools equal byte for byte, f32 pools within 1e-5.  The JAX paged
path is pinned to its kernel semantics (SKYTPU_DECODE_KERNEL=pallas in
interpret mode), which dequantize int8 pages in f32 like the port.
"""
from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models.transformer import init_params

ATOL, RTOL = 2e-4, 2e-3
PRESETS = ('tiny', 'tiny-gemma', 'tiny-qwen')


@functools.lru_cache(maxsize=None)
def _setup(name: str, scan_layers: bool = True):
    jcfg = jax_configs.get_config(name, scan_layers=scan_layers)
    tcfg = configs.get_config(name, scan_layers=scan_layers)
    params = nn.meta.unbox(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    tree = jax.tree.map(np.asarray, params)
    model = convert.from_jax_params(tcfg, tree, device='cpu')
    return jcfg, params, tcfg, model, tree


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv('SKYTPU_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('SKYTPU_DECODE_KERNEL', 'pallas')


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


# -------------------------------------------------------------- configs


def test_presets_match_reference():
    assert sorted(configs.PRESETS) == sorted(jax_configs.PRESETS)
    for name, cfg in configs.PRESETS.items():
        ref = jax_configs.PRESETS[name]
        mine = cfg.to_json_dict()
        theirs = ref.to_json_dict()
        assert mine == theirs, name
        assert cfg.head_dim == ref.head_dim


@pytest.mark.parametrize('name', sorted(configs.PRESETS))
def test_config_json_round_trip(name):
    cfg = configs.get_config(name)
    assert configs.config_from_json_dict(cfg.to_json_dict()) == cfg
    # The reference reads the port's JSON and vice versa.
    ref = jax_configs.config_from_json_dict(cfg.to_json_dict())
    assert ref.to_json_dict() == cfg.to_json_dict()


def test_config_rejects_unknown_fields():
    with pytest.raises(ValueError, match='Unknown ModelConfig fields'):
        configs.config_from_json_dict({'bogus': 1})
    with pytest.raises(ValueError, match='Unknown model preset'):
        configs.get_config('nope')


# --------------------------------------------------------------- bridge


@pytest.mark.parametrize('scan_layers', [True, False],
                         ids=['scan', 'unstacked'])
@pytest.mark.parametrize('name', PRESETS)
def test_bridge_round_trip_bit_exact(name, scan_layers):
    _, params, _, model, tree = _setup(name, scan_layers)
    if not scan_layers:
        assert 'layer_0' in params
    back = convert.to_jax_params(model)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.asarray(leaf).tobytes() == flat_b[path].tobytes(), path


def test_bridge_rejects_int8_leaves():
    """int8 {qvalue, scale} leaves (the reference's quantize_params)
    cross the bridge byte for byte in both layouts; a stray int8 leaf in
    a float tree, or a float one in an int8 tree, is refused."""
    from skypilot_tpu.models import quantize as jax_quantize
    for scan_layers in (True, False):
        _, params, tcfg, _, tree = _setup('tiny', scan_layers)
        qtree = jax.tree.map(np.asarray,
                             jax_quantize.quantize_params(params))
        model = convert.from_jax_params(tcfg, qtree, device='cpu')
        assert model.quantized
        back = convert.to_jax_params(model)
        flat_a = jax.tree_util.tree_flatten_with_path(qtree)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            assert leaf.dtype == flat_b[path].dtype, path
            assert leaf.tobytes() == flat_b[path].tobytes(), path
        bad = jax.tree.map(lambda x: x, tree)
        bad['lm_head'] = qtree['lm_head']
        with pytest.raises(ValueError, match='int8 leaf'):
            convert.from_jax_params(tcfg, bad, device='cpu')
        bad = jax.tree.map(lambda x: x, qtree)
        bad['lm_head'] = tree['lm_head']
        with pytest.raises(ValueError, match='int8'):
            convert.from_jax_params(tcfg, bad, device='cpu')


def test_init_params_seeded_and_flax_shaped():
    cfg = configs.get_config('tiny-qwen')
    a = init_params(cfg, seed=3, device='cpu')
    again = init_params(cfg, seed=3, device='cpu')
    other = init_params(cfg, seed=4, device='cpu')
    for (name, p), (_, q), (_, r) in zip(a.named_parameters(),
                                         again.named_parameters(),
                                         other.named_parameters()):
        assert torch.equal(p, q), name
        if name.endswith('kernel') or name.endswith('embedding'):
            assert not torch.equal(p, r), name
    _, _, _, _, tree = _setup('tiny-qwen')
    shapes = jax.tree.map(np.shape, convert.to_jax_params(a))
    assert shapes == jax.tree.map(np.shape, tree)
    # lecun-normal: std ~ 1/sqrt(fan_in), truncated at 2 std.
    kernel = a.layers[0].mlp.down_proj.kernel
    std = 1 / np.sqrt(cfg.d_ff) / 0.87962566103423978
    assert abs(kernel.std().item() - 1 / np.sqrt(cfg.d_ff)) < 0.2 * std
    assert kernel.abs().max().item() <= 2 * std + 1e-6
    assert torch.all(a.layers[0].attn_norm.scale == 1)


# -------------------------------------------------------- dense decode


@pytest.mark.parametrize('name', PRESETS)
def test_forward_matches_transformer(name):
    jcfg, params, tcfg, model, _ = _setup(name)
    toks = _tokens(1, (2, 11))
    ref = JaxTransformer(jcfg).apply({'params': params}, jnp.asarray(toks))
    _close(model(torch.tensor(toks)), ref)


@pytest.mark.parametrize('name', PRESETS)
def test_prefill_chunk_decode_step_logits(pallas, name):
    jcfg, params, tcfg, model, _ = _setup(name)
    toks = _tokens(2, (2, 13))
    jl, jc = jax_decode.prefill(jcfg, params, jnp.asarray(toks[:, :8]),
                                max_len=32)
    tl, tc = decode.prefill(tcfg, model, torch.tensor(toks[:, :8]),
                            max_len=32)
    _close(tl, jl)
    _close(tc['k'], jc['k'], atol=1e-5)
    assert tc['index'] == int(jc['index'])
    jl, jc = jax_decode.prefill_chunk(jcfg, params,
                                      jnp.asarray(toks[:, 8:12]), jc)
    tl, tc = decode.prefill_chunk(tcfg, model,
                                  torch.tensor(toks[:, 8:12]), tc)
    _close(tl, jl)
    jl, jc = jax_decode.decode_step(jcfg, params,
                                    jnp.asarray(toks[:, 12:13]), jc)
    tl, tc = decode.decode_step(tcfg, model, torch.tensor(toks[:, 12:13]),
                                tc)
    _close(tl, jl)
    _close(tc['v'], jc['v'], atol=1e-5)
    assert tc['index'] == int(jc['index']) == 13


def test_bf16_chunked_prefill_and_forward_run():
    """bf16 activations through the masked (f32 attention) path and the
    flash path: every layer's attention output joins the bf16 residual
    stream in its dtype."""
    cfg = configs.get_config('tiny', dtype=torch.bfloat16)
    model = init_params(cfg, seed=0, device='cpu')
    toks = torch.tensor(_tokens(4, (2, 12)))
    logits, cache = decode.prefill(cfg, model, toks[:, :8], max_len=16)
    logits2, _ = decode.prefill_chunk(cfg, model, toks[:, 8:], cache)
    full = model(toks)
    for out in (logits, logits2, full):
        assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize('name', PRESETS)
def test_greedy_generate_tokens_equal(name):
    jcfg, params, tcfg, model, _ = _setup(name)
    toks = _tokens(3, (2, 9))
    _, jn = jax_decode.generate(jcfg, params, jnp.asarray(toks),
                                max_new_tokens=10)
    full, tn = decode.generate(tcfg, model, torch.tensor(toks),
                               max_new_tokens=10)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert full.shape == (2, 19)


def test_sampled_generate_seeded():
    _, _, tcfg, model, _ = _setup('tiny')
    prompt = torch.tensor(_tokens(4, (2, 5)))
    sampling = decode.SamplingConfig(temperature=0.9, top_k=20, seed=11)
    _, a = decode.generate(tcfg, model, prompt, max_new_tokens=12,
                           sampling=sampling)
    _, b = decode.generate(tcfg, model, prompt, max_new_tokens=12,
                           sampling=sampling)
    _, c = decode.generate(tcfg, model, prompt, max_new_tokens=12,
                           sampling=decode.SamplingConfig(
                               temperature=0.9, top_k=20, seed=12))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


# ----------------------------------------------------------- paged path


def _paged_pair(jcfg, tcfg, quantize_kv, *, slots=2, n_pages=16, ps=4,
                rows=6):
    jp = jax_decode.init_paged_cache(jcfg, n_pages, ps, slots, rows,
                                     quantize_kv=quantize_kv)
    tp = decode.init_paged_cache(tcfg, n_pages, ps, slots, rows,
                                 quantize_kv=quantize_kv, device='cpu')
    # Slot 0 pages 3,1,7; slot 1 pages 2,5 (rest on the null page);
    # depths 0 and 5.
    table = np.zeros((slots, rows), np.int32)
    table[0, :3] = [3, 1, 7]
    table[1, :2] = [2, 5]
    lengths = np.array([0, 5], np.int32)
    jp = dict(jp, block_tables=jnp.asarray(table),
              lengths=jnp.asarray(lengths))
    tp['block_tables'][:] = torch.tensor(table)
    tp['lengths'][:] = torch.tensor(lengths)
    return jp, tp


def _assert_pools(tp, jp, quantized):
    for name in ('k', 'v'):
        if quantized:
            assert (tp[name]['q'].numpy().tobytes() ==
                    np.asarray(jp[name]['q']).tobytes())
            _close(tp[name]['scale'], jp[name]['scale'], atol=1e-6,
                   rtol=1e-5)
        else:
            _close(tp[name], jp[name], atol=1e-5)
    assert tp['lengths'].tolist() == np.asarray(jp['lengths']).tolist()


@pytest.mark.parametrize('quantized', [False, True],
                         ids=['f32', 'int8'])
@pytest.mark.parametrize('name', PRESETS)
def test_paged_batched_step_ticks(pallas, name, quantized):
    jcfg, params, tcfg, model, _ = _setup(name)
    jp, tp = _paged_pair(jcfg, tcfg, quantized)
    tokens = _tokens(5, (2, 1))
    for _ in range(5):
        jl, jp = jax_decode.paged_batched_step(
            jcfg, params, jnp.asarray(tokens), jp, kernel='pallas')
        tl, tp = decode.paged_batched_step(tcfg, model,
                                           torch.tensor(tokens), tp)
        _close(tl, jl)
        _assert_pools(tp, jp, quantized)
        nxt = np.asarray(jnp.argmax(jl, axis=-1))
        assert tl.argmax(-1).tolist() == nxt.tolist()
        tokens = nxt.astype(np.int32)[:, None]


def _engine_state_pair(slots=2):
    js = jax_decode.init_engine_state(slots, 4)
    ts = decode.init_engine_state(slots, 4, device='cpu')
    for slot, (token, remaining, stop) in enumerate(
            [(7, 6, [-1, -1, -1, -1]), (9, 3, [5, -1, -1, -1])]):
        js = jax_decode.admit_slot_state(js, slot, token, remaining, stop,
                                         jax.random.PRNGKey(slot), 0.0, 0)
        ts = decode.admit_slot_state(ts, slot, token, remaining, stop,
                                     [slot, 0], 0.0, 0)
    return js, ts


@pytest.mark.parametrize('quantized', [False, True],
                         ids=['f32', 'int8'])
def test_paged_engine_step_greedy_state(pallas, quantized):
    jcfg, params, tcfg, model, _ = _setup('tiny')
    jp, tp = _paged_pair(jcfg, tcfg, quantized)
    js, ts = _engine_state_pair()
    for _ in range(5):
        js, jp, jfin = jax_decode.paged_engine_step(jcfg, params, js, jp,
                                                    kernel='pallas')
        ts, tp, tfin = decode.paged_engine_step(tcfg, model, ts, tp)
        for key in ('tokens', 'active', 'remaining'):
            assert ts[key].tolist() == np.asarray(js[key]).tolist(), key
        assert tfin.tolist() == np.asarray(jfin).tolist()
        _assert_pools(tp, jp, quantized)


def test_paged_spec_step_equals_plain_ticks():
    jcfg, _, cfg, model, _ = _setup('tiny')
    # Plain ticks: the reference stream for two slots.
    _, plain_pool = _paged_pair(jcfg, cfg, False)
    _, plain_state = _engine_state_pair()
    stream = [[], []]
    for _ in range(6):
        plain_state, plain_pool, _ = decode.paged_engine_step(
            cfg, model, plain_state, plain_pool)
        for slot in range(2):
            stream[slot].append(int(plain_state['tokens'][slot]))
    # Spec ticks with drafts: slot 0 gets the true continuation (all
    # accepted), slot 1 wrong drafts (only the bonus token lands).
    _, pool = _paged_pair(jcfg, cfg, False)
    _, state = _engine_state_pair()
    k = 3
    drafts = torch.tensor([stream[0][:k], [0, 0, 0]], dtype=torch.int32)
    if stream[1][0] == 0:
        drafts[1] = 1
    state, pool, fin, toks, counts = decode.paged_spec_engine_step(
        cfg, model, state, pool, drafts)
    assert counts.tolist()[0] == k + 1
    assert toks[0, :k + 1].tolist() == stream[0][:k + 1]
    assert counts.tolist()[1] == 1
    assert toks[1, 0].item() == stream[1][0]
    # Slot 1 has max_new 3: after more spec ticks its emission stops at
    # the countdown, exactly where plain ticks stopped.
    emitted1 = [toks[1, 0].item()]
    for _ in range(3):
        drafts = torch.tensor([[0] * k, [0] * k], dtype=torch.int32)
        state, pool, fin, toks, counts = decode.paged_spec_engine_step(
            cfg, model, state, pool, drafts)
        emitted1 += toks[1, :counts[1]].tolist()
    assert emitted1 == stream[1][:3]
    assert not bool(state['active'][1])


def test_spec_step_matches_reference_greedy(pallas):
    jcfg, params, tcfg, model, _ = _setup('tiny')
    jp, tp = _paged_pair(jcfg, tcfg, False)
    js, ts = _engine_state_pair()
    drafts = _tokens(6, (2, 3))
    js, jp, jfin, jtoks, jcounts = jax_decode.paged_spec_engine_step(
        jcfg, params, js, jp, jnp.asarray(drafts), kernel='pallas')
    ts, tp, tfin, ttoks, tcounts = decode.paged_spec_engine_step(
        tcfg, model, ts, tp, torch.tensor(drafts))
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert tfin.tolist() == np.asarray(jfin).tolist()
    for key in ('tokens', 'active', 'remaining'):
        assert ts[key].tolist() == np.asarray(js[key]).tolist(), key
    _assert_pools(tp, jp, False)


@pytest.mark.parametrize('quantized', [False, True],
                         ids=['f32', 'int8'])
def test_insert_and_seed_private_pages(quantized):
    jcfg, params, tcfg, model, _ = _setup('tiny')
    toks = _tokens(7, (1, 8))
    _, jc = jax_decode.prefill(jcfg, params, jnp.asarray(toks), max_len=16)
    _, tc = decode.prefill(tcfg, model, torch.tensor(toks), max_len=16)
    jp, tp = _paged_pair(jcfg, tcfg, quantized)
    jp = jax_decode.insert_prefill_pages(jp, jc, jnp.asarray([4, 6]),
                                         first_page=0)
    decode.insert_prefill_pages(tp, tc, [4, 6], first_page=0)
    _assert_pools(tp, jp, quantized)
    jseed = jax_decode.paged_seed_private(jcfg, jp, jnp.asarray([4, 6]),
                                          priv_len=16)
    tseed = decode.paged_seed_private(tcfg, tp, [4, 6], priv_len=16)
    assert tseed['index'] == int(jseed['index']) == 8
    _close(tseed['k'], jseed['k'], atol=1e-5)
    _close(tseed['v'], jseed['v'], atol=1e-5)


def test_admit_and_release_slot():
    _, _, tcfg, _, _ = _setup('tiny')
    pool = decode.init_paged_cache(tcfg, 8, 4, 2, 3, device='cpu')
    decode.paged_admit_slot(pool, 1, [5, 2, 0], 6)
    assert pool['block_tables'][1].tolist() == [5, 2, 0]
    assert pool['lengths'].tolist() == [0, 6]
    decode.paged_release_slot(pool, 1)
    assert pool['block_tables'][1].tolist() == [0, 0, 0]
    assert pool['lengths'].tolist() == [0, 0]


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_moe_builds_and_runs(quantize):
    """tiny-moe builds from a seed (float and int8 stacks) and decodes on
    the CPU; its parity with the JAX package is tests/test_torch_moe.py's."""
    cfg = configs.get_config('tiny-moe')
    model = init_params(cfg, device='cpu', quantize=quantize)
    moe = model.layers[0].moe_mlp
    assert not hasattr(model.layers[0], 'mlp')
    assert moe.router.kernel.dtype == torch.float32
    for s in (1, 3):
        out = decode._tp_moe_mlp(  # pylint: disable=protected-access
            cfg, [moe], [torch.randn(2, s, cfg.d_model)])
        assert out.shape == (2, s, cfg.d_model)
        assert bool(torch.isfinite(out).all())
    _, new = decode.generate(cfg, model, torch.tensor([[5, 6, 7]]),
                             max_new_tokens=4, max_len=16)
    assert new.shape == (1, 4)
