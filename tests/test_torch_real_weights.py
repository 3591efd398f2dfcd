"""The real-weights path of the port against the reference, on the CPU:
HF safetensors -> `import_weights.convert` -> checkpoint dir ->
`ModelServer('auto', checkpoint_dir=...)` -> /generate_text ->
POST /weights_swap (data/checkpoints.py, serve/model_server.py).

- Checkpoints: the save/restore round trip is exact (f32, bf16, int8
  leaves), a step appears only whole (written under a temporary name,
  renamed), an orbax step the JAX package wrote is refused with
  `CheckpointFormatError` naming the re-import command (by
  `latest_step`, the server and /weights_swap), and a directory with no
  step warns and serves the seeded random init, as the reference does.
- Servers: one tiny HF Llama with a trained byte-level BPE tokenizer
  (`transformers` and `tokenizers`; skipped without them) converted by
  each package into its own format and served by each package's server
  ('auto', dense continuous batching), with and without
  quantize='int8': equal /generate_text text and tokens, equal SSE
  frames, the same 400 on a tokenizer/vocab mismatch and on a missing
  swap directory.  The converted model_config.json is set to f32
  compute in both directories (bf16 arithmetic is not specified bit
  for bit across frameworks; f32 greedy tokens are held equal
  everywhere else in these tests).  After /weights_swap the port's
  tokens equal a fresh server's on the swapped weights.
"""
from __future__ import annotations

import http.client
import json
import logging
import shutil

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import import_weights as ref_iw
from skypilot_tpu.serve import model_server as ref_server
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import import_weights
from skypilot_tpu_torch.models import quantize
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.serve import model_server


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _equal_trees(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert sorted(fa) == sorted(fb)
    for key, value in fb.items():
        assert fa[key].dtype == value.dtype, key
        assert torch.equal(fa[key], value), key


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'int8'])
def test_save_restore_round_trip_exact(tmp_path, dtype):
    cfg = configs.get_config('tiny-qwen')
    if dtype == 'int8':
        model = init_params(cfg, seed=1, device='cpu', quantize='int8')
    else:
        model = init_params(cfg.replace(dtype=getattr(torch, dtype)),
                            seed=1, device='cpu')
    tree = convert.param_tree(model)
    d = str(tmp_path / 'ckpt')
    assert checkpoints.latest_step(d) is None
    checkpoints.save_params(d, 5, tree)
    checkpoints.save_params(d, 12, tree)
    assert checkpoints.latest_step(d) == 12
    _equal_trees(checkpoints.restore_params(d, device='cpu'), tree)
    _equal_trees(checkpoints.restore_params(d, device='cpu', step=5), tree)
    # Whole steps only: no temporary directory stays behind.
    assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == [
        '12', '5']
    with pytest.raises(ValueError, match='already exists'):
        checkpoints.save_params(d, 12, tree)
    # The restored tree builds the same model.
    again = convert.from_jax_params(
        model.cfg, checkpoints.restore_params(d, device='cpu'),
        device='cpu')
    _equal_trees(convert.param_tree(again), tree)


def test_failed_save_leaves_no_step(tmp_path):
    d = str(tmp_path / 'ckpt')
    tree = {'a': {'kernel': torch.ones(3)}}

    def leaves():
        yield ('a', 'kernel'), torch.ones(2)      # the wrong size
    with pytest.raises(ValueError, match='bytes'):
        checkpoints.save_leaves(d, 0, [(('a', 'kernel'), torch.float32,
                                        (3,))], leaves())
    assert checkpoints.latest_step(d) is None
    assert list((tmp_path / 'ckpt').iterdir()) == []
    checkpoints.save_params(d, 0, tree)
    assert checkpoints.latest_step(d) == 0


@pytest.fixture(scope='module')
def hf_source(tmp_path_factory):
    """A tiny HF Llama (vocab 512) with a byte-level BPE tokenizer.json
    and tokenizer_config.json, as tests/unit/test_serve_real_checkpoint.py
    builds it."""
    transformers = pytest.importorskip('transformers')
    tokenizers = pytest.importorskip('tokenizers')
    from tokenizers import decoders, models, pre_tokenizers, trainers
    root = tmp_path_factory.mktemp('real_weights')
    src = root / 'hf'
    src.mkdir()
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(
        src, safe_serialization=True)
    (src / 'config.json').write_text(json.dumps(cfg.to_dict()))
    tk = tokenizers.Tokenizer(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.train_from_iterator(
        ['the quick brown fox', 'hello gpu world'] * 30,
        trainers.BpeTrainer(
            vocab_size=460, special_tokens=['<s>', '</s>'],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tk.save(str(src / 'tokenizer.json'))
    (src / 'tokenizer_config.json').write_text(json.dumps(
        {'bos_token': '<s>', 'eos_token': '</s>'}))

    def f32(out):
        path = out / 'model_config.json'
        d = json.loads(path.read_text())
        d['dtype'] = 'float32'
        path.write_text(json.dumps(d))

    ours, ref = root / 'port', root / 'reference'
    import_weights.convert(str(src), str(ours))
    ref_iw.convert(str(src), str(ref))
    f32(ours)
    f32(ref)
    return root


def _request(port, path, body=None, method='POST'):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        conn.request(method, path, body=json.dumps(body or {}).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        return resp.status, resp.getheader('Content-Type'), resp.read()
    finally:
        conn.close()


def _sse(raw: bytes):
    return [line[len(b'data: '):].decode()
            for line in raw.split(b'\n') if line.startswith(b'data: ')]


@pytest.fixture(scope='module', params=[None, 'int8'], ids=['f32', 'int8'])
def both_servers(request, hf_source):
    kw = dict(max_len=128, max_batch=2, continuous_batching=True,
              quantize=request.param)
    ref = ref_server.ModelServer(
        'auto', checkpoint_dir=str(hf_source / 'reference'), **kw)
    ours = model_server.ModelServer(
        'auto', checkpoint_dir=str(hf_source / 'port'), device='cpu', **kw)
    ref_port, ref_stop = ref_server.start_background(ref)
    our_port, our_stop = model_server.start_background(ours)
    yield ref_port, our_port, ours, request.param
    our_stop()
    ours.close()
    ref_stop()
    ref.close()


def test_servers_load_the_converted_checkpoint(both_servers, hf_source):
    _, _, ours, quantized = both_servers
    assert ours.cfg == import_weights.load_model_config(
        str(hf_source / 'port'))
    assert ours.cfg.vocab_size == 512 and ours.cfg.dtype == torch.float32
    assert ours.params.quantized == bool(quantized)
    assert type(ours.tokenizer).__name__ == 'HFTokenizer'
    if quantized:
        # int8 on the device, not dequantized once at load.
        q = ours.params.layers[0].mlp.up_proj
        assert q.qvalue.dtype == torch.int8 and not hasattr(q, 'kernel')
    # The served weights are the converted ones (quantized leaf by leaf).
    tree = checkpoints.restore_params(str(hf_source / 'port'),
                                      device='cpu')
    want = quantize.quantize_params(tree) if quantized else tree
    got = convert.to_jax_params(ours.params)
    for key, value in _flat(want):
        node = got
        for k in key:
            node = node[k]
        assert np.asarray(node).tobytes() == value.numpy().tobytes(), key


@pytest.mark.parametrize('body', [
    {'prompt': 'the quick brown', 'max_new_tokens': 8},
    {'prompt': 'hello gpu', 'max_new_tokens': 10, 'stream': True},
    {'prompt': 'héllo wörld 東京', 'max_new_tokens': 6, 'stream': True},
], ids=['text', 'stream', 'stream-utf8'])
def test_generate_text_equals_reference(both_servers, body):
    ref_port, our_port, _, _ = both_servers
    ours = _request(our_port, '/generate_text', body)
    ref = _request(ref_port, '/generate_text', body)
    assert ours[0] == ref[0] == 200
    assert ours[1] == ref[1]
    if body.get('stream'):
        assert _sse(ours[2]) == _sse(ref[2])
        assert _sse(ours[2])[-1] == '[DONE]'
    else:
        a, b = json.loads(ours[2]), json.loads(ref[2])
        for key in ('completion', 'tokens', 'weight_version'):
            assert a[key] == b[key], key
        assert a['tokens'] and all(0 <= t < 512 for t in a['tokens'])
    g = {'prompt_ids': [[5, 300, 7, 450]], 'max_new_tokens': 6}
    assert (json.loads(_request(our_port, '/generate', g)[2])['tokens'] ==
            json.loads(_request(ref_port, '/generate', g)[2])['tokens'])


def test_errors_equal_reference(both_servers, hf_source, tmp_path):
    ref_port, our_port, _, _ = both_servers
    for body in ({'checkpoint_dir': str(tmp_path / 'missing')}, {}):
        ours = _request(our_port, '/weights_swap', body)
        ref = _request(ref_port, '/weights_swap', body)
        assert ours[0] == ref[0] == 400
        assert json.loads(ours[2]) == json.loads(ref[2])
    # A preset whose vocab (256) is smaller than the tokenizer's: 400.
    ref = ref_server.ModelServer(
        'tiny', max_len=64, tokenizer_path=str(hf_source / 'reference'))
    ours = model_server.ModelServer(
        'tiny', max_len=64, tokenizer_path=str(hf_source / 'port'),
        device='cpu')
    servers = [(ref_server, ref), (model_server, ours)]
    try:
        answers = []
        for lib, server in servers:
            port, stop = lib.start_background(server)
            try:
                answers.append(_request(port, '/generate_text',
                                        {'prompt': 'hi', 'max_new_tokens': 2}))
            finally:
                stop()
        assert answers[0][0] == answers[1][0] == 400
        assert (json.loads(answers[0][2]) == json.loads(answers[1][2]))
        assert 'vocab' in json.loads(answers[1][2])['error']
    finally:
        ref.close()
        ours.close()


def test_weights_swap_equals_fresh_server(both_servers, hf_source,
                                         tmp_path):
    """A second set of weights (seed 7) saved as step 4: the swap
    restores it (re-quantized when the server quantizes), bumps
    weight_version, and later tokens equal a fresh server's on it."""
    _, our_port, ours, quantized = both_servers
    cfg = ours.cfg
    other = tmp_path / 'other'
    checkpoints.save_params(str(other), 4, convert.param_tree(
        init_params(cfg, seed=7, device='cpu')))
    shutil.copy(hf_source / 'port' / 'model_config.json', other)
    before = _request(our_port, '/health', method='GET')
    version = json.loads(before[2])['weight_version']
    code, _, raw = _request(our_port, '/weights_swap',
                            {'checkpoint_dir': str(other)})
    assert code == 200, raw
    swapped = json.loads(raw)
    assert (swapped['weight_version'], swapped['step']) == (version + 1, 4)
    assert swapped['restore_ms'] >= 0
    assert ours.params.quantized == bool(quantized)
    g = {'prompt_ids': [[5, 300, 7, 450], [9, 8, 400, 6]],
         'max_new_tokens': 6}
    got = json.loads(_request(our_port, '/generate', g)[2])
    assert got['weight_version'] == version + 1
    fresh = model_server.ModelServer(
        'auto', checkpoint_dir=str(other), max_len=128, max_batch=2,
        continuous_batching=True, quantize=quantized, device='cpu')
    port, stop = model_server.start_background(fresh)
    try:
        want = json.loads(_request(port, '/generate', g)[2])
    finally:
        stop()
        fresh.close()
    assert got['tokens'] == want['tokens']
    # The swap families, as the reference names them.
    code, _, raw = _request(our_port, '/metrics', method='GET')
    text = raw.decode()
    assert 'skytpu_batch_weight_swaps_total{status="ok"}' in text
    epoch = [line.split()[1] for line in text.splitlines()
             if line.startswith('skytpu_batch_weight_epoch ')]
    assert [float(e) for e in epoch] == [version + 1]


def test_orbax_step_is_refused(hf_source, tmp_path):
    """The reference's converted dir holds an orbax step: the port
    refuses it, never reading it as "no checkpoint"."""
    orbax_dir = str(hf_source / 'reference')
    with pytest.raises(checkpoints.CheckpointFormatError,
                       match='orbax.*import_weights'):
        checkpoints.latest_step(orbax_dir)
    with pytest.raises(checkpoints.CheckpointFormatError,
                       match='import_weights'):
        model_server.ModelServer('auto', checkpoint_dir=orbax_dir,
                                 device='cpu')
    server = model_server.ModelServer(
        'tiny', max_len=64, continuous_batching=True, device='cpu')
    port, stop = model_server.start_background(server)
    try:
        code, _, raw = _request(port, '/weights_swap',
                                {'checkpoint_dir': orbax_dir})
    finally:
        stop()
        server.close()
    assert code == 400 and 'orbax' in json.loads(raw)['error']


def test_empty_dir_serves_random_init_like_reference(tmp_path, caplog):
    empty = tmp_path / 'empty'
    empty.mkdir()
    with caplog.at_level(logging.WARNING):
        server = model_server.ModelServer('tiny', checkpoint_dir=str(empty),
                                          seed=3, device='cpu')
    assert f'No checkpoint under {empty}' in caplog.text
    _equal_trees(convert.param_tree(server.params),
                 convert.param_tree(init_params(server.cfg, seed=3,
                                                device='cpu')))
    ref = ref_server.ModelServer('tiny', checkpoint_dir=str(empty))
    assert jax.tree_util.tree_structure(ref.params) == (
        jax.tree_util.tree_structure(convert.to_jax_params(server.params)))
    ref.close()
    with pytest.raises(ValueError, match='model auto needs'):
        model_server.ModelServer('auto', checkpoint_dir=str(empty),
                                 device='cpu')
    with pytest.raises(ValueError, match='quantize mode'):
        model_server.ModelServer('tiny', quantize='int4', device='cpu')
