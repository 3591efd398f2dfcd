"""The port's tokenizers against the reference's (models/tokenizer.py),
on the CPU.

SentencePiece models are serialized by hand in tmp_path (the wire
format sentencepiece writes): unigram Viterbi, merge-rank BPE, byte
fallback and control pieces that never match input text.  HF
tokenizer.json files are trained in-test with the `tokenizers` library
(skipped without it).  Every case holds the port's ids, text, bos/eos
and stop sets equal to the reference's on the same files, and
`load_tokenizer` to the same choice, including its fallback when
`tokenizers` cannot be imported (the card has no `tokenizers`).
"""
from __future__ import annotations

import builtins
import json
import struct

import pytest

from skypilot_tpu.models import tokenizer as ref_lib
from skypilot_tpu_torch.models import tokenizer as tok_lib

TEXTS = ['hello world', 'the quick fox', 'hellohello', 'quick quick',
         'hello 東京 🚀', '</s> <s> <unk>', '', '  two  spaces ']


def _varint(n: int) -> bytes:
    out = b''
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _sp_piece(text: str, score: float, ptype: int = 1) -> bytes:
    body = (bytes([0x0A]) + _varint(len(text.encode())) + text.encode() +
            bytes([0x15]) + struct.pack('<f', score))
    if ptype != 1:
        body += bytes([0x18]) + _varint(ptype)
    return bytes([0x0A]) + _varint(len(body)) + body


def _sp_model(tmp_path, model_type: int) -> str:
    """<unk>, <s>, </s>, word and character pieces, a user-defined
    piece, an unknown field the parser must skip, the 256 byte pieces."""
    pieces = [_sp_piece('<unk>', 0.0, 2), _sp_piece('<s>', 0.0, 3),
              _sp_piece('</s>', 0.0, 3), _sp_piece('<sep>', 0.0, 4)]
    vocab = ['▁hello', '▁world', '▁the', '▁quick', 'ing', '▁fox',
             'hel', 'lo', 'he', 'll', 'qu', 'ick', '▁', 'h', 'e', 'l',
             'o', 'w', 'r', 'd', 't', 'q', 'u', 'i', 'c', 'k', 'n', 'g',
             'f', 'x', 's', 'p', 'a']
    for rank, piece in enumerate(vocab):
        pieces.append(_sp_piece(piece, -float(rank) / 4.0 - 1.0))
    for b in range(256):
        pieces.append(_sp_piece(f'<0x{b:02X}>', -100.0, 6))
    trainer = (bytes([0x18]) + _varint(model_type) +
               bytes([0x20]) + _varint(300))          # field 4: skipped
    blob = (b''.join(pieces) + bytes([0x12]) + _varint(len(trainer)) +
            trainer + bytes([0x1A]) + _varint(3) + b'abc')  # unknown field 3
    path = tmp_path / 'tokenizer.model'
    path.write_bytes(blob)
    return str(path)


def _same(ours, ref, texts=TEXTS):
    assert type(ours).__name__ == type(ref).__name__
    assert (ours.bos_id, ours.eos_id, ours.vocab_size, ours.eos_ids) == (
        ref.bos_id, ref.eos_id, ref.vocab_size, ref.eos_ids)
    for text in texts:
        for add_bos in (False, True):
            ids = ours.encode(text, add_bos=add_bos)
            assert ids == ref.encode(text, add_bos=add_bos), text
        assert ours.decode(ids) == ref.decode(ids), text
        # Streamed text equals the reference's stream, delta by delta.
        a, b = tok_lib.StreamDecoder(ours), ref_lib.StreamDecoder(ref)
        assert [a.push(i) for i in ids] == [b.push(i) for i in ids]
        assert a.finish() == b.finish()


@pytest.mark.parametrize('model_type', [1, 2], ids=['unigram', 'bpe'])
def test_sentencepiece_matches_reference(tmp_path, model_type):
    path = _sp_model(tmp_path, model_type)
    ours = tok_lib.SentencePieceTokenizer(path)
    ref = ref_lib.SentencePieceTokenizer(path)
    assert ours._pieces == ref._pieces  # pylint: disable=protected-access
    _same(ours, ref)
    assert (ours.bos_id, ours.eos_id, ours.unk_id) == (1, 2, 0)
    # Control pieces are never matched against text (no EOS injection).
    assert ours.eos_id not in ours.encode('</s>')
    # 東 is not a piece: three byte-fallback ids, decoded back.
    ids = ours.encode('hello 東')
    assert ours.decode(ids) == 'hello 東'
    assert sum(ours._pieces[i][2] == tok_lib._SP_BYTE  # pylint: disable=protected-access
               for i in ids) == 3


def test_sentencepiece_parser_matches_reference(tmp_path):
    data = open(_sp_model(tmp_path, 2), 'rb').read()
    assert (tok_lib._parse_sp_model(data) ==  # pylint: disable=protected-access
            ref_lib._parse_sp_model(data))  # pylint: disable=protected-access
    with pytest.raises(ValueError, match='wire type'):
        tok_lib._skip_field(b'', 0, 3)  # pylint: disable=protected-access


def _bpe_json(tmp_path, specials, config):
    tokenizers = pytest.importorskip('tokenizers')
    from tokenizers import decoders, models, pre_tokenizers, trainers
    tk = tokenizers.Tokenizer(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.train_from_iterator(
        ['the quick brown fox jumps over the lazy dog',
         'hello world, hello gpu serving'] * 50,
        trainers.BpeTrainer(
            vocab_size=400, special_tokens=specials,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tk.save(str(tmp_path / 'tokenizer.json'))
    if config is not None:
        (tmp_path / 'tokenizer_config.json').write_text(json.dumps(config))
    return str(tmp_path)


@pytest.mark.parametrize('specials,config', [
    (['<|begin|>', '<|end|>'],
     {'bos_token': '<|begin|>', 'eos_token': {'content': '<|end|>'}}),
    (['<|begin|>', '<|end|>'], None),
    (['<|begin_of_text|>', '<|end_of_text|>', '<|eot_id|>', '<|im_end|>'],
     None),
    (['<|begin_of_text|>', '<|end_of_text|>', '<|eot_id|>', '<|im_end|>'],
     {'eos_token': '<|end_of_text|>'}),
], ids=['config', 'eos-from-vocab', 'chat-markers', 'config-and-markers'])
def test_hf_tokenizer_matches_reference(tmp_path, specials, config):
    d = _bpe_json(tmp_path, specials, config)
    ours = tok_lib.load_tokenizer(d)
    ref = ref_lib.load_tokenizer(d)
    assert isinstance(ours, tok_lib.HFTokenizer)
    _same(ours, ref, TEXTS + ['<|end|> héllo wörld ünïcode 東京'])
    assert ours.eos_id is not None
    assert (ours.eos_token, ours.bos_token, ours.extra_stop_ids) == (
        ref.eos_token, ref.bos_token, ref.extra_stop_ids)


def _without_tokenizers(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name == 'tokenizers' or name.startswith('tokenizers.'):
            raise ImportError(f'No module named {name!r}')
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, '__import__', fake)


@pytest.mark.parametrize('files,importable', [
    ((), True), (('model',), True), (('json',), True),
    (('json', 'model'), True), (('json', 'model'), False),
    (('json',), False)],
    ids=['empty', 'sp', 'hf', 'both', 'both-no-lib', 'hf-no-lib'])
def test_load_tokenizer_choice_matches_reference(tmp_path, monkeypatch,
                                                 files, importable):
    """Directory lookup: tokenizer.json (HF), else tokenizer.model, else
    bytes; tokenizer.json without the library warns and falls through.
    An explicit file path picks by its name."""
    if 'json' in files:
        _bpe_json(tmp_path, ['<s>', '</s>'], {'eos_token': '</s>'})
    if 'model' in files:
        _sp_model(tmp_path, 1)
    if not importable:
        _without_tokenizers(monkeypatch)
    ours = tok_lib.load_tokenizer(str(tmp_path))
    ref = ref_lib.load_tokenizer(str(tmp_path))
    _same(ours, ref, TEXTS[:3])
    if 'model' in files:
        path = str(tmp_path / 'tokenizer.model')
        _same(tok_lib.load_tokenizer(path), ref_lib.load_tokenizer(path),
              TEXTS[:3])
    if 'json' in files and importable:
        path = str(tmp_path / 'tokenizer.json')
        _same(tok_lib.load_tokenizer(path), ref_lib.load_tokenizer(path),
              TEXTS[:3])
    if 'json' in files and not importable:
        with pytest.raises(ImportError):
            tok_lib.load_tokenizer(str(tmp_path / 'tokenizer.json'))
    assert isinstance(tok_lib.load_tokenizer(None), tok_lib.ByteTokenizer)
