"""Import released checkpoints (HF safetensors) into the port (mirrors
`skypilot_tpu/models/import_weights.py`).

Maps HuggingFace-format safetensors (Llama / Gemma / Qwen2 / Mixtral
families) onto the reference's parameter tree (the layout
models/convert.py bridges) and writes the port's own checkpoint
(data/checkpoints.py) that `ModelServer(..., checkpoint_dir=...)` and
`POST /weights_swap` restore.

- Safetensors are read over mmap by the port's own reader
  (utils/safetensors_io.py): BF16 as raw uint16 bits, viewed as
  torch.bfloat16 (no ml_dtypes, no safetensors package).  The name
  transforms (transposes, the RoPE row permutation, expert stacks) only
  move values, so they run on those raw bits.
- RoPE convention conversion happens once, here: HF stores q/k rows
  for the rotate-half layout, the port's `_rope` pairs interleaved
  lanes, so the q/k output rows are permuted at import.
- Per-layer tensors land in one [n_layers, ...] leaf per parameter (the
  reference's scan layout).  `convert` streams each stacked leaf into
  the checkpoint layer by layer, so host memory holds about one
  layer's tensor at a time.
- `convert` runs on the host and touches no device.

CLI:
    python -m skypilot_tpu_torch.models.import_weights \
        --src /path/to/hf_checkpoint --out /path/to/checkpoint \
        [--dtype bfloat16]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert as convert_lib
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.utils import safetensors_io

logger = logging.getLogger(__name__)

MODEL_CONFIG_FILENAME = 'model_config.json'

# Tokenizer files copied next to the converted checkpoint so a server
# points at one directory.
_TOKENIZER_FILES = ('tokenizer.json', 'tokenizer_config.json',
                    'tokenizer.model', 'special_tokens_map.json')

SafetensorsFile = safetensors_io.SafetensorsFile


class CheckpointReader:
    """Uniform reader over a single model.safetensors or a sharded
    model.safetensors.index.json checkpoint directory."""

    def __init__(self, src_dir: str) -> None:
        self.src_dir = src_dir
        self._files: Dict[str, SafetensorsFile] = {}
        self._where: Dict[str, str] = {}
        index = os.path.join(src_dir, 'model.safetensors.index.json')
        if os.path.exists(index):
            with open(index, encoding='utf-8') as f:
                self._where = json.load(f)['weight_map']
        else:
            single = [f for f in sorted(os.listdir(src_dir))
                      if f.endswith('.safetensors')]
            if not single:
                raise FileNotFoundError(
                    f'No .safetensors files under {src_dir}')
            for fname in single:
                for key in self._file(fname).keys():
                    self._where[key] = fname

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(
                os.path.join(self.src_dir, fname))
        return self._files[fname]

    def keys(self) -> List[str]:
        return list(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def _locate(self, name: str) -> SafetensorsFile:
        if name not in self._where:
            raise KeyError(
                f'{name} not in checkpoint (have e.g. '
                f'{sorted(self._where)[:5]}...)')
        return self._file(self._where[name])

    def get(self, name: str) -> np.ndarray:
        """The tensor's raw values (BF16 as uint16 bits), a view."""
        return self._locate(name).get(name)

    def dtype(self, name: str) -> str:
        return self._locate(name).dtype(name)

    def close(self) -> None:
        for f in self._files.values():
            f.close()


# --------------------------------------------------------------------------
# HF config.json -> ModelConfig
# --------------------------------------------------------------------------

_FAMILIES = ('llama', 'qwen2', 'gemma', 'mixtral')


def config_from_hf(hf: Dict[str, Any]) -> Tuple[configs.ModelConfig, str]:
    """(ModelConfig, family) from an HF config.json dict."""
    family = hf.get('model_type', 'llama')
    if family not in _FAMILIES:
        raise ValueError(
            f'Unsupported model_type {family!r}; have {_FAMILIES}')
    n_heads = hf['num_attention_heads']
    d_model = hf['hidden_size']
    head_dim = hf.get('head_dim') or d_model // n_heads
    common = dict(
        vocab_size=hf['vocab_size'],
        d_model=d_model,
        n_layers=hf['num_hidden_layers'],
        n_heads=n_heads,
        n_kv_heads=hf.get('num_key_value_heads', n_heads),
        d_ff=hf['intermediate_size'],
        max_seq_len=hf.get('max_position_embeddings', 8192),
        rope_theta=float(hf.get('rope_theta', 10000.0)),
        norm_eps=float(hf.get('rms_norm_eps', 1e-5)),
        head_dim_override=(head_dim
                           if head_dim != d_model // n_heads else None),
        dtype=torch.bfloat16,
        param_dtype=torch.float32,
        tie_embeddings=bool(hf.get('tie_word_embeddings', False)),
    )
    # rope_scaling (Llama-3.1+, long-context Qwen2): importing with plain
    # RoPE would silently diverge from the source, so the supported
    # schemes are mapped and the rest rejected.
    rs = hf.get('rope_scaling') or None
    if rs:
        rtype = rs.get('rope_type') or rs.get('type')
        if rtype in (None, 'default'):
            pass
        elif rtype == 'llama3':
            common.update(
                rope_scaling_type='llama3',
                rope_scaling_factor=float(rs['factor']),
                rope_low_freq_factor=float(rs.get('low_freq_factor', 1.0)),
                rope_high_freq_factor=float(
                    rs.get('high_freq_factor', 4.0)),
                rope_original_max_len=int(
                    rs.get('original_max_position_embeddings', 8192)),
            )
        elif rtype == 'linear':
            common.update(rope_scaling_type='linear',
                          rope_scaling_factor=float(rs['factor']))
        else:
            raise ValueError(
                f'Unsupported rope_scaling type {rtype!r} (have '
                "'llama3', 'linear'); importing with plain RoPE would "
                'silently diverge from the source model.')
    # Sliding-window attention is not implemented; reject it only when
    # it would truncate attention inside the usable context (configs
    # often carry an inert window >= max_position_embeddings).
    window = hf.get('sliding_window')
    window_active = (window is not None and
                     int(window) < int(common['max_seq_len']))
    if family == 'qwen2':
        window_active = window_active and bool(
            hf.get('use_sliding_window', False))
    if window_active:
        raise ValueError(
            f'{family} checkpoint uses sliding-window attention '
            f'(window={window} < context={common["max_seq_len"]}), '
            'which this importer does not implement; importing would '
            'silently change attention semantics.')
    if family == 'qwen2':
        common['qkv_bias'] = True
    elif family == 'gemma':
        # HF GemmaRMSNorm computes x * (1 + w) (scale_plus_one), and
        # hidden_activation is the tanh-approximated gelu.
        common.update(tie_embeddings=True, mlp_act='gelu',
                      norm_scale_plus_one=True, scale_embeddings=True)
    elif family == 'mixtral':
        common.update(
            n_experts=hf['num_local_experts'],
            expert_top_k=hf['num_experts_per_tok'],
            router_aux_loss_coef=float(
                hf.get('router_aux_loss_coef', 0.02)),
        )
    return configs.ModelConfig(**common), family


# --------------------------------------------------------------------------
# Name mapping + tensor transforms
# --------------------------------------------------------------------------


def _unpermute_rope(w: np.ndarray, heads: int, head_dim: int) -> np.ndarray:
    """HF rotate-half q/k rows -> interleaved even/odd rows.

    HF pairs output row j with j + head_dim/2 (rotate_half); `_rope`
    pairs 2j with 2j+1.  Both use freq_j = theta^(-2j/head_dim), so the
    conversion is a per-head row permutation of the projection:
        ours[2j] = hf[j];  ours[2j+1] = hf[j + head_dim/2].
    `w` arrives as [..., heads*head_dim] (last axis = output rows).
    """
    shape = w.shape
    w = w.reshape(shape[:-1] + (heads, head_dim))
    out = np.empty_like(w)
    half = head_dim // 2
    out[..., 0::2] = w[..., :half]
    out[..., 1::2] = w[..., half:]
    return out.reshape(shape)


_SAME_SIZE_INT = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear stores [out, in]; the tree's kernels are [in, out].
    The raw bits are transposed by torch's blocked, multithreaded copy
    (numpy's strided one takes ~6x longer on the 8B lm_head)."""
    raw = np.array(w).view(_SAME_SIZE_INT[w.dtype.itemsize])
    return torch.from_numpy(raw).t().contiguous().numpy().view(w.dtype)


def _plan_for(cfg: configs.ModelConfig, family: str):
    """Mapping plan: tree path -> (HF name template, transform).

    Paths are tuples under the unstacked per-layer tree; '{i}' in the
    HF name is the layer index ('{e}' the expert).  Transforms take the
    raw HF tensor and return the per-layer array.
    """
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model

    def qk_kernel(heads: int) -> Callable[[np.ndarray], np.ndarray]:
        def f(w):  # [heads*hd, d] -> [d, heads, hd], rope-converted
            return _unpermute_rope(_t(w), heads, hd).reshape(d, heads, hd)
        return f

    def qk_bias(heads: int) -> Callable[[np.ndarray], np.ndarray]:
        def f(b):  # [heads*hd] -> [heads, hd], rope-converted
            return _unpermute_rope(b, heads, hd).reshape(heads, hd)
        return f

    plan: Dict[Tuple[str, ...], Tuple[str, Callable]] = {
        ('embed', 'embedding'):
            ('model.embed_tokens.weight', lambda w: w),
        ('final_norm', 'scale'): ('model.norm.weight', lambda w: w),
        ('attn', 'q_proj', 'kernel'):
            ('model.layers.{i}.self_attn.q_proj.weight', qk_kernel(nh)),
        ('attn', 'k_proj', 'kernel'):
            ('model.layers.{i}.self_attn.k_proj.weight', qk_kernel(nkv)),
        ('attn', 'v_proj', 'kernel'):
            ('model.layers.{i}.self_attn.v_proj.weight',
             lambda w: _t(w).reshape(d, nkv, hd)),
        ('attn', 'o_proj', 'kernel'):
            ('model.layers.{i}.self_attn.o_proj.weight',
             lambda w: _t(w).reshape(nh, hd, d)),
        ('attn_norm', 'scale'):
            ('model.layers.{i}.input_layernorm.weight', lambda w: w),
        ('mlp_norm', 'scale'):
            ('model.layers.{i}.post_attention_layernorm.weight',
             lambda w: w),
    }
    if not cfg.tie_embeddings:
        plan[('lm_head', 'kernel')] = ('lm_head.weight', _t)
    if cfg.qkv_bias:
        plan[('attn', 'q_proj', 'bias')] = (
            'model.layers.{i}.self_attn.q_proj.bias', qk_bias(nh))
        plan[('attn', 'k_proj', 'bias')] = (
            'model.layers.{i}.self_attn.k_proj.bias', qk_bias(nkv))
        plan[('attn', 'v_proj', 'bias')] = (
            'model.layers.{i}.self_attn.v_proj.bias',
            lambda b: b.reshape(nkv, hd))
    if cfg.n_experts > 0:
        # Mixtral experts: w1 = gate, w3 = up, w2 = down; the tree's are
        # stacked [n_experts, in, out].
        plan[('moe_mlp', 'router', 'kernel')] = (
            'model.layers.{i}.block_sparse_moe.gate.weight', _t)
        for ours, theirs in (('gate_proj', 'w1'), ('up_proj', 'w3'),
                             ('down_proj', 'w2')):
            plan[('moe_mlp', ours)] = (
                'model.layers.{i}.block_sparse_moe.experts.{e}.'
                f'{theirs}.weight', _t)
    else:
        for name in ('gate_proj', 'up_proj', 'down_proj'):
            plan[('mlp', name, 'kernel')] = (
                f'model.layers.{{i}}.mlp.{name}.weight', _t)
    del family
    return plan


def expected_tree(cfg: configs.ModelConfig) -> Dict[str, Any]:
    """Shape skeleton (tuples) of the reference tree for `cfg`, in its
    layer layout: the port's own Transformer built on the meta device
    (nothing is allocated), MoE layers and their expert stacks
    included."""
    model = Transformer(cfg, device='meta')
    tree = convert_lib._map_tree(  # pylint: disable=protected-access
        lambda t: tuple(t.shape), convert_lib.param_tree(model))
    layers = [tree.pop(f'layer_{i}') for i in range(cfg.n_layers)]
    if cfg.scan_layers:
        tree['layers'] = {'layer': convert_lib._map_tree(  # pylint: disable=protected-access
            lambda s: (cfg.n_layers,) + s, layers[0])}
    else:
        tree.update({f'layer_{i}': lt for i, lt in enumerate(layers)})
    return tree


def _resolve_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name not in configs._NAME_DTYPES:  # pylint: disable=protected-access
        raise ValueError(f'Unsupported dtype {dtype!r}; have '
                         f'{sorted(configs._NAME_DTYPES)}')  # pylint: disable=protected-access
    return configs._NAME_DTYPES[name]  # pylint: disable=protected-access


def _read_config(src_dir: str) -> Tuple[configs.ModelConfig, str]:
    with open(os.path.join(src_dir, 'config.json'),
              encoding='utf-8') as f:
        return config_from_hf(json.load(f))


def _leaf_plan(reader: CheckpointReader, cfg: configs.ModelConfig,
               family: str, dtype: torch.dtype):
    """[(tree path, shape, slabs)] in sorted plan order: `slabs()`
    yields the leaf's values in `dtype` (a stacked leaf layer by layer,
    each shape-checked) from the mmap."""
    expect = expected_tree(cfg)

    def expect_at(path: Tuple[str, ...]):
        node: Any = expect
        for key in path:
            node = node[key]
        return node

    def as_torch(arr: np.ndarray, name: str) -> torch.Tensor:
        return safetensors_io.to_torch(arr, reader.dtype(name)).to(dtype)

    def single(name: str, transform, want) -> Iterator[torch.Tensor]:
        if (cfg.tie_embeddings is False and name == 'lm_head.weight' and
                name not in reader):
            # Some checkpoints tie in storage even when the config says
            # untied: fall back to the embedding, transposed.
            name = 'model.embed_tokens.weight'
            arr = _t(reader.get(name))
        else:
            arr = transform(reader.get(name))
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f'{name}: shape {tuple(arr.shape)} != '
                             f'expected {tuple(want)}')
        yield as_torch(arr, name)

    def stacked(template: str, transform, want) -> Iterator[torch.Tensor]:
        for i in range(cfg.n_layers):
            if '{e}' in template:
                names = [template.format(i=i, e=e)
                         for e in range(cfg.n_experts)]
                layer = np.stack([transform(reader.get(n)) for n in names])
                name = names[0]
            else:
                name = template.format(i=i)
                layer = transform(reader.get(name))
            if tuple(layer.shape) != tuple(want[1:]):
                raise ValueError(
                    f'{template.format(i=i, e=0)}: shape {layer.shape} '
                    f'!= expected {tuple(want[1:])}')
            yield as_torch(layer, name)[None]

    out = []
    for path, (template, transform) in sorted(_plan_for(cfg, family).items()):
        if '{i}' in template:
            tgt = ('layers', 'layer') + path
            want = expect_at(tgt)
            out.append((tgt, want, lambda t=template, f=transform, w=want:
                        stacked(t, f, w)))
        else:
            want = expect_at(path)
            out.append((path, want, lambda n=template, f=transform, w=want:
                        single(n, f, w)))
    _assert_complete({p: None for p, _, _ in out}, expect)
    return out


def _assert_complete(paths: Dict[Tuple[str, ...], Any], expect: Any,
                     path: Tuple[str, ...] = ()) -> None:
    if isinstance(expect, dict):
        missing = sorted(key for key in expect
                         if not any(p[:len(path) + 1] == path + (key,)
                                    for p in paths))
        if missing:
            raise ValueError(
                f'Converted tree is missing {missing} at '
                f'{"/".join(path) or "<root>"}')
        for key, sub in expect.items():
            _assert_complete(paths, sub, path + (key,))


def load_params(src_dir: str,
                cfg: Optional[configs.ModelConfig] = None,
                dtype: Optional[Any] = None,
                ) -> Tuple[Dict[str, Any], configs.ModelConfig]:
    """Read an HF checkpoint dir into the reference tree of CPU
    tensors.  Returns (params, cfg).  Per-layer tensors are stacked into
    the scan layout [n_layers, ...]; every array is shape-checked against
    `expected_tree`.  `dtype` overrides the stored dtype (e.g.
    'bfloat16' for serving); default cfg.param_dtype (f32)."""
    derived, family = _read_config(src_dir)
    cfg = cfg or derived
    dtype = _resolve_dtype(cfg.param_dtype if dtype is None else dtype)
    reader = CheckpointReader(src_dir)
    params: Dict[str, Any] = {}
    try:
        for path, want, slabs in _leaf_plan(reader, cfg, family, dtype):
            value = torch.empty(want, dtype=dtype)
            row = 0
            for slab in slabs():
                value[row:row + slab.shape[0]] = slab
                row += slab.shape[0]
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = value
    finally:
        reader.close()
    return params, cfg


# --------------------------------------------------------------------------
# Conversion entry point: HF dir -> the port's checkpoint dir
# --------------------------------------------------------------------------


def convert(src_dir: str, out_dir: str,
            dtype: Optional[Any] = None) -> configs.ModelConfig:
    """Convert an HF safetensors checkpoint to the port's checkpoint.

    Output dir contents:
      <out>/0/params.safetensors  step 0 (data/checkpoints.py), what
                                  `restore_params` and the server read
      <out>/model_config.json     the ModelConfig of the converted shapes
      <out>/tokenizer.*           copied from src when present
    Each leaf streams from the source mmap into the step file (a
    stacked leaf layer by layer); nothing touches a device.
    """
    cfg, family = _read_config(src_dir)
    dtype = _resolve_dtype(cfg.param_dtype if dtype is None else dtype)
    os.makedirs(out_dir, exist_ok=True)
    reader = CheckpointReader(src_dir)
    try:
        plan = _leaf_plan(reader, cfg, family, dtype)
        checkpoints.save_leaves(
            out_dir, 0, [(p, dtype, want) for p, want, _ in plan],
            ((p, slabs()) for p, _, slabs in plan), overwrite=True)
        n_params = sum(int(np.prod(want)) for _, want, _ in plan)
    finally:
        reader.close()
    save_model_config(out_dir, cfg)
    copied = []
    for fname in _TOKENIZER_FILES:
        src = os.path.join(src_dir, fname)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, fname))
            copied.append(fname)
    logger.info('Converted %.1fM params from %s -> %s (tokenizer files: %s)',
                n_params / 1e6, src_dir, out_dir, copied or 'none')
    return cfg


def save_model_config(directory: str, cfg: configs.ModelConfig) -> None:
    """Write `cfg` as the directory's model_config.json, which `--model
    auto` reads (the importer's output; the trainer's checkpoint
    directory, so a server reads its training steps)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, MODEL_CONFIG_FILENAME), 'w',
              encoding='utf-8') as f:
        json.dump(cfg.to_json_dict(), f, indent=1)


def load_model_config(directory: str) -> Optional[configs.ModelConfig]:
    """The ModelConfig written next to a converted checkpoint, if any."""
    path = os.path.join(directory, MODEL_CONFIG_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path, encoding='utf-8') as f:
        return configs.config_from_json_dict(json.load(f))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description='Convert an HF safetensors checkpoint '
                    '(Llama/Gemma/Qwen2/Mixtral) to the skypilot_tpu_torch '
                    'checkpoint layout.')
    parser.add_argument('--src', required=True,
                        help='HF checkpoint dir (config.json + '
                             '*.safetensors [+ index]).')
    parser.add_argument('--out', required=True,
                        help='Output checkpoint dir.')
    parser.add_argument('--dtype', default=None,
                        help="Parameter dtype override, e.g. 'bfloat16' "
                             '(serving); default keeps f32.')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = convert(args.src, args.out, dtype=args.dtype)
    print(json.dumps({'out': args.out, 'd_model': cfg.d_model,
                      'n_layers': cfg.n_layers,
                      'vocab_size': cfg.vocab_size}))


if __name__ == '__main__':
    main()
