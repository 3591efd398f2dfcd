"""Bridge between the reference's flax parameter tree and the port.

`from_jax_params` takes the reference tree as numpy arrays (the tests
carry reference weights across with it; nothing is downloaded) and
returns a `Transformer` on `device`.  It reads both layer layouts of
the reference: scan-stacked `params['layers']['layer']` with a leading
[L] axis, and unstacked `params['layer_{i}']`.  The kernel layouts are
the flax ones on both sides (q/k/v [d, h, hd], o_proj [h, hd, d], MLP
[d, f] / [f, d], lm_head [d, V]), so leaves copy across unchanged, cast
to the port's storage dtype (see models/transformer.py: the serving
layout, or cfg.param_dtype when trainable).

`to_jax_params` is the inverse (numpy f32 leaves), for round trips.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import Transformer


def _leaf(x: Any, where: str) -> np.ndarray:
    if isinstance(x, dict):
        if 'qvalue' in x:
            raise NotImplementedError(
                f'{where}: int8 weight leaves ({{qvalue, scale}}) come '
                'with weight quantization in a later slice of the port')
        raise ValueError(f'{where}: expected an array, got keys '
                         f'{sorted(x)}')
    return np.asarray(x)


def _layer_trees(tree: Dict[str, Any], cfg: ModelConfig):
    """-> one per-layer subtree per layer, whichever layout `tree` has."""
    if 'layers' in tree:
        stacked = tree['layers']['layer']

        def index(node, i):
            if isinstance(node, dict) and 'qvalue' not in node:
                return {k: index(v, i) for k, v in node.items()}
            return _leaf(node, 'layers.layer')[i]
        return [index(stacked, i) for i in range(cfg.n_layers)]
    return [tree[f'layer_{i}'] for i in range(cfg.n_layers)]


def _copy(dst: torch.Tensor, src: Any, where: str) -> None:
    arr = _leaf(src, where)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f'{where}: shape {tuple(arr.shape)} != '
                         f'{tuple(dst.shape)}')
    dst.copy_(torch.from_numpy(np.array(arr)).to(dst.dtype))


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any],
                    device: Union[str, torch.device] = 'cuda',
                    trainable: bool = False) -> Transformer:
    """The reference tree as a `Transformer` on `device`; `trainable`
    keeps every leaf in cfg.param_dtype with grad (training), else the
    serving layout (models/transformer.py)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, trainable=trainable)
    with torch.no_grad():
        _copy(model.embed.embedding, tree['embed']['embedding'],
              'embed.embedding')
        for i, (layer, lp) in enumerate(zip(model.layers,
                                            _layer_trees(tree, cfg))):
            pre = f'layer {i}'
            _copy(layer.attn_norm.scale, lp['attn_norm']['scale'],
                  f'{pre} attn_norm')
            _copy(layer.mlp_norm.scale, lp['mlp_norm']['scale'],
                  f'{pre} mlp_norm')
            for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
                dense = getattr(layer.attn, name)
                src = lp['attn'][name]
                _copy(dense.kernel, src['kernel'], f'{pre} {name}')
                if dense.bias is not None:
                    _copy(dense.bias, src['bias'], f'{pre} {name}.bias')
            for name in ('gate_proj', 'up_proj', 'down_proj'):
                _copy(getattr(layer.mlp, name).kernel,
                      lp['mlp'][name]['kernel'], f'{pre} {name}')
        _copy(model.final_norm.scale, tree['final_norm']['scale'],
              'final_norm')
        if model.lm_head is not None:
            _copy(model.lm_head.kernel, tree['lm_head']['kernel'],
                  'lm_head')
    return model.eval()


def to_jax_params(model: Transformer) -> Dict[str, Any]:
    """The reference tree (layout per cfg.scan_layers) as numpy f32."""
    cfg = model.cfg

    def np32(t: torch.Tensor) -> np.ndarray:
        return t.detach().to('cpu', torch.float32).numpy()

    def layer_tree(layer) -> Dict[str, Any]:
        attn = {}
        for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
            dense = getattr(layer.attn, name)
            attn[name] = {'kernel': np32(dense.kernel)}
            if dense.bias is not None:
                attn[name]['bias'] = np32(dense.bias)
        return {
            'attn_norm': {'scale': np32(layer.attn_norm.scale)},
            'attn': attn,
            'mlp_norm': {'scale': np32(layer.mlp_norm.scale)},
            'mlp': {name: {'kernel': np32(getattr(layer.mlp, name).kernel)}
                    for name in ('gate_proj', 'up_proj', 'down_proj')},
        }

    tree: Dict[str, Any] = {
        'embed': {'embedding': np32(model.embed.embedding)},
        'final_norm': {'scale': np32(model.final_norm.scale)},
    }
    if model.lm_head is not None:
        tree['lm_head'] = {'kernel': np32(model.lm_head.kernel)}
    layers = [layer_tree(layer) for layer in model.layers]
    if cfg.scan_layers:
        def stack(*nodes):
            if isinstance(nodes[0], dict):
                return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
            return np.stack(nodes)
        tree['layers'] = {'layer': stack(*layers)}
    else:
        for i, lt in enumerate(layers):
            tree[f'layer_{i}'] = lt
    return tree
