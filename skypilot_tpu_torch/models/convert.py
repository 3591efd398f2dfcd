"""Bridge between the reference's flax parameter tree and the port.

`from_jax_params` takes the reference tree (numpy arrays, or torch
tensors such as a restored checkpoint's, already on the device) and
returns a `Transformer` on `device`.  It reads every layer layout of
the reference: scan-stacked `params['layers']['layer']` with a leading
[L] axis, stage-split [S, L / S] (parallel/pipeline.py's
`split_stage_params`, merged by `merge_stage_params`), and unstacked
`params['layer_{i}']`.  The kernel layouts are
the flax ones on both sides (q/k/v [d, h, hd], o_proj [h, hd, d], MLP
[d, f] / [f, d], MoE expert stacks [E, d, f] / [E, f, d] and router
[d, E], lm_head [d, V]), so leaves copy across unchanged, cast
to the port's storage dtype (see models/transformer.py: the serving
layout, or cfg.param_dtype when trainable).  A tree whose matmul
kernels are int8 {'qvalue', 'scale'} leaves (models/quantize.py)
becomes a quantized Transformer, its int8 bytes and f32 scales copied
as they are.

`to_jax_params` is the inverse (numpy f32 leaves; int8 leaves byte for
byte), for round trips; `param_tree` is the same tree over the model's
own tensors, copying nothing.

`to_tensor_parallel` cuts the reference tree, or an unsharded
Transformer, into the per-rank shards of a `TensorParallel` over a
mesh's 'tensor' axis (models/tensor_parallel.py): rank t's slice of
each leaf is the one `parallel/sharding.Placement.index` gives its
mesh position under the leaf's logical axes (`leaf_axes`), copied bit
for bit; `tensor_pieces` is the same cut for a restore that reads each
rank's slice straight from the file (data/checkpoints.py), and
`init_tensor_parallel` the same cut of seeded random weights drawn one
leaf at a time (no device holds the whole model).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.models import quantize as quantize_lib
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import QuantDense
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.models.transformer import _initial_value
from skypilot_tpu_torch.models.transformer import _leaves
from skypilot_tpu_torch.models.transformer import _storage
from skypilot_tpu_torch.models.transformer import logical_axes
from skypilot_tpu_torch.parallel import sharding


def _leaf(x: Any, where: str):
    if isinstance(x, dict):
        raise ValueError(f'{where}: expected an array, got keys '
                         f'{sorted(x)}')
    return x if torch.is_tensor(x) else np.asarray(x)


def _layer_trees(tree: Dict[str, Any], cfg: ModelConfig):
    """-> one per-layer subtree per layer, whichever layout `tree` has
    (a stage-split tree [S, L / S, ...] is merged first)."""
    if 'layers' in tree:
        scale = _leaf(tree['layers']['layer']['attn_norm']['scale'],
                      'layers.layer.attn_norm.scale')
        if scale.ndim == 3:
            from skypilot_tpu_torch.parallel import pipeline  # pylint: disable=import-outside-toplevel
            tree = pipeline.merge_stage_params(tree)
        stacked = tree['layers']['layer']

        def index(node, i):
            if isinstance(node, dict):
                return {k: index(v, i) for k, v in node.items()}
            return _leaf(node, 'layers.layer')[i]
        return [index(stacked, i) for i in range(cfg.n_layers)]
    return [tree[f'layer_{i}'] for i in range(cfg.n_layers)]


def _copy(dst: torch.Tensor, src: Any, where: str) -> None:
    arr = _leaf(src, where)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f'{where}: shape {tuple(arr.shape)} != '
                         f'{tuple(dst.shape)}')
    if not torch.is_tensor(arr):
        arr = torch.from_numpy(np.array(arr)).to(dst.dtype)
    dst.copy_(arr)


def _copy_kernel(owner, name: str, kernel: Any, where: str) -> None:
    """A kernel or expert stack into `owner` (a Dense / MoEMLP holding
    float `name`, or a QuantDense / QuantStack holding int8 buffers)."""
    if isinstance(owner, (QuantDense, moe_lib.QuantStack)):
        if not quantize_lib.is_quantized_leaf(kernel):
            raise ValueError(f'{where}: expected an int8 {{qvalue, scale}} '
                             'leaf like the first layer\'s q_proj')
        _copy(owner.qvalue, kernel['qvalue'], f'{where}.qvalue')
        _copy(owner.scale, kernel['scale'], f'{where}.scale')
    else:
        if quantize_lib.is_quantized_leaf(kernel):
            raise ValueError(f'{where}: an int8 leaf in a tree whose first '
                             'q_proj is not quantized')
        _copy(getattr(owner, name), kernel, where)


def _copy_dense(dense, src: Dict[str, Any], where: str) -> None:
    _copy_kernel(dense, 'kernel', src['kernel'], where)
    if dense.bias is not None:
        _copy(dense.bias, src['bias'], f'{where}.bias')


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any],
                    device: Union[str, torch.device] = 'cuda',
                    trainable: bool = False) -> Transformer:
    """The reference tree as a `Transformer` on `device`; `trainable`
    keeps every leaf in cfg.param_dtype with grad (training), else the
    serving layout (models/transformer.py), with int8 kernels when the
    tree has them."""
    dev = resolve_device(device)
    layers = _layer_trees(tree, cfg)
    quantized = bool(layers) and quantize_lib.is_quantized_leaf(
        layers[0]['attn']['q_proj']['kernel'])
    model = Transformer(cfg, device=dev, trainable=trainable,
                        quantized=quantized)
    with torch.no_grad():
        _copy(model.embed.embedding, tree['embed']['embedding'],
              'embed.embedding')
        for i, (layer, lp) in enumerate(zip(model.layers, layers)):
            pre = f'layer {i}'
            _copy(layer.attn_norm.scale, lp['attn_norm']['scale'],
                  f'{pre} attn_norm')
            _copy(layer.mlp_norm.scale, lp['mlp_norm']['scale'],
                  f'{pre} mlp_norm')
            for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
                _copy_dense(getattr(layer.attn, name), lp['attn'][name],
                            f'{pre} {name}')
            if cfg.n_experts > 0:
                moe, src = layer.moe_mlp, lp['moe_mlp']
                _copy(moe.router.kernel, src['router']['kernel'],
                      f'{pre} router')
                for name in moe_lib.STACKS:
                    leaf = getattr(moe, name)
                    _copy_kernel(leaf if isinstance(leaf, moe_lib.QuantStack)
                                 else moe, name, src[name],
                                 f'{pre} moe_mlp.{name}')
            else:
                for name in ('gate_proj', 'up_proj', 'down_proj'):
                    _copy_dense(getattr(layer.mlp, name), lp['mlp'][name],
                                f'{pre} {name}')
        _copy(model.final_norm.scale, tree['final_norm']['scale'],
              'final_norm')
        if model.lm_head is not None:
            _copy_dense(model.lm_head, tree['lm_head'], 'lm_head')
    return model.eval()


def _dense_tree(dense) -> Dict[str, Any]:
    if isinstance(dense, QuantDense):
        node = {'kernel': {'qvalue': dense.qvalue, 'scale': dense.scale}}
    else:
        node = {'kernel': dense.kernel}
    if dense.bias is not None:
        node['bias'] = dense.bias
    return node


def param_tree(model: Transformer) -> Dict[str, Any]:
    """The reference tree over the model's own tensors, in the unstacked
    layout (`layer_{i}`), copying nothing."""
    tree: Dict[str, Any] = {
        'embed': {'embedding': model.embed.embedding},
        'final_norm': {'scale': model.final_norm.scale},
    }
    if model.lm_head is not None:
        tree['lm_head'] = _dense_tree(model.lm_head)
    for i, layer in enumerate(model.layers):
        node = {
            'attn_norm': {'scale': layer.attn_norm.scale},
            'attn': {name: _dense_tree(getattr(layer.attn, name))
                     for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
            'mlp_norm': {'scale': layer.mlp_norm.scale},
        }
        if model.cfg.n_experts > 0:
            node['moe_mlp'] = layer.moe_mlp.tree()
        else:
            node['mlp'] = {name: _dense_tree(getattr(layer.mlp, name))
                           for name in ('gate_proj', 'up_proj', 'down_proj')}
        tree[f'layer_{i}'] = node
    return tree


def _map_tree(fn, node):
    if isinstance(node, dict):
        return {k: _map_tree(fn, v) for k, v in node.items()}
    return fn(node)


def dequantize_model(model: Transformer) -> Transformer:
    """The float Transformer whose kernels are the values an int8 model
    computes with: every layer kernel dequantized to cfg.dtype (what
    each call dequantizes to), the lm_head to the logits matmul dtype,
    MoE expert stacks to f32 (what `decode._tp_moe_mlp` dequantizes them
    to; stored in cfg.dtype, so with a bf16 config the decode ticks'
    f32 expert products read them rounded); on the model's device.  Its
    GEMMs see the int8 model's operands."""
    cfg = model.cfg
    head = torch.float32 if cfg.logits_in_f32 else cfg.dtype

    def walk(node, path):
        if quantize_lib.is_quantized_leaf(node):
            dtype = (head if path[0] == 'lm_head' else
                     torch.float32 if 'moe_mlp' in path else cfg.dtype)
            return quantize_lib.dequant(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    with torch.no_grad():
        tree = walk(param_tree(model), ())
        return from_jax_params(cfg, tree, device=model.device)


def to_jax_params(model: Transformer) -> Dict[str, Any]:
    """The reference tree (layout per cfg.scan_layers) as numpy: float
    leaves in f32, int8 leaves as their int8 bytes and f32 scales."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().to('cpu')
        if t.dtype != torch.int8:
            t = t.to(torch.float32)
        return t.numpy()

    flat = _map_tree(host, param_tree(model))
    layers = [flat.pop(f'layer_{i}') for i in range(model.cfg.n_layers)]
    if not model.cfg.scan_layers:
        flat.update({f'layer_{i}': lt for i, lt in enumerate(layers)})
        return flat

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return np.stack(nodes)
    flat['layers'] = {'layer': stack(*layers)}
    return flat


def serving_leaf(cfg: ModelConfig, quantize: bool = False
                 ) -> Callable[[Tuple[str, ...], torch.Tensor], Any]:
    """fn(path, tensor) turning one leaf of a checkpoint tree into what
    the serving Transformer stores: with `quantize`, a matmul kernel
    becomes an int8 leaf, quantized from the leaf as stored (before any
    cast, as the reference quantizes its restored tree); every other
    leaf is cast to its storage dtype.  Applied leaf by leaf as a
    restore streams (data/checkpoints.py), so the float tree never
    exists on the device in f32."""
    storage = _storage(cfg, trainable=False)

    def fn(path: Tuple[str, ...], t: torch.Tensor) -> Any:
        if (len(path) >= 2 and path[-1] in ('qvalue', 'scale') and
                path[-2] in ('kernel',) + moe_lib.STACKS):
            return t          # a leaf already quantized
        if quantize:
            q = quantize_lib.quantize_leaf(path, t)
            if q is not t:
                return q
        if path[-1] == 'embedding':
            dtype = storage.embed
        elif path[-1] == 'scale':
            dtype = storage.norm
        elif path[0] == 'lm_head':
            dtype = storage.head
        elif 'router' in path:
            dtype = storage.router
        else:
            dtype = storage.matmul
        return t.to(dtype)

    return fn


# ------------------------------------------------------- tensor shards


def leaf_axes(path: Tuple[str, ...]) -> Tuple[Optional[str], ...]:
    """The logical axes of the reference tree's leaf at `path` (either
    layer layout; a stacked leaf's [L] axis carries none).  A q/k/v
    bias is cut with its kernel's heads, which the rank's narrow
    projection adds it to."""
    if path[-1] == 'bias':
        axes = logical_axes('.'.join(path[:-1] + ('kernel',)))[1:]
    else:
        axes = logical_axes('.'.join(path))
    return ((None,) + axes) if path[0] == 'layers' else axes


def _rank_tree(node: Any, path: Tuple[str, ...], mesh, position: int):
    if isinstance(node, dict):
        if quantize_lib.is_quantized_leaf(node):
            raise ValueError(f'{"/".join(path)}: int8 leaves are not '
                             'tensor-sharded (quantize + tensor sharding '
                             'is not supported)')
        return {k: _rank_tree(v, path + (k,), mesh, position)
                for k, v in node.items()}
    placement = sharding.logical_sharding(mesh, *leaf_axes(path))
    return sharding.shard_of(_leaf(node, '/'.join(path)), placement,
                             position)


def to_tensor_parallel(cfg: ModelConfig, source: Any,
                       mesh) -> tensor_parallel.TensorParallel:
    """The reference tree (numpy or tensors, either layer layout) or an
    unsharded float Transformer as a TensorParallel over `mesh`'s
    'tensor' axis: each rank's slices copied onto its device, bit for
    bit, one rank at a time."""
    tree = param_tree(source) if isinstance(source, Transformer) else source
    devices = tensor_parallel.rank_devices(mesh)
    rcfg = tensor_parallel.rank_config(cfg, len(devices))
    ranks = [from_jax_params(
        rcfg, _rank_tree(tree, (), mesh, mesh.position(tensor=t)),
        device=dev) for t, dev in enumerate(devices)]
    return tensor_parallel.TensorParallel(cfg, ranks, mesh)


def init_tensor_parallel(cfg: ModelConfig, mesh, *, seed: int = 0
                         ) -> tensor_parallel.TensorParallel:
    """Seeded random weights as a TensorParallel over `mesh`'s 'tensor'
    axis, bit-equal to `to_tensor_parallel(cfg, init_params(cfg,
    seed=seed, device=<rank 0's device>), mesh)` without the whole model
    on one device: each leaf is drawn whole on rank 0's device, in
    init_params' order and with its generator, and its rank slices are
    copied into the ranks before the next leaf is drawn."""
    devices = tensor_parallel.rank_devices(mesh)
    rcfg = tensor_parallel.rank_config(cfg, len(devices))
    ranks = [Transformer(rcfg, device=dev) for dev in devices]
    params = [dict(rank.named_parameters()) for rank in ranks]
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, module in _leaves(Transformer(cfg, device='meta')):
            full = _initial_value(name, module, cfg, gen, devices[0])
            # The module name as the unstacked tree's path.
            path = tuple(name.replace('layers.', 'layer_', 1).split('.'))
            placement = sharding.logical_sharding(mesh, *leaf_axes(path))
            for t, rank_params in enumerate(params):
                rank_params[name].copy_(sharding.shard_of(
                    full, placement, mesh.position(tensor=t)))
            del full
    return tensor_parallel.TensorParallel(
        cfg, [rank.eval() for rank in ranks], mesh)


def from_rank_trees(cfg: ModelConfig, trees: List[Dict[str, Any]],
                    mesh) -> tensor_parallel.TensorParallel:
    """Per-rank trees (a `tensor_pieces` restore: rank t's slices,
    already on its device) as a TensorParallel."""
    rcfg = tensor_parallel.rank_config(cfg, len(trees))
    ranks = [from_jax_params(rcfg, tree, device=dev) for tree, dev in
             zip(trees, tensor_parallel.rank_devices(mesh))]
    return tensor_parallel.TensorParallel(cfg, ranks, mesh)


def tensor_pieces(mesh):
    """fn(path, shape) -> [(index, device)] per tensor rank: the slice
    of a stored leaf each rank reads and where it goes
    (`checkpoints.restore_params(pieces=)`)."""
    devices = tensor_parallel.rank_devices(mesh)

    def fn(path: Tuple[str, ...], shape) -> List[Tuple[Any, Any]]:
        placement = sharding.logical_sharding(mesh, *leaf_axes(path))
        return [(placement.index(mesh.position(tensor=t), shape), dev)
                for t, dev in enumerate(devices)]

    return fn


# ------------------------------------------------------- training states


def _flat_port_leaves(cfg: ModelConfig, tree: Dict[str, Any]
                      ) -> Dict[str, np.ndarray]:
    """A reference params-shaped tree (either layer layout) as {port
    tree path joined with '/': f32 numpy leaf}, layers unstacked."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
            else:
                flat['/'.join(prefix + (key,))] = np.asarray(
                    _leaf(value, '/'.join(prefix + (key,))), np.float32)
    for i, layer in enumerate(_layer_trees(tree, cfg)):
        walk(layer, (f'layer_{i}',))
    walk({k: v for k, v in tree.items()
          if k != 'layers' and not k.startswith('layer_')}, ())
    return flat


class _ArrayReader:
    """The part of a safetensors reader that `train.load_train_step`
    reads, over numpy arrays in memory."""

    def __init__(self, arrays: Dict[str, np.ndarray], path: str) -> None:
        self._arrays = arrays
        self.path = path

    def keys(self):
        return list(self._arrays)

    def dtype(self, name: str) -> str:
        del name    # every leaf is f32 (`_flat_port_leaves`)
        return 'F32'

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._arrays[name].shape)

    def get_tensor(self, name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(self._arrays[name]))


def load_reference_train_state(state, params: Dict[str, Any],
                               mu: Dict[str, Any], nu: Dict[str, Any], *,
                               count: int, step: int):
    """Put the reference's TrainState into the port's `state` (sharded
    or not) in place: `params` and the AdamW moments `mu` / `nu` as
    params-shaped trees of numpy arrays (`np.asarray` of the global jax
    arrays, partitioning boxes removed), the optimizer's `count` and
    the TrainState's `step`; through `train.load_train_step`, as a
    saved step is restored.  On a host of a pipeline across hosts only
    the leaves it holds are filled: its stages' layers and the
    embedding, final norm and head."""
    from skypilot_tpu_torch.models import train as train_lib  # pylint: disable=import-outside-toplevel
    cfg = state.model.cfg
    moments = {f'mu/{k}': v for k, v in _flat_port_leaves(cfg, mu).items()}
    moments.update({f'nu/{k}': v
                    for k, v in _flat_port_leaves(cfg, nu).items()})
    return train_lib.load_train_step(
        state, _ArrayReader(_flat_port_leaves(cfg, params), 'params'),
        _ArrayReader(moments, 'moments'), count=int(count),
        train_step=int(step))
