"""Weight-only int8 quantization (mirrors `skypilot_tpu/models/quantize.py`).

Scheme: symmetric per-output-channel absmax.  For a kernel contracted
over its input axes, scale = absmax(over the contraction axes) / 127
(computed in f32; a zero scale becomes 1) and qvalue = round(w / scale)
(round half to even) clipped to +-127.  Embeddings, norms, biases and
the MoE router stay full precision.  A quantized leaf is the dict
{'qvalue': int8, 'scale': f32}, the reference tree's own form.

`quantize_params` takes the reference-layout tree (models/convert.py)
of numpy arrays or torch tensors, leaf by leaf: a tensor is quantized
where it lies (on the card for a CUDA tensor) and only one leaf's f32
copy exists at a time.  Quantize the tree as loaded (the f32 init or
the checkpoint's leaves), before the serving cast to bf16: a bf16
copy quantizes to other bytes.

`dequant` is the reference's `maybe_dequant`: qvalue * scale in the
compute dtype, one multiply (int8 values are exact in bf16 and the
product of two bf16 values exact in f32, so the result is rounded
once, as XLA's is).  XLA fuses that multiply into the matmul's operand
read; here it writes a dequantized copy that the GEMM then reads
(PERF.md: what that costs a decode tick).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

# Leaf names quantized, mapped to their contraction (input) axes.
# Kernels: q/k/v [d,h,hd] and mlp gate/up [d,f] and lm_head [d,V]
# contract axis 0; o_proj [h,hd,d] contracts (0,1).  MoE expert stacks
# gate/up [e,d,f] / down [e,f,d] contract axis 1 (per-expert).
_CONTRACT_AXES = {
    'q_proj': (0,),
    'k_proj': (0,),
    'v_proj': (0,),
    'o_proj': (0, 1),
    'gate_proj': (0,),
    'up_proj': (0,),
    'down_proj': (0,),
    'lm_head': (0,),
}
_MOE_CONTRACT_AXES = {
    'gate_proj': (1,),
    'up_proj': (1,),
    'down_proj': (1,),
}
_SKIP_NAMES = {'embedding', 'scale', 'bias', 'router'}


def is_quantized_leaf(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {'qvalue', 'scale'}


def _quantize_array(w, contract_axes: Tuple[int, ...]) -> Dict[str, Any]:
    """{'qvalue', 'scale'} of one kernel: numpy in, numpy out (the
    reference's arithmetic); a tensor in, tensors out on its device."""
    if not torch.is_tensor(w):
        w32 = np.asarray(w, np.float32)
        absmax = np.max(np.abs(w32), axis=contract_axes, keepdims=True)
        scale = (absmax / 127.0).astype(np.float32)
        scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
        q = np.clip(np.rint(w32 / scale), -127, 127).astype(np.int8)
        return {'qvalue': q, 'scale': scale}
    with torch.no_grad():
        w32 = w.to(torch.float32)
        absmax = w32.abs().amax(dim=contract_axes, keepdim=True)
        # A tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, one rounding more than numpy's
        # absmax / 127 (and then other int8 bytes than the CPU's).
        scale = absmax / absmax.new_full((), 127.0)
        scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
        # In place on the one f32 temporary: a leaf of the 8B lm_head is
        # 2.1 GB in f32.
        q = torch.div(w32, scale).round_().clamp_(-127, 127)
        return {'qvalue': q.to(torch.int8), 'scale': scale}


def dequant(kernel: Any, dtype: torch.dtype) -> torch.Tensor:
    """The reference's maybe_dequant for tensors: a quantized leaf as
    qvalue * scale in `dtype`; a float tensor cast to `dtype`."""
    if is_quantized_leaf(kernel):
        return kernel['qvalue'] * kernel['scale'].to(dtype)
    return kernel.to(dtype)


def quantize_leaf(path: Tuple[str, ...], node: Any) -> Any:
    """The leaf at `path` of a reference tree, quantized when its name
    says it is a matmul kernel (else returned as it is).  Scan-stacked
    leaves carry a leading [L] (and MoE a leading [E]) axis beyond the
    per-layer kernel rank; the contraction axes shift right by the
    difference."""
    name = path[-1] if path else ''
    parent = path[-2] if len(path) >= 2 else ''
    if name in _SKIP_NAMES or parent == 'router':
        return node
    in_moe = 'moe_mlp' in path
    # Kernels live under <proj>/kernel; MoE expert stacks are raw
    # arrays named gate_proj/up_proj/down_proj.
    if name == 'kernel' and parent in _CONTRACT_AXES:
        axes = _CONTRACT_AXES[parent]
    elif in_moe and name in _MOE_CONTRACT_AXES:
        axes = _MOE_CONTRACT_AXES[name]
    else:
        return node
    arr = node if torch.is_tensor(node) else np.asarray(node)
    expected = {
        'q_proj': 3, 'k_proj': 3, 'v_proj': 3, 'o_proj': 3,
        'gate_proj': 3 if in_moe else 2,
        'up_proj': 3 if in_moe else 2,
        'down_proj': 3 if in_moe else 2,
        'lm_head': 2,
    }[parent if name == 'kernel' else name]
    shift = arr.ndim - expected
    if shift < 0:
        return node
    return _quantize_array(arr, tuple(a + shift for a in axes))


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of the reference-layout tree with every matmul kernel an
    int8 {'qvalue', 'scale'} leaf (scan-stacked or unstacked layers,
    MoE stacks), one leaf at a time."""

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return quantize_leaf(path, node)

    return walk(params, ())


def _numel(x: Any) -> int:
    return x.numel() if torch.is_tensor(x) else int(np.size(x))


def quantization_report(params: Dict[str, Any]) -> Dict[str, Any]:
    """Bytes before (as f32) and after, for the startup log."""
    total = quantized = 0

    def visit(node):
        nonlocal total, quantized
        if is_quantized_leaf(node):
            n = _numel(node['qvalue'])
            total += n * 4
            quantized += n + _numel(node['scale']) * 4
            return
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
            return
        total += _numel(node) * 4
        quantized += _numel(node) * 4

    visit(params)
    return {'fp32_bytes': total, 'quantized_bytes': quantized,
            'ratio': quantized / max(total, 1)}
