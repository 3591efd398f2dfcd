"""Llama-style decoder-only transformer as torch `nn.Module`s.

Mirrors `skypilot_tpu/models/transformer.py`: the same rotary
embedding (`_rope_freqs` / `_rope`, interleaved lanes), and modules
whose parameter names and shapes are the flax tree's, so a reader (and
`models/convert.py`) maps one onto the other by name:

    embed.embedding                     [V, d]
    layers.{i}.attn_norm.scale          [d]
    layers.{i}.attn.{q,k,v}_proj.kernel [d, h, hd]   (+ .bias [h, hd])
    layers.{i}.attn.o_proj.kernel       [h, hd, d]
    layers.{i}.mlp_norm.scale           [d]
    layers.{i}.mlp.{gate,up}_proj.kernel [d, f]
    layers.{i}.mlp.down_proj.kernel     [f, d]
    layers.{i}.moe_mlp.router.kernel    [d, E]       (MoE, in place of mlp)
    layers.{i}.moe_mlp.{gate,up}_proj   [E, d, f]
    layers.{i}.moe_mlp.down_proj        [E, f, d]
    final_norm.scale                    [d]
    lm_head.kernel                      [d, V]       (absent when tied)

With int8 weights (`quantized=True`, models/quantize.py) every matmul
kernel, the lm_head's included, is a `QuantDense` instead: buffers
`qvalue` (int8, the kernel's shape) and `scale` (f32, 1 on the input
axes), the reference tree's {'qvalue', 'scale'} leaf; `matrix(dtype)`
dequantizes it on every call, as the reference's `maybe_dequant` does.
An MoE layer's expert stacks are `moe.QuantStack`s then (per-expert
scales); its router stays float.

Two storage layouts:
- serving (the default): parameters do not require grad; matmul
  weights are stored in `cfg.dtype` (the cast the reference makes on
  every call with `maybe_dequant(kernel, x.dtype)`, done once), MoE
  expert stacks included; norm scales and the MoE router stay f32, and
  so does the lm_head (and a tied embedding) when `cfg.logits_in_f32`.
- `trainable=True`: every leaf in `cfg.param_dtype` (f32) with
  requires_grad, as flax keeps `param_dtype` and casts to `cfg.dtype`
  for compute; the math casts with `.to(x.dtype)`, which autograd
  carries back to the f32 leaf.

`Transformer.forward` is the reference's `Transformer.__call__`: the
differentiable forward over every position (flash attention, remat per
`cfg.remat` / `cfg.remat_policy`) that training runs.  The serving
paths (KV caches, paged pools) live in `models/decode.py` as plain
functions over these modules; both share its layer math.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.models import quantize as quantize_lib
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.ops.attention import flash_attention
from skypilot_tpu_torch.parallel import sharding

# flax's lecun_normal: variance_scaling(1, 'fan_in', truncated_normal),
# whose stddev is divided by the std of a unit normal truncated at +-2.
_TRUNC_STD = 0.87962566103423978


def _rope_freqs(d: int, cfg: ModelConfig, device=None) -> torch.Tensor:
    """Per-pair rotary frequencies [d/2] (f32), with the config's
    long-context scaling applied."""
    freqs = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    st = cfg.rope_scaling_type
    if st is None:
        return freqs
    factor = cfg.rope_scaling_factor
    if st == 'linear':
        return freqs / factor
    if st == 'llama3':
        orig = float(cfg.rope_original_max_len)
        low_wl = orig / cfg.rope_low_freq_factor
        high_wl = orig / cfg.rope_high_freq_factor
        wavelen = 2.0 * math.pi / freqs
        smooth = ((orig / wavelen - cfg.rope_low_freq_factor) /
                  (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor))
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        return torch.where(wavelen > low_wl, freqs / factor,
                           torch.where(wavelen < high_wl, freqs, mid))
    raise ValueError(f'Unknown rope_scaling_type {st!r}; '
                     "have None, 'linear', 'llama3'.")


def _rope(x: torch.Tensor, positions: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Rotary embeddings on [b, h, s, d]; positions [s] (shared) or
    [b, s] (per sequence).  Pairs INTERLEAVED lanes (x[..., ::2],
    x[..., 1::2]) like the reference, not HF's rotate-half."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, cfg, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    if angles.dim() == 2:
        cos = torch.cos(angles)[None, None]   # [1,1,s,d/2]
        sin = torch.sin(angles)[None, None]
    else:
        cos = torch.cos(angles)[:, None]      # [b,1,s,d/2]
        sin = torch.sin(angles)[:, None]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., ::2], x32[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                    device=device), requires_grad=False)


class _Storage(NamedTuple):
    """Storage dtype of each kind of parameter (module docstring)."""
    matmul: torch.dtype     # q/k/v/o, MLP kernels, expert stacks, biases
    norm: torch.dtype
    embed: torch.dtype
    head: torch.dtype
    router: torch.dtype     # the MoE router kernel


def _storage(cfg: ModelConfig, trainable: bool) -> _Storage:
    if trainable:
        return _Storage(*[cfg.param_dtype] * 5)
    head = torch.float32 if cfg.logits_in_f32 else cfg.dtype
    embed = head if cfg.tie_embeddings else cfg.dtype
    return _Storage(cfg.dtype, torch.float32, embed, head, torch.float32)


class RMSNorm(nn.Module):

    def __init__(self, dim: int, *, dtype, device) -> None:
        super().__init__()
        self.scale = _param((dim,), dtype, device)


class Dense(nn.Module):
    """flax DenseGeneral's parameters: kernel [*in_shape, *out_shape],
    optional bias [*out_shape]."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 *, dtype, device, bias: bool = False) -> None:
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.fan_in = math.prod(self.in_shape)
        self.kernel = _param(self.in_shape + self.out_shape, dtype, device)
        self.bias = (_param(self.out_shape, dtype, device) if bias
                     else None)

    def matrix(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel as a [fan_in, fan_out] matrix in `dtype` (a view
        when the kernel is stored in `dtype`)."""
        return self.kernel.reshape(self.fan_in, -1).to(dtype)


class QuantDense(nn.Module):
    """Dense with an int8 kernel: buffers qvalue [*in_shape, *out_shape]
    (int8) and scale [1 x len(in_shape), *out_shape] (f32, per output
    channel), optional float bias [*out_shape]."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 *, dtype, device, bias: bool = False) -> None:
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.fan_in = math.prod(self.in_shape)
        self.register_buffer('qvalue', torch.empty(
            self.in_shape + self.out_shape, dtype=torch.int8,
            device=device))
        self.register_buffer('scale', torch.empty(
            (1,) * len(self.in_shape) + self.out_shape,
            dtype=torch.float32, device=device))
        self.bias = (_param(self.out_shape, dtype, device) if bias
                     else None)

    def matrix(self, dtype: torch.dtype) -> torch.Tensor:
        """The dequantized kernel as a [fan_in, fan_out] matrix in
        `dtype`: the reference's maybe_dequant(kernel, dtype), a new
        tensor on every call."""
        leaf = {'qvalue': self.qvalue, 'scale': self.scale}
        return quantize_lib.dequant(leaf, dtype).reshape(self.fan_in, -1)


class Attention(nn.Module):

    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 dense=Dense) -> None:
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(dtype=dtype, device=device, bias=cfg.qkv_bias)
        self.q_proj = dense((d,), (cfg.n_heads, hd), **kw)
        self.k_proj = dense((d,), (cfg.n_kv_heads, hd), **kw)
        self.v_proj = dense((d,), (cfg.n_kv_heads, hd), **kw)
        self.o_proj = dense((cfg.n_heads, hd), (d,), dtype=dtype,
                            device=device)


class MLP(nn.Module):

    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 dense=Dense) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gate_proj = dense((cfg.d_model,), (cfg.d_ff,), **kw)
        self.up_proj = dense((cfg.d_model,), (cfg.d_ff,), **kw)
        self.down_proj = dense((cfg.d_ff,), (cfg.d_model,), **kw)


class DecoderLayer(nn.Module):

    def __init__(self, cfg: ModelConfig, *, storage: _Storage,
                 device, dense=Dense) -> None:
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.d_model, dtype=storage.norm,
                                 device=device)
        self.attn = Attention(cfg, dtype=storage.matmul, device=device,
                              dense=dense)
        self.mlp_norm = RMSNorm(cfg.d_model, dtype=storage.norm,
                                device=device)
        if cfg.n_experts > 0:
            self.moe_mlp = moe_lib.MoEMLP(
                cfg, dtype=storage.matmul, router_dtype=storage.router,
                device=device, dense=Dense, quantized=dense is QuantDense)
        else:
            self.mlp = MLP(cfg, dtype=storage.matmul, device=device,
                           dense=dense)

    def attn_inputs(self, x: torch.Tensor, positions: torch.Tensor,
                    shape) -> Tuple[torch.Tensor, ...]:
        """Residual rows x [b * s, d] (`shape` = (b, s)) -> the rotated
        q and k and v [b, heads, s, hd], contiguous, at `positions`."""
        from skypilot_tpu_torch.models import decode  # pylint: disable=import-outside-toplevel
        q, k, v = decode._tp_qkv(self.cfg, [self], [x], [positions], shape,  # pylint: disable=protected-access
                                 False)[0]
        return q.contiguous(), k.contiguous(), v.contiguous()

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                shape, microbatch: int = 0) -> torch.Tensor:
        """The training forward of one layer: residual rows x [b * s, d]
        (`shape` = (b, s)) -> the same, attention through the
        differentiable `flash_attention` on the whole sequence; an MoE
        block takes the capacity dispatch at every s, as flax's MoEMLP
        does (across hosts keyed by `microbatch`, the rows' accumulation
        microbatch)."""
        from skypilot_tpu_torch.models import decode  # pylint: disable=import-outside-toplevel
        out = flash_attention(*self.attn_inputs(x, positions, shape),
                              causal=True)
        return decode._tp_out_and_mlp(self.cfg, [self], [x], [out], False,  # pylint: disable=protected-access
                                      capacity=True, key=(microbatch, 0))[0]


class Embed(nn.Module):

    def __init__(self, vocab: int, dim: int, *, dtype, device) -> None:
        super().__init__()
        self.embedding = _param((vocab, dim), dtype, device)


class Transformer(nn.Module):
    """Parameters of the whole decoder.  Construction allocates them
    UNINITIALISED on `device`; `init_params` fills them from a seed and
    `convert.from_jax_params` from a reference tree.  `trainable`
    picks the storage layout, `quantized` int8 matmul kernels (module
    docstring)."""

    def __init__(self, cfg: ModelConfig, *, device,
                 trainable: bool = False, quantized: bool = False) -> None:
        super().__init__()
        if trainable and quantized:
            raise ValueError('int8 weights serve only; a trainable model '
                             'keeps float leaves')
        self.cfg = cfg
        self.quantized = quantized
        dense = QuantDense if quantized else Dense
        storage = _storage(cfg, trainable)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype=storage.embed,
                           device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, storage=storage, device=device, dense=dense)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype=storage.norm,
                                  device=device)
        self.lm_head = (None if cfg.tie_embeddings else dense(
            (cfg.d_model,), (cfg.vocab_size,), dtype=storage.head,
            device=device))
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def forward(self, tokens, return_hidden: bool = False, *,
                shards: Optional['ShardedParams'] = None,
                num_microbatches: int = 1, microbatch: int = 0):
        """tokens [b, s] -> logits [b, s, V] f32; with return_hidden,
        -> (final hidden [b, s, d] in cfg.dtype, lm-head kernel [d, V]
        in the logits matmul dtype) for the fused linear + CE loss
        (models/losses.py), so the [b, s, V] tensor is never built.

        With `shards` (a model over a mesh; this module then only names
        the leaves), `tokens` is one [b / ranks, s] tensor per batch
        rank and the result one logits tensor (or hidden and kernel)
        per mesh position: `mesh_forward` (over `num_microbatches`
        pipeline microbatches).  `microbatch`: which accumulation
        microbatch of a training step these rows are, the key of their
        MoE dispatches in the step's exchange across hosts
        (`moe.host_dispatch`)."""
        if shards is not None:
            return mesh_forward(self, shards, tokens, return_hidden,
                                num_microbatches, microbatch)
        from skypilot_tpu_torch.models import decode  # pylint: disable=import-outside-toplevel
        from skypilot_tpu_torch.models import heads  # pylint: disable=import-outside-toplevel
        cfg = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)
        x = decode._embed(cfg, self, tokens).reshape(b * s, cfg.d_model)  # pylint: disable=protected-access
        context_fn = _remat_context(cfg) if cfg.remat else None
        for layer in self.layers:
            if context_fn is None:
                x = layer(x, positions, (b, s), microbatch)
            else:
                x = torch_checkpoint.checkpoint(
                    layer, x, positions, (b, s), microbatch,
                    use_reentrant=False, context_fn=context_fn)
        x = decode._norm(x, self.final_norm.scale, cfg.norm_eps,  # pylint: disable=protected-access
                         cfg.norm_scale_plus_one).reshape(b, s, -1)
        if return_hidden:
            return x, heads.head_kernel(self, cfg)
        return heads.unembed(x, self, cfg)


# Ops whose outputs remat_policy='dots' keeps: the matmuls without batch
# dims (every projection is a 2-D mm), as jax's
# dots_with_no_batch_dims_saveable keeps the dot_generals without them.
_DOTS = (torch.ops.aten.mm.default,)


def _save_dots(ctx, op, *args, **kwargs):  # pylint: disable=unused-argument
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg: ModelConfig):
    """cfg.remat_policy -> the checkpoint's context_fn ('full' saves
    nothing but the layer input and recomputes the rest)."""
    if cfg.remat_policy == 'full':
        return torch_checkpoint.noop_context_fn
    if cfg.remat_policy == 'dots':
        return functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_dots)
    raise ValueError(f'Unknown remat_policy {cfg.remat_policy!r}; '
                     "have 'full', 'dots'.")


def _leaves(model: Transformer):
    """(qualified name, owning module) of every leaf in the float
    model's parameter order: a QuantDense's kernel stands where a
    Dense's does, a QuantStack where the float stack does (named as the
    stack, owned by the QuantStack)."""
    for prefix, module in model.named_modules():
        if isinstance(module, moe_lib.QuantStack):
            yield prefix, module
            continue
        names = [n for n, _ in module.named_parameters(recurse=False)]
        if isinstance(module, QuantDense):
            names = ['kernel'] + names
        for name in names:
            yield f'{prefix}.{name}', module


def _is_quantized(leaf: str, module: nn.Module) -> bool:
    """Whether leaf `leaf` of `module` is an int8 kernel or stack (a
    QuantDense's float bias is not)."""
    return leaf != 'bias' and isinstance(module, (QuantDense,
                                                  moe_lib.QuantStack))


def _initial_value(name: str, module: nn.Module, cfg: ModelConfig,
                   gen: torch.Generator, device) -> torch.Tensor:
    """Seeded flax-style initial value of one leaf as a new f32 tensor
    on `device` (the generator's): identity norm scales, zero biases,
    normal(0.02) embeddings, truncated lecun-normal kernels."""
    leaf = name.rsplit('.', 1)[-1]
    if _is_quantized(leaf, module):
        shape, fan_in = module.qvalue.shape, module.fan_in
    else:
        shape = getattr(module, leaf).shape
        # An expert stack [E, in, out]: flax's lecun_normal counts the
        # leading axis as receptive field, so fan_in = E * in.
        fan_in = (shape[0] * shape[1] if isinstance(module, moe_lib.MoEMLP)
                  else getattr(module, 'fan_in', 1))
    tmp = torch.empty(shape, dtype=torch.float32, device=device)
    if leaf == 'scale':
        # Gemma's (1 + w) norms start at w = 0; both are identity scale.
        return tmp.fill_(0.0 if cfg.norm_scale_plus_one else 1.0)
    if leaf == 'bias':
        return tmp.zero_()
    if leaf == 'embedding':
        tmp.normal_(0.0, 0.02, generator=gen)
    else:
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        torch.nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=gen)
    return tmp


def _fill_(name: str, module: nn.Module, cfg: ModelConfig,
           gen: torch.Generator) -> None:
    """Seeded flax-style init of one leaf, drawn in f32 on the leaf's
    device and cast into it, or quantized into a QuantDense's (or a
    QuantStack's) buffers
    (one tensor at a time, so the f32 tree never exists as a whole)."""
    leaf = name.rsplit('.', 1)[-1]
    quantized = _is_quantized(leaf, module)
    target = module.qvalue if quantized else getattr(module, leaf)
    tmp = _initial_value(name, module, cfg, gen, target.device)
    if quantized:
        q = quantize_lib.quantize_leaf(tuple(name.split('.')), tmp)
        module.qvalue.copy_(q['qvalue'])
        module.scale.copy_(q['scale'])
    else:
        target.copy_(tmp)
    del tmp


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: Union[str, torch.device] = 'cuda',
                trainable: bool = False,
                quantize: Optional[str] = None) -> Transformer:
    """Seeded random weights on `device`: normal(0.02) for the
    embedding, lecun-normal (truncated, variance 1/fan_in) for every
    kernel, identity norm scales, zero biases.  The port's own
    generator: values differ from the reference's jax.random init (the
    tests carry reference weights over with convert.from_jax_params).
    `trainable` stores every leaf in cfg.param_dtype with grad;
    quantize='int8' quantizes each kernel's f32 draw on `device` (the
    same draws as the float init)."""
    if quantize not in (None, 'int8'):
        raise ValueError(f'Unknown quantize mode {quantize!r}; '
                         "have 'int8'.")
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, trainable=trainable,
                        quantized=quantize is not None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, module in _leaves(model):
            _fill_(name, module, cfg, gen)
    return model.eval()


# ------------------------------------------------------------------ meshes
#
# A trainable model over a mesh (parallel/mesh.py) keeps every leaf as
# the distinct blocks that the reference's logical-axis rules give it
# (parallel/sharding.py), each with a copy on every distinct device
# entry that holds it (one on a list that repeats one card); a position
# reads its own entry's copies, or the owner's where its entry holds
# none.  `Transformer` itself then lives on the 'meta'
# device and only names the leaves: `mesh_forward` runs each mesh
# position's rows on its own device, with each layer's weights gathered
# there inside the layer's checkpoint.  Over a 'tensor' axis a position
# gathers only its tensor rank's slice of each leaf and runs it through
# a narrow meta model of the rank's config (`ShardedParams.rank_models`),
# the tensor ranks joined as the serving path joins them
# (models/decode.py's tensor-parallel layer body).

# The reference's logical axes of each kernel (its
# with_logical_partitioning annotations), by the module that owns it.
_KERNEL_AXES = {
    'q_proj': ('embed', 'heads', 'head_dim'),
    'k_proj': ('embed', 'kv_heads', 'head_dim'),
    'v_proj': ('embed', 'kv_heads', 'head_dim'),
    'o_proj': ('heads', 'head_dim', 'embed'),
    'gate_proj': ('embed', 'mlp'),
    'up_proj': ('embed', 'mlp'),
    'down_proj': ('mlp', 'embed'),
    'router': ('embed', 'expert'),
    'lm_head': ('embed', 'vocab'),
}


def logical_axes(name: str) -> Tuple[Optional[str], ...]:
    """The logical axes of the parameter `name` (its module path, such
    as 'layers.0.attn.q_proj.kernel'), as the reference annotates it
    (`skypilot_tpu/models/transformer.py`, `models/moe.py`).  A bias
    carries none (replicated), as flax's unannotated bias."""
    parts = name.split('.')
    leaf = parts[-1]
    if leaf == 'embedding':
        return ('vocab', 'embed')
    if leaf == 'scale':
        return ('embed',)
    if leaf == 'bias':
        return ()
    if parts[-2] == 'moe_mlp':      # an expert stack [E, in, out]
        return (('expert', 'mlp', 'embed') if leaf == 'down_proj'
                else ('expert', 'embed', 'mlp'))
    return _KERNEL_AXES[parts[-2]]


def check_mesh(mesh, cfg: ModelConfig) -> None:
    """Refuse the mesh axes the port does not train over yet, a
    pipeline that does not cut `cfg`'s layers evenly, and a tensor
    degree that `cfg`'s shapes or kind do not take
    (`tensor_parallel.check_degree`: it must divide heads, kv heads,
    d_ff and vocab)."""
    from skypilot_tpu_torch.models import tensor_parallel  # pylint: disable=import-outside-toplevel
    if mesh.shape.get('expert', 1) > 1:
        raise NotImplementedError(
            f'expert={mesh.shape["expert"]}: training over the \'expert\' '
            'mesh axis is ROADMAP item A17g (the expert axis: experts split '
            'over devices), a later slice of the port')
    stages = global_stages(mesh)
    if cfg.n_layers % stages:
        raise ValueError(f'n_layers={cfg.n_layers} not divisible by '
                         f'n_stages={stages} (the \'pipeline\' axis)')
    tensor_parallel.check_degree(cfg, int(mesh.shape.get('tensor', 1)))


def global_stages(mesh) -> int:
    """The pipeline's stage count over every host (`mesh.shape` holds
    this host's part)."""
    return int(mesh.global_shape.get('pipeline', 1))


def layer_stage(cfg: ModelConfig, mesh, index: int) -> int:
    """The global pipeline stage that runs layer `index`: stages take
    n_layers / S consecutive layers each, as the reference's
    split_stage_params reshapes [L] into [S, L / S]; this host holds
    stages mesh.global_stage onwards."""
    return index // (cfg.n_layers // global_stages(mesh))


class MeshGeometry(NamedTuple):
    """Where a mesh runs a training forward: `stages[p][i][r][t]` is the
    mesh position of pipeline stage p, batch rank i (over 'data' x
    'fsdp', data major, as `token_batch_sharding` splits the batch),
    sequence rank r and tensor rank t; `ranks` is stage 0's.  The
    tensor ranks of one (p, i, r) hold the same rows and columns: one
    (batch, sequence) rank of the stage."""
    ranks: List[List[List[int]]]
    sp: int
    tp: int
    stages: List[List[List[List[int]]]]

    @property
    def pp(self) -> int:
        return len(self.stages)

    def stage(self, p: int) -> 'MeshGeometry':
        """The geometry of stage p alone (its ranks as `ranks`)."""
        return MeshGeometry(self.stages[p], self.sp, self.tp,
                            [self.stages[p]])


def mesh_geometry(mesh, cfg: ModelConfig) -> MeshGeometry:
    check_mesh(mesh, cfg)
    sp, tp = mesh.shape.get('sequence', 1), mesh.shape.get('tensor', 1)
    data, fsdp = mesh.shape.get('data', 1), mesh.shape.get('fsdp', 1)
    stages = [[[[mesh.position(data=d, pipeline=p, fsdp=f, sequence=r,
                               tensor=t)
                 for t in range(tp)] for r in range(sp)]
               for d in range(data) for f in range(fsdp)]
              for p in range(mesh.shape.get('pipeline', 1))]
    return MeshGeometry(stages[0], sp, tp, stages)


def row_devices(mesh, ranks: List[List[List[int]]]
                ) -> List[List[torch.device]]:
    """devs[g][t]: the device of tensor rank t of (batch, sequence)
    rank g = i * sp + r of `ranks` (one stage's)."""
    return [[mesh.devices[p] for p in row] for rank in ranks for row in rank]


class ShardedParams:
    """The blocks of every parameter of `model` (a 'meta' Transformer
    naming the leaves) over `mesh`: `copies[name]` is {block index:
    {holder entry: its copy}}, a copy on each distinct device entry
    that holds the block (`sharding.Placement.holders`, the owner
    first), each a leaf with requires_grad; `blocks[name]` is {block
    index: the owner's copy}, and `placements[name]` the leaf's
    `sharding.Placement`.  `rank_models[t]` is tensor rank t's narrow
    meta Transformer (`rank_cfg`), which `tree` binds to the rank's
    slices."""

    def __init__(self, model: Transformer, mesh,
                 copies: Dict[str, Dict[Tuple[int, ...],
                                        Dict[torch.device, torch.Tensor]]]
                 ) -> None:
        self.model = model
        self.mesh = mesh
        self.placements = placements(model, mesh)
        self.shapes = {name: p.shape for name, p in model.named_parameters()}
        if list(copies) != list(self.placements):
            raise ValueError('blocks do not name the model\'s parameters '
                             'in order')
        for name, placement in self.placements.items():
            want = {blk: [mesh.devices[pos] for pos in positions]
                    for blk, positions in placement.holders(
                        len(self.shapes[name])).items()}
            got = {blk: list(held) for blk, held in copies[name].items()}
            if got != want:
                raise ValueError(f'{name}: copies {got}, the placement '
                                 f'holds {want}')
            for blk, held in copies[name].items():
                owner, *rest = held.values()
                if any(t.shape != owner.shape or t.dtype != owner.dtype
                       for t in rest):
                    raise ValueError(f'{name} block {blk}: copies differ '
                                     'in shape or dtype')
        self.copies = copies
        self.blocks = {name: {blk: next(iter(held.values()))
                              for blk, held in blocks.items()}
                       for name, blocks in copies.items()}
        # One meta model a tensor rank, of the rank's narrow config
        # (distinct modules, so `_call` binds every rank's slices at
        # once); the model itself at tensor 1.
        from skypilot_tpu_torch.models import tensor_parallel  # pylint: disable=import-outside-toplevel
        tp = int(mesh.shape.get('tensor', 1))
        self.rank_cfg = tensor_parallel.rank_config(model.cfg, tp)
        self.rank_models = nn.ModuleList(
            [model] if tp == 1 else
            [Transformer(self.rank_cfg, device='meta', trainable=True)
             for _ in range(tp)])

    @classmethod
    def init(cls, model: Transformer, mesh, seed: int) -> 'ShardedParams':
        """Seeded initial values, bit-equal to `init_params(cfg, seed=,
        trainable=True)` on the mesh's first device: each leaf is drawn
        whole there, in init_params' order and with its generator, cut
        into blocks whose copies all take the same bits, and freed
        before the next (one full leaf at a time)."""
        dev = mesh.devices[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        places = placements(model, mesh)
        dtype = model.cfg.param_dtype
        copies = {}
        with torch.no_grad():
            for name, module in _leaves(model):
                full = _initial_value(name, module, model.cfg, gen, dev)
                copies[name] = sharding.split(full.to(dtype), places[name],
                                              requires_grad=True)
                del full
        return cls(model, mesh, copies)

    @classmethod
    def from_model(cls, model: Transformer, mesh) -> 'ShardedParams':
        """A trainable Transformer's values (`convert.from_jax_params(
        ..., trainable=True)`, say) cut into blocks on their holders,
        over a meta model of the same config."""
        meta = Transformer(model.cfg, device='meta', trainable=True)
        places = placements(meta, mesh)
        with torch.no_grad():
            copies = {name: sharding.split(p.detach(), places[name],
                                           requires_grad=True)
                      for name, p in model.named_parameters()}
        return cls(meta, mesh, copies)

    @classmethod
    def empty(cls, model: Transformer, mesh,
              device: Optional[Union[str, torch.device]] = None
              ) -> 'ShardedParams':
        """Uninitialised copies on their holders (on `device` instead,
        as 'meta' for an abstract state, keyed by the same entries)."""
        copies = {}
        params = dict(model.named_parameters())
        for name, placement in placements(model, mesh).items():
            p = params[name]
            copies[name] = {}
            for blk, positions in placement.holders(p.dim()).items():
                shape = [len(range(*s.indices(n))) for s, n in zip(
                    placement.index(positions[0], p.shape), p.shape)]
                copies[name][blk] = {
                    mesh.devices[pos]: torch.empty(
                        shape, dtype=p.dtype,
                        device=device or mesh.devices[pos]
                    ).requires_grad_() for pos in positions}
        return cls(model, mesh, copies)

    def parameters(self) -> List[torch.Tensor]:
        """Every copy of every block, leaf by leaf in the model's order
        (the optimizer's tensors: AdamW keeps moments for each)."""
        return [t for blocks in self.copies.values()
                for held in blocks.values() for t in held.values()]

    def owner_parameters(self) -> List[torch.Tensor]:
        """Each block's owner copy, leaf by leaf: every element once."""
        return [t for blocks in self.blocks.values()
                for t in blocks.values()]

    def replicas(self) -> List[List[torch.Tensor]]:
        """[owner, other copies...] of every block that has more than
        one copy, in holder order."""
        return [list(held.values()) for blocks in self.copies.values()
                for held in blocks.values() if len(held) > 1]

    @torch.no_grad()
    def sum_copy_grads(self) -> None:
        """After a backward: each block's gradient summed over its
        copies (each copy's holds what its entry read) into the owner's
        `.grad`, in f32 in holder order, and the other copies' `.grad`
        dropped; `copy_owner_grads` hands the owner's back out."""
        for held in self.replicas():
            grads = [t.grad for t in held if t.grad is not None]
            if not grads:
                continue
            owner = held[0]
            total = grads[0].to(owner.device, torch.float32)
            for g in grads[1:]:
                total = total + g.to(owner.device, torch.float32)
            owner.grad = total.to(owner.dtype)
            for t in held[1:]:
                t.grad = None

    @torch.no_grad()
    def copy_owner_grads(self) -> None:
        """Each owner's `.grad` copied to the block's other copies, so
        one optimizer step gives every copy the same bits."""
        for owner, *rest in self.replicas():
            for t in rest:
                t.grad = (None if owner.grad is None else
                          owner.grad.to(t.device, copy=True))

    def pieces(self, name: str) -> List[Tuple[torch.Tensor,
                                              Tuple[slice, ...]]]:
        """(the owner's copy, its slice of the full leaf) for each block
        of `name`: every element once."""
        placement = self.placements[name]
        full = self.shapes[name]
        owners = placement.owners(len(full))
        return [(t, placement.index(owners[blk], full))
                for blk, t in self.blocks[name].items()]

    def gather(self, name: str, device,
               tensor: Optional[int] = None) -> torch.Tensor:
        """The full leaf `name` on `device` (a mesh entry), from the
        copies that entry holds; with `tensor`, tensor rank `tensor`'s
        slice of it (the dims 'tensor' splits cut to the rank's block,
        the other axes' blocks joined)."""
        fixed = None if tensor is None else {'tensor': tensor}
        return sharding.gather(self.copies[name], self.placements[name],
                               device, fixed)

    def tree(self, prefix: str, devices: Sequence[torch.device]
             ) -> Dict[str, torch.Tensor]:
        """`_call`'s parameters for `rank_models` over one row of tensor
        ranks: {f'{t}.{name}': rank t's slice on devices[t]} for every
        parameter whose name starts with `prefix`."""
        return {f'{t}.{name}': self.gather(name, dev, tensor=t)
                for t, dev in enumerate(devices)
                for name in self.blocks if name.startswith(prefix)}

    def position_bytes(self) -> List[int]:
        """Bytes of the blocks each mesh position holds (a replicated
        block counts at every position that reads it; a stage's layer
        only at its stage's positions)."""
        out = [0] * self.mesh.size
        for name, blocks in self.blocks.items():
            ndim = len(self.shapes[name])
            placement = self.placements[name]
            for pos in filter(placement.holds, range(self.mesh.size)):
                t = blocks[placement.block(pos, ndim)]
                out[pos] += t.numel() * t.element_size()
        return out

    def device_bytes(self) -> List[int]:
        """Bytes of the copies stored on each of `mesh.distinct_devices()`
        (parameters only: AdamW adds two moments of each)."""
        out = dict.fromkeys(self.mesh.distinct_devices(), 0)
        for blocks in self.copies.values():
            for held in blocks.values():
                for dev, t in held.items():
                    out[dev] += t.numel() * t.element_size()
        return list(out.values())


def placements(model: Transformer, mesh) -> Dict[str, object]:
    """{parameter name: its Placement on `mesh`}, in the model's order.
    Over a 'pipeline' axis, layer i's leaves are held only by the
    positions of its stage (`layer_stage`), where they keep the split
    of their logical axes (a stage on another host: by none of this
    host's); the embedding, final norm and head are replicated over
    'pipeline', as the reference's stage_param_shardings places
    them."""
    check_mesh(mesh, model.cfg)
    out = {}
    for name, _ in model.named_parameters():
        placement = sharding.logical_sharding(mesh, *logical_axes(name))
        if global_stages(mesh) > 1 and name.startswith('layers.'):
            stage = layer_stage(model.cfg, mesh, int(name.split('.')[1]))
            placement = dataclasses.replace(
                placement, at=(('pipeline', stage - mesh.global_stage),))
        out[name] = placement
    return out


class _Bound(nn.Module):
    """functional_call's target: fn(module, *args) with the given
    tensors standing in for the module's parameters."""

    def __init__(self, module: nn.Module) -> None:
        super().__init__()
        self.module = module

    def forward(self, fn, *args):
        return fn(self.module, *args)


def _call(module: nn.Module, params: Dict[str, torch.Tensor], fn, *args):
    return torch.func.functional_call(
        _Bound(module), {f'module.{k}': v for k, v in params.items()},
        (fn,) + args)


def mesh_forward(model: Transformer, shards: ShardedParams,
                 tokens: Sequence[torch.Tensor], return_hidden: bool,
                 num_microbatches: int = 1, microbatch: int = 0):
    """The reference's forward under a mesh, made explicit.  Activations
    follow ('batch', 'seq', 'embed'): batch rank i's tokens [b_i, s]
    (any device) are cut into `sp` chunks of s / sp columns, and
    (batch, sequence) rank (i, r) runs chunk r (positions r * s / sp
    onwards) over its tensor ranks ranks[i][r], each on its own device.
    A row of tensor ranks runs decode.py's tensor-parallel layer body
    over its slices (`shards.rank_models`): the vocab-masked embedding,
    each rank's q/k/v heads, o_proj and MLP partials summed in rank
    order (`tensor_parallel.all_reduce`), the residual rows kept on
    tensor rank 0's device.  Attention runs per tensor rank over its
    heads: `ring_attention_shards` or `ulysses_attention_shards` over
    the sequence ranks of one (batch, tensor) rank (per
    cfg.sequence_parallel) when the sequence axis is above 1, else the
    flash kernel.  Over a 'pipeline' axis, or with num_microbatches >
    1, the layers run under parallel/pipeline.py's GPipe schedule:
    the embedding on stage 0's ranks, each stage's layers on its own
    ranks, microbatch m being rows m * b_i / M onwards of every batch
    rank, and the head on the last stage's ranks; across hosts each
    host runs its own stages, the embedding only where it holds stage
    0, and returns None where another host holds the last.  -> one output per
    (batch, sequence) rank of the last stage, batch rank major: logits
    [b_i, s / sp, V] (the tensor ranks' vocab columns joined on tensor
    rank 0's device), or (hidden, [head kernel [d, V / tp] of each
    tensor rank, on its device])."""
    from skypilot_tpu_torch.models import decode  # pylint: disable=import-outside-toplevel
    cfg = model.cfg
    if cfg.sequence_parallel not in ('ring', 'ulysses'):
        raise ValueError(f'Unknown sequence_parallel '
                         f'{cfg.sequence_parallel!r}; have \'ring\', '
                         '\'ulysses\'.')
    geo = mesh_geometry(shards.mesh, cfg)
    if len(tokens) != len(geo.ranks):
        raise ValueError(f'{len(tokens)} token shards for '
                         f'{len(geo.ranks)} batch ranks')
    s = tokens[0].shape[1]
    if s % geo.sp:
        raise ValueError(f'sequence length {s} is not divisible by the '
                         f'\'sequence\' axis ({geo.sp})')
    chunk = s // geo.sp
    # devs[g][t]: the device of tensor rank t of (batch, sequence) rank
    # g = i * sp + r of stage 0.
    devs = row_devices(shards.mesh, geo.ranks)
    mesh = shards.mesh
    n_stages = global_stages(mesh)
    embeds: Dict[Tuple[torch.device, ...], Dict[str, torch.Tensor]] = {}
    # A host of a pipeline across hosts embeds only if it holds stage 0.
    xs = [] if mesh.global_stage == 0 else None
    for i, toks in enumerate(tokens if xs is not None else ()):
        for r in range(geo.sp):
            row = tuple(devs[i * geo.sp + r])
            if row not in embeds:
                embeds[row] = shards.tree('embed.', row)
            t = toks[:, r * chunk:(r + 1) * chunk].to(row[0])
            xs.append(_call(shards.rank_models, embeds[row],
                            lambda ms, t: decode._embed(cfg, None, t,  # pylint: disable=protected-access
                                                        shards=list(ms)),
                            t).reshape(-1, cfg.d_model))
    # A mesh's layer checkpoint is the reentrant one, whatever devices
    # its positions name.  Over several devices, autograd runs each
    # device's backward on a thread of its own, and two of them could
    # unpack one non-reentrant checkpoint at once: torch would then
    # recompute the layer twice, at the same time, over 'meta' layers
    # whose parameters `functional_call` swaps.  The reentrant checkpoint
    # recomputes inside one autograd node, once; it takes no selective
    # policy.
    if cfg.remat and cfg.remat_policy != 'full':
        raise NotImplementedError(
            f'remat_policy {cfg.remat_policy!r} on a mesh: only \'full\' '
            'recomputes there')
    if n_stages > 1 or num_microbatches > 1:
        from skypilot_tpu_torch.parallel import pipeline  # pylint: disable=import-outside-toplevel
        xs = pipeline.gpipe(model, shards, geo, tokens[0].shape[0], chunk,
                            num_microbatches, xs)
        if xs is None:      # the last stage is another host's
            return None
    else:
        for index in range(cfg.n_layers):
            fn = functools.partial(_mesh_layer, model, shards, geo, index,
                                   tokens[0].shape[0], chunk, devs,
                                   microbatch=microbatch)
            if cfg.remat:
                xs = torch_checkpoint.checkpoint(fn, *xs, use_reentrant=True)
            else:
                xs = fn(*xs)
    head = 'embed.' if cfg.tie_embeddings else 'lm_head.'
    outs, finals = [], {}
    for x, row in zip(xs, map(tuple, row_devices(shards.mesh,
                                                 geo.stages[-1]))):
        if row not in finals:
            finals[row] = {**shards.tree('final_norm.', row),
                           **shards.tree(head, row)}
        outs.append(_call(shards.rank_models, finals[row], _final, x,
                          return_hidden, x.shape[0] // chunk))
    return outs


def _final(ranks: nn.ModuleList, x: torch.Tensor, return_hidden: bool,
           b: int):
    """Final norm, then logits (the ranks' vocab columns joined on x's
    device) or (hidden, each rank's head kernel), of one (batch,
    sequence) rank's rows."""
    from skypilot_tpu_torch.models import decode  # pylint: disable=import-outside-toplevel
    from skypilot_tpu_torch.models import heads  # pylint: disable=import-outside-toplevel
    rcfg = ranks[0].cfg
    x = decode._norm(x, ranks[0].final_norm.scale, rcfg.norm_eps,  # pylint: disable=protected-access
                     rcfg.norm_scale_plus_one).reshape(b, -1, rcfg.d_model)
    kernels = [heads.head_kernel(m, rcfg) for m in ranks]
    if return_hidden:
        return x, kernels
    return heads.unembed_ranks(x, list(ranks), rcfg, kernels)


def _mesh_layer(model: Transformer, shards: ShardedParams,
                geo: MeshGeometry, index: int, b: int, chunk: int,
                devs: List[List[torch.device]], *xs: torch.Tensor,
                seq_local: bool = False, microbatch: int = 0):
    """Layer `index` over every (batch, sequence) rank's rows xs[g]
    [b * chunk, d] (on its tensor rank 0's device), through decode.py's
    tensor-parallel layer body (`_tp_qkv`, `_tp_out_and_mlp`; at tensor
    1 the plain layer's ops), each row of tensor ranks' slices gathered
    once (inside the checkpoint that calls this, so autograd keeps none
    of them).  An MoE block dispatches the tokens of all positions
    together, in the global [batch, seq] order, once a card of the
    first (batch, sequence) rank's tensor ranks, and runs over those
    ranks' slices (`_tp_moe_mlp`): the reference's capacity dispatch
    runs over the global batch.  With `seq_local` (the pipeline's stage
    body, which the reference runs manual over 'sequence'), each
    sequence rank's chunk of every batch rank dispatches on its own,
    on that sequence rank's first row.  Across hosts each dispatch
    takes its rows' place in the global batch from the step's exchange
    (`moe.host_dispatch`), keyed by (`microbatch`, the dispatch's
    sequence group).  The ranks' partials are summed out of place
    (`tensor_parallel.reduce_sum`), and the sum's rows go back to each
    (batch, sequence) rank."""
    from skypilot_tpu_torch.models import decode  # pylint: disable=import-outside-toplevel
    from skypilot_tpu_torch.models import tensor_parallel  # pylint: disable=import-outside-toplevel
    from skypilot_tpu_torch.ops.ring_attention import ring_attention_shards  # pylint: disable=import-outside-toplevel
    from skypilot_tpu_torch.ops.ulysses_attention import ulysses_attention_shards  # pylint: disable=import-outside-toplevel
    cfg, rcfg = model.cfg, shards.rank_cfg
    weights: Dict[Tuple[torch.device, ...], Dict[str, torch.Tensor]] = {}

    def run(g, fn, *args):
        """fn(layer `index` of each tensor rank, *args) with (batch,
        sequence) rank g's tensor ranks' slices bound."""
        row = tuple(devs[g])
        if row not in weights:
            weights[row] = shards.tree(f'layers.{index}.', row)
        return _call(shards.rank_models, weights[row],
                     lambda ms, *a: fn([m.layers[index] for m in ms], *a),
                     *args)

    # Each row's residual rows on each of its tensor ranks' devices, one
    # copy a card, for the layer's head and tail alike.
    spread = [tensor_parallel.on_cards(x, devs[g]) for g, x in enumerate(xs)]
    qkv = []
    for g, xr in enumerate(spread):
        start = (g % geo.sp) * chunk      # the rank's first position
        pos = tensor_parallel.on_cards(
            torch.arange(start, start + chunk, device=devs[g][0]), devs[g])
        qkv.append(run(g, lambda layers, xr, pos: [
            tuple(t.contiguous() for t in trio) for trio in
            decode._tp_qkv(rcfg, layers, xr, pos, (b, chunk), False)],  # pylint: disable=protected-access
            xr, pos))
    attend = (ulysses_attention_shards if cfg.sequence_parallel == 'ulysses'
              else ring_attention_shards)
    outs = [[None] * geo.tp for _ in xs]
    for i in range(len(geo.ranks)):
        span = range(i * geo.sp, (i + 1) * geo.sp)
        for t in range(geo.tp):
            q, k, v = ([qkv[g][t][j] for g in span] for j in range(3))
            if geo.sp == 1:
                got = [flash_attention(q[0], k[0], v[0], causal=True)]
            else:
                got = attend(q, k, v, [devs[g][t] for g in span],
                             causal=True, sm_scale=float(cfg.head_dim) ** -0.5)
            for g, o in zip(span, got):
                outs[g][t] = o
    if cfg.n_experts == 0:
        return tuple(
            run(g, lambda layers, xr, o: decode._tp_out_and_mlp(  # pylint: disable=protected-access
                rcfg, layers, xr, o, False)[0], xr, outs[g])
            for g, xr in enumerate(spread))
    mids, hs = [], []
    for g, xr in enumerate(spread):
        mid, h = run(g, lambda layers, xr, o: decode._tp_attn_out(  # pylint: disable=protected-access
            rcfg, layers, xr, o, False), xr, outs[g])
        mids.append(mid[0])
        hs.append(h[0])
    d = cfg.d_model
    groups = ([[r] for r in range(geo.sp)] if seq_local
              else [list(range(geo.sp))])
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for group in groups:
        lead = group[0]         # (batch rank 0, sequence rank group[0])
        rows = torch.cat([
            torch.cat([hs[i * geo.sp + r].reshape(b, chunk, d).to(
                devs[lead][0]) for r in group], dim=1)
            for i in range(len(geo.ranks))])
        y = run(lead, lambda layers, hs: decode._tp_moe_mlp(  # pylint: disable=protected-access
            rcfg, [layer.moe_mlp for layer in layers], hs, capacity=True,
            key=(microbatch, lead)),
            tensor_parallel.on_cards(rows, devs[lead]))
        for i in range(len(geo.ranks)):
            for k, r in enumerate(group):
                g = i * geo.sp + r
                out[g] = mids[g] + y[i * b:(i + 1) * b,
                                     k * chunk:(k + 1) * chunk].reshape(
                                         -1, d).to(mids[g].device)
    return tuple(out)
