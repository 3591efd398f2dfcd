"""KV-cache autoregressive decoding (mirrors `skypilot_tpu/models/decode.py`).

Plain functions over a `Transformer` (models/transformer.py) and cache
dicts of tensors, with the reference's names and cache layouts:

- dense cache {'k', 'v': [L, b, h_kv, max_len, d], 'index': int};
- slot cache {'k', 'v': [L, slots, h_kv, max_len, d], 'lengths':
  [slots] int32} (the serving engine's dense mode: every slot at its
  own depth);
- paged pool {'k', 'v': [L, n_pages, h_kv, ps, d] (or int8
  {'q', 'scale'} leaves), 'block_tables': [B, P] int32,
  'lengths': [B] int32}; page 0 is the reserved null page.

Mutation: where the reference returns updated copies of donated
buffers, the port writes in place (slice assignment / index_put_ into
the cache and pool tensors, whose dicts are returned for symmetry).
Per-slot engine state is small and is rebuilt functionally each tick,
so the one-tick-behind host read of the previous state stays valid
while the next tick runs.

Attention: chunk 0 of a prefill runs the flash kernel
(ops/attention.py), every paged tick the paged kernel
(ops/paged_attention.py, native or int8 pools); prefill chunks at
index > 0, dense decode and the slot cache's ticks use the masked
grouped einsum, as the reference does.

Row buckets: on the GPU the residual stream of a forward is carried
as one [rows, d] tensor whose rows are padded with zeros to a multiple
of 64 (`_pad_rows` at the start and before the last-position head;
each layer writes its attention output into a zeroed buffer of the
same rows).  cuBLAS and PyTorch's reductions pick their kernel, and so
their summation order, from the row count; on an H100 without the
buckets, greedy output differed with speculation on and off.  Within
one bucket a token's numbers do not depend on how many rows share the
call.  A decode tick whose padded rows exceed one bucket (a verify
tick at slots * (k + 1) > 64, say 16 slots at k = 4) runs every op
whose kernel follows the row count (the RMSNorms, each projection
GEMM, the MLP and the lm_head) once per 64-row block (`_by_blocks`),
so each call has the [64, K] x [K, N] shape of a one-bucket tick, and
a token's bits do not depend on how many rows share its tick at any
slots and k.  (CPU ticks run the same blocks, unpadded.)  Ticks of at most 64 rows make one call per op as
before; prefill chunks keep one call per op on their padded rows
(spec-on and spec-off engines prefill alike).

MoE layers (`_tp_moe_mlp`, the reference's _moe_mlp): a prefill or a
verify tick (s > 1) runs the capacity dispatch (`moe.moe_apply`'s
parts) over exactly its
b * s real rows, never the bucket padding (a pad row would change N,
the capacity and the buffer slots, and zero rows tie in the router); a
decode tick (s == 1) computes every expert in f32 for its rows,
weighted by gates that are zero off the top k.  The MoE block runs in
one call over those rows; the norm before it runs on every row as the
other row ops do.

Tensor-parallel models (`models/tensor_parallel.TensorParallel`, the
reference's 'tensor' axis): every function here that takes a model
takes one too, and one layer body serves both (a plain Transformer
runs as its one rank, op for op the plain layer).  Each rank runs its
narrow layer on its own device; the attention norm, the MLP norm and
the residual adds run once a card; the o_proj and down_proj partials
are all-reduced (`tensor_parallel.all_reduce`), an MoE block routes
once a card and sums the ranks' expert partials (`_tp_moe_mlp`), the
embedding is vocab-parallel and masked, the head vocab-parallel
(models/heads.py).  Its caches keep
one leaf per rank, in rank order, where a plain model's keep one
tensor: {'k': [rank leaves], 'v': [...]} with each rank's kv heads
[h_kv / tp] on its device, one contiguous pool a rank (so B1/B2 take
it as it is) shaped as the reference's `page_pool_sharding`,
`page_scale_sharding` and `slot_cache_sharding` (parallel/sharding.py)
cut the whole leaf for the rank's mesh position; block tables, lengths
and the engine state stay single, on rank 0's device, and a rank on
another card reads a copy made once a call.  Chunk 0 of a prefill runs B3 once
per layer and rank, a paged tick B1/B2 once per layer and rank.  The
wire layout of exported pages joins the ranks' heads in rank order, as
a tensor-1 pool holds them (`export_private_pages`, `read_pages`), and
imports split them again (`write_pages`).

Sampling keys are the port's own counter-based stream: a key is an
int64 pair (seed, counter); a split returns (seed, counter + 1) as the
carry and (seed, counter) as the draw key, and Gumbel noise comes from
an integer hash of (seed, counter, vocab index) in plain torch integer
ops, so the CPU and the GPU draw identical bits.  (The reference's
threefry bits are not reproduced; tests compare greedy output across
frameworks and seeded output within the port.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models import heads
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.tensor_parallel import TensorParallel
from skypilot_tpu_torch.models.transformer import _rope
from skypilot_tpu_torch.ops import paged_attention as paged_attention_ops
from skypilot_tpu_torch.ops.attention import NEG_INF
from skypilot_tpu_torch.ops.attention import flash_attention
from skypilot_tpu_torch.parallel import sharding


class _PagedView(NamedTuple):
    """What attention receives on the paged path: the raw pool leaf of
    one layer + block tables + lengths; the kernel reads pages by table
    index (the gathered view never materialises on the GPU)."""
    leaf: Any
    tables: torch.Tensor
    lengths: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = no top-k filtering
    seed: int = 0


# ------------------------------------------------------------ model math


def _rank_leaves(leaf) -> List[Any]:
    """A cache leaf as its per-rank leaves (a TensorParallel cache keeps
    a list; a plain one is its only rank)."""
    return leaf if isinstance(leaf, list) else [leaf]


def _first(leaf):
    return leaf[0] if isinstance(leaf, list) else leaf


def _leaf_device(leaf) -> torch.device:
    return (leaf['q'] if isinstance(leaf, dict) else leaf).device


def _split_heads(x, n: int):
    """Wire pages [L, n_pages, h_kv, ...] as n rank pieces along the
    kv heads, rank order (x itself for one rank)."""
    return [x] if n == 1 else list(x.chunk(n, dim=2))


def _join_heads(leaves):
    """Per-rank [L, ..., h_kv / tp, ...] pieces joined along the kv
    heads (dim 2) on the first rank's device: the tensor-1 layout."""
    if not isinstance(leaves, list):
        return leaves
    dev = leaves[0].device
    return torch.cat([t.to(dev) for t in leaves], dim=2)


def _local():
    """get(t, device): a call's small index tensor `t` on `device`: `t`
    itself on its own card, else one copy a card for the whole call."""
    memo: Dict[Tuple[int, torch.device], Tuple[torch.Tensor,
                                              torch.Tensor]] = {}

    def get(t: torch.Tensor, device: torch.device) -> torch.Tensor:
        if t.device == device:
            return t
        key = (id(t), device)
        if key not in memo:
            memo[key] = (t, t.to(device))
        return memo[key][1]

    return get


_ROW_BUCKET = 64


def _pad_rows(x2d: torch.Tensor) -> torch.Tensor:
    """A CUDA [m, k] tensor with zero rows appended up to a multiple of
    _ROW_BUCKET; CPU tensors as they are."""
    pad = (-x2d.shape[0]) % _ROW_BUCKET if x2d.is_cuda else 0
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros((pad, x2d.shape[1]))])
    return x2d


def _by_blocks(fn, x: torch.Tensor, blocked: bool) -> torch.Tensor:
    """fn(x) over rows x [M, k]; with `blocked` (a decode tick) and more
    than _ROW_BUCKET rows, fn once per _ROW_BUCKET-row block,
    concatenated (module docstring: row buckets)."""
    if blocked and x.shape[0] > _ROW_BUCKET:
        return torch.cat([fn(rows) for rows in x.split(_ROW_BUCKET)])
    return fn(x)


def _norm(x, scale, eps, plus_one: bool = False):
    if plus_one:  # Gemma: weights parameterize (1 + w)
        scale = 1.0 + scale
    x32 = x.to(torch.float32)
    normed = x32 * torch.rsqrt(
        torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (normed * scale).to(x.dtype)


def _attn_proj(x, proj, shape, blocked: bool = False):
    """Residual rows [M, d_model] x Dense[d_model -> (heads, hd)] ->
    [b, heads, s, hd] for the first b * s rows (`shape` = (b, s)), plus
    the [heads, hd] bias when the config has one."""
    b, s = shape
    w = proj.matrix(x.dtype)   # once a call, before the blocks
    out = _by_blocks(lambda rows: rows @ w, x, blocked)[:b * s]
    out = out.reshape(b, s, *proj.out_shape).permute(0, 2, 1, 3)
    if proj.bias is not None:
        out = out + proj.bias.to(x.dtype)[None, :, None, :]
    return out


def _mlp_weights(mlp, dtype):
    """(gate, up, down) as matrices in `dtype` (int8 kernels dequantized
    here, once a call)."""
    return (mlp.gate_proj.matrix(dtype), mlp.up_proj.matrix(dtype),
            mlp.down_proj.matrix(dtype))


def _mlp(x, mlp, cfg: ModelConfig, weights=None):
    """The dense MLP block on x [..., d]; `weights`: `_mlp_weights`'
    result, made once by a caller that runs the block by rows."""
    w_gate, w_up, w_down = weights or _mlp_weights(mlp, x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    gate = x2 @ w_gate
    up = x2 @ w_up
    act = moe_lib.act_fn(cfg)(gate)
    return (act * up @ w_down).reshape(x.shape)


def _tp_moe_mlp(cfg: ModelConfig, moes, hs, *, capacity: bool = False,
                key=None):
    """Inference MoE (the reference's decode._moe_mlp) over tensor
    ranks: moes[t] is rank t's block (the router replicated, the stacks
    [E, d, f / tp] and [E, f / tp, d]), hs[t] the normed rows x
    [b, s, d] on rank t's device.  Returns [b, s, d] in x's dtype on
    rank 0's device.  The router runs in f32, once a card.  For s > 1
    (a prefill or a verify tick) and with `capacity` (the training
    forward, at every s) the capacity dispatch (`moe.dispatch`) over
    the b * s tokens; each rank's expert products over its stacks
    (`moe.expert_products`), whose partial expert outputs [E, C, d] are
    summed in f32 in rank order and rounded once to cfg.dtype
    (`tensor_parallel.reduce_sum`: where the reference forms expert_out
    in cfg.dtype); then the combine in f32.  For s == 1 the dense
    gather: every expert computed in f32 (the stacks dequantized to
    f32, as the reference's maybe_dequant(stack, f32)), each rank's
    [N, d] partial weighted by [N, E] gates that are zero off the top
    k, the partials summed in f32 in rank order and rounded once to x's
    dtype.  One rank runs the reference's _moe_mlp op for op.  In a
    training step across hosts (`moe.host_dispatch`) the capacity
    dispatch takes these rows' place in the global batch from the
    exchange, under (this block, `key`)."""
    b, s, d = hs[0].shape
    dtype, device = hs[0].dtype, hs[0].device
    dispatched = s > 1 or capacity
    exchange = moe_lib.active_host_dispatch() if capacity else None

    def route(x, moe):
        tokens = x.reshape(b * s, d)
        logits = (tokens.to(torch.float32) @
                  moe.router.kernel.to(torch.float32))
        if dispatched:
            placed = {}
            if exchange is not None:
                _, _, gate_idx = moe_lib.route(logits, cfg.expert_top_k)
                prefix, n_global = exchange.place((moes[0], key), gate_idx,
                                                  cfg.n_experts)
                placed = dict(prefix=prefix, n_global=n_global)
            expert_in, combine, _ = moe_lib.dispatch(tokens, logits, cfg,
                                                     **placed)
            return expert_in, combine
        _, gate_vals, gate_idx = moe_lib.route(logits, cfg.expert_top_k)
        gates = torch.sum(
            F.one_hot(gate_idx, cfg.n_experts).to(torch.float32) *
            gate_vals[..., None], dim=1)                  # [N, E]
        return tokens.to(torch.float32), gates

    routed = tensor_parallel.per_card(route, hs, moes)
    parts = []
    for (xin, gates), moe in zip(routed, moes):
        if dispatched:
            # The reference passes maybe_dequant(stack, f32) on and
            # moe_apply casts it to cfg.dtype; for a float stack the f32
            # copy would round back to the same bits, so it goes in as
            # stored.
            stacks = [moe.stack(name, torch.float32)
                      if isinstance(getattr(moe, name), moe_lib.QuantStack)
                      else getattr(moe, name) for name in moe_lib.STACKS]
            parts.append(moe_lib.expert_products(xin, *stacks, cfg))
            continue
        # [N, d] @ [E, d, f] -> [E, N, f]; one f32 stack alive at a time.
        h = moe_lib.act_fn(cfg)(xin @ moe.stack('gate_proj', torch.float32))
        h = h * (xin @ moe.stack('up_proj', torch.float32))
        out_e = h @ moe.stack('down_proj', torch.float32)     # [E, N, d]
        parts.append(torch.einsum('ne,end->nd', gates, out_e))
    if dispatched:
        out = moe_lib.combine_outputs(
            routed[0][1], tensor_parallel.reduce_sum(parts, device,
                                                     cfg.dtype))
    else:
        out = tensor_parallel.reduce_sum(parts, device, dtype)
    return out.to(dtype).reshape(b, s, d)


def _masked_attention(q, k_cache, v_cache, positions, cfg: ModelConfig):
    """Grouped einsums against a dense cache [b, h_kv, len, d] with a
    per-query-position causal mask (positions [s] or [b, s])."""
    b, h, qs, d = q.shape
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, rep, qs, d).to(torch.float32)
    s = torch.einsum('bgrqd,bgkd->bgrqk', qg,
                     k_cache.to(torch.float32)) * (cfg.head_dim ** -0.5)
    kpos = torch.arange(k_cache.shape[2], device=q.device)
    pos = positions if positions.dim() == 2 else positions[None]
    mask = kpos[None, None, None, None, :] <= pos[:, None, None, :, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bgrqk,bgkd->bgrqd', p, v_cache.to(torch.float32))
    return out.reshape(b, h, qs, d)


def _attn_norm(x, layer, cfg: ModelConfig, blocked: bool):
    return _by_blocks(lambda rows: _norm(rows, layer.attn_norm.scale,
                                         cfg.norm_eps,
                                         cfg.norm_scale_plus_one),
                      x, blocked)


def _attention(q, k_cache, v_cache, positions, cfg: ModelConfig,
               use_flash: bool):
    """q [b, h, s, hd] against a cache that holds this call's k/v: the
    paged kernel for a `_PagedView`, the flash kernel for a prefill
    from index 0, else the masked grouped einsum."""
    if isinstance(k_cache, _PagedView):
        # Paged kernel: query token j of slot b sits at lengths[b] + j.
        return paged_attention_ops.paged_attention(
            q.contiguous(), k_cache.leaf, v_cache.leaf, k_cache.tables,
            k_cache.lengths, sm_scale=cfg.head_dim ** -0.5)
    if use_flash:
        # Prefill from index 0: the valid cache region is [0, s).
        s = q.shape[2]
        return flash_attention(q.contiguous(),
                               k_cache[:, :, :s].contiguous(),
                               v_cache[:, :, :s].contiguous(), causal=True)
    return _masked_attention(q, k_cache, v_cache, positions, cfg)


def _o_proj(out, layer, n_rows: int, dtype, blocked: bool = False):
    """o_proj of the attention output [b, h, s, hd] as n_rows residual
    rows [n_rows, d] (rows past b * s are bucket padding and get
    zeros); a tensor rank's partial of the row-parallel product."""
    b, hq, s, hd = out.shape
    # The masked path's attention output is f32: cast to x's dtype.
    rows = out.permute(0, 2, 1, 3).reshape(b * s, hq * hd).to(dtype)
    if n_rows != b * s:
        padded = rows.new_zeros((n_rows, hq * hd))
        padded[:b * s] = rows
        rows = padded
    w = layer.attn.o_proj.matrix(dtype)
    return _by_blocks(lambda r: r @ w, rows, blocked)


def _embed(cfg: ModelConfig, model, tokens, shards=None):
    """Token embeddings in cfg.dtype.  A TensorParallel model (or its
    `shards`, one per rank) of more than one rank: each rank looks up
    its vocab range masked, and the lookups are summed (exact) on the
    first rank's device."""
    if shards is None:
        shards = (list(model.ranks) if isinstance(model, TensorParallel)
                  else [model])
    if len(shards) == 1:
        x = shards[0].embed.embedding[
            tokens.to(shards[0].device).long()].to(cfg.dtype)
    else:
        vr = shards[0].cfg.vocab_size
        parts = []
        for t, shard in enumerate(shards):
            local = tokens.to(shard.device).long() - t * vr
            hit = (local >= 0) & (local < vr)
            e = shard.embed.embedding[local.clamp(0, vr - 1)].to(cfg.dtype)
            parts.append(e.masked_fill(~hit[..., None], 0))
        x = tensor_parallel.reduce_sum(parts, shards[0].device, cfg.dtype)
    if cfg.scale_embeddings:  # Gemma
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _layer_leaf(leaf, i: int):
    if isinstance(leaf, dict):
        return {'q': leaf['q'][i], 'scale': leaf['scale'][i]}
    return leaf[i]


def _scan_layers_and_unembed(cfg: ModelConfig, model, x, positions,
                             cache_k, cache_v, write_fn, *,
                             use_flash: bool, view_fn=None,
                             all_positions: bool = False,
                             blocked: bool = False):
    """The shared per-layer loop over a model's tensor ranks (a plain
    Transformer is its one rank): each rank projects and rotates its
    q/k/v heads (`_tp_qkv`), writes k/v into its cache leaf with
    `write_fn(layer_leaf, new)` (in place) and attends there; the tail
    of the layer is `_tp_out_and_mlp`; then final-norm + unembed, on
    rank 0's rows, of the last position ([b, V]) or, with
    `all_positions`, of every position ([b, s, V]).  `blocked`: a
    decode tick, whose row-count-following ops run per 64-row block
    past one bucket (`_by_blocks`).  Returns (logits, cache_k,
    cache_v), the caches being the (mutated) inputs."""
    if view_fn is None:
        view_fn = lambda c: c  # noqa: E731
    if isinstance(model, TensorParallel):
        shards, rcfg = list(model.ranks), model.rank_cfg
    else:
        shards, rcfg = [model], cfg
    ks, vs = _rank_leaves(cache_k), _rank_leaves(cache_v)
    devices = [shard.device for shard in shards]
    b, s, d = x.shape
    xs = tensor_parallel.on_cards(_pad_rows(x.reshape(b * s, d)), devices)
    local = _local()
    pos = [local(positions, dev) for dev in devices]
    for i in range(cfg.n_layers):
        layers = [shard.layers[i] for shard in shards]
        outs = []
        for t, (q, k, v) in enumerate(_tp_qkv(rcfg, layers, xs, pos,
                                              (b, s), blocked)):
            k_leaf = _layer_leaf(ks[t], i)
            v_leaf = _layer_leaf(vs[t], i)
            write_fn(k_leaf, k)
            write_fn(v_leaf, v)
            outs.append(_attention(q, view_fn(k_leaf), view_fn(v_leaf),
                                   pos[t], rcfg, use_flash))
        xs = _tp_out_and_mlp(rcfg, layers, xs, outs, blocked)

    kernels = heads.head_kernel(model, cfg)   # once, before the blocks

    def head(rows):
        rows = _norm(rows, shards[0].final_norm.scale, cfg.norm_eps,
                     cfg.norm_scale_plus_one)
        return heads.unembed(rows, model, cfg, kernels)

    x = xs[0]
    if all_positions:
        logits = _by_blocks(head, x, blocked)[:b * s]
        return logits.reshape(b, s, -1), cache_k, cache_v
    x = _pad_rows(x[:b * s].reshape(b, s, d)[:, -1])
    return _by_blocks(head, x, blocked)[:b], cache_k, cache_v


# ------------------------------------------------------ tensor parallel


def _tp_qkv(rcfg: ModelConfig, layers, xs, positions, shape,
            blocked: bool):
    """The rotated q and k and v [b, heads / tp, s, hd] of each tensor
    rank's layer layers[t], from its residual rows xs[t]; the attention
    norm runs once a card.  positions[t]: on rank t's device."""
    hs = tensor_parallel.per_card(
        lambda x, layer: _attn_norm(x, layer, rcfg, blocked), xs, layers)
    out = []
    for h, layer, pos in zip(hs, layers, positions):
        attn = layer.attn
        out.append((_rope(_attn_proj(h, attn.q_proj, shape, blocked), pos,
                          rcfg),
                    _rope(_attn_proj(h, attn.k_proj, shape, blocked), pos,
                          rcfg),
                    _attn_proj(h, attn.v_proj, shape, blocked)))
    return out


def _tp_add(xs, parts):
    """xs[t] + the all-reduced partials, once a card."""
    ys = tensor_parallel.all_reduce(parts, xs[0].dtype)
    return tensor_parallel.per_card(lambda x, y: x + y, xs, ys)


def _tp_attn_out(rcfg: ModelConfig, layers, xs, outs, blocked: bool):
    """The head of a layer's tail over the tensor ranks: each rank's
    o_proj partial of its heads' output outs[t], all-reduced into the
    residual; then the MLP norm once a card.  Returns (the residual
    rows, the normed rows), one entry a rank."""
    xs = _tp_add(xs, [_o_proj(out, layer, x.shape[0], xs[0].dtype, blocked)
                      for x, out, layer in zip(xs, outs, layers)])
    hs = tensor_parallel.per_card(
        lambda x, layer: _by_blocks(lambda r: _norm(
            r, layer.mlp_norm.scale, rcfg.norm_eps,
            rcfg.norm_scale_plus_one), x, blocked), xs, layers)
    return xs, hs


def _tp_out_and_mlp(rcfg: ModelConfig, layers, xs, outs, blocked: bool,
                    capacity: bool = False, key=None):
    """The tail of a layer over the tensor ranks (`_tp_attn_out`), then
    each rank's MLP partial over its d_ff / tp columns, all-reduced; or
    the MoE block over the ranks (`_tp_moe_mlp`; `capacity`: the
    training forward's dispatch at every s, under `key` across hosts),
    whose sum is placed on every rank's device.  `blocked` for a decode
    tick (`_by_blocks`).
    One rank is the plain layer's tail, shared with the training
    forward (`DecoderLayer.forward`)."""
    xs, hs = _tp_attn_out(rcfg, layers, xs, outs, blocked)
    if rcfg.n_experts > 0:
        # The MoE block sees the b * s real rows only, in one call: a pad
        # row would join the capacity dispatch (N, the capacity and the
        # buffer slots are the reference's only over the real tokens).
        # The norm runs on every row, as every other row op does.
        b, _, s, _ = outs[0].shape
        y = _tp_moe_mlp(rcfg, [layer.moe_mlp for layer in layers],
                        [h[:b * s].reshape(b, s, -1) for h in hs],
                        capacity=capacity, key=key).reshape(b * s, -1)
        n_rows = xs[0].shape[0]
        if n_rows != b * s:
            y = torch.cat([y, y.new_zeros((n_rows - b * s, y.shape[1]))])
        return tensor_parallel.per_card(
            lambda x, y: x + y, xs,
            tensor_parallel.on_cards(y, [x.device for x in xs]))
    parts = []
    for h, layer in zip(hs, layers):
        mlp = layer.mlp
        weights = _mlp_weights(mlp, xs[0].dtype)
        parts.append(_by_blocks(
            lambda r, mlp=mlp, weights=weights: _mlp(r, mlp, rcfg, weights),
            h, blocked))
    return _tp_add(xs, parts)


# ----------------------------------------------------------- dense cache


def _kv_leaves(shape, dtype, device, model, placement, fill=0.0):
    """One cache leaf `shape` [L, n, h_kv, ...] of zeros (ones for
    fill=1), or with a TensorParallel `model` one per rank on its
    device, shaped as `placement(model.mesh)` (parallel/sharding.py)
    cuts the leaf for the rank's mesh position: its h_kv / tp kv
    heads."""
    make = torch.zeros if fill == 0.0 else torch.ones
    if isinstance(model, TensorParallel):
        cut = placement(model.mesh)
        full = torch.empty(shape, device='meta')
        return [make(sharding.shard_of(full, cut, model.mesh.position(
            tensor=t)).shape, dtype=dtype, device=dev)
            for t, dev in enumerate(model.devices)]
    return make(shape, dtype=dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = 'cuda', model=None) -> Dict[str, Any]:
    """Zeroed KV cache (per-layer stacked); one leaf per rank of a
    TensorParallel `model`."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {'k': _kv_leaves(shape, cfg.dtype, device, model,
                            sharding.slot_cache_sharding),
            'v': _kv_leaves(shape, cfg.dtype, device, model,
                            sharding.slot_cache_sharding),
            'index': 0}


def _forward_with_cache(cfg: ModelConfig, model, tokens, cache, *,
                        use_flash: bool):
    """Embed tokens at cache['index'], write every layer's k/v there,
    return (last-token logits [b, V], cache advanced by s)."""
    s = tokens.shape[1]
    start = int(cache['index'])
    max_len = _first(cache['k']).shape[3]
    if start + s > max_len:
        raise ValueError(f'cache overflow: index {start} + {s} tokens > '
                         f'max_len {max_len}')
    positions = start + torch.arange(s, device=tokens.device)

    def write(c, new):
        c[:, :, start:start + s] = new.to(c.dtype)

    with torch.no_grad():
        logits, k, v = _scan_layers_and_unembed(
            cfg, model, _embed(cfg, model, tokens), positions,
            cache['k'], cache['v'], write, use_flash=use_flash)
    return logits, {'k': k, 'v': v, 'index': start + s}


def prefill(cfg: ModelConfig, model, tokens, *, max_len: int):
    """Process the prompt [b, s] into a FRESH cache; returns
    (last-token logits [b, V], cache).  Flash-kernel attention (exact
    only from index 0, hence the fresh cache)."""
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device,
                       model=model)
    return _forward_with_cache(cfg, model, tokens, cache, use_flash=True)


def decode_step(cfg: ModelConfig, model, token, cache):
    """One token [b, 1] -> (logits [b, V], cache)."""
    return _forward_with_cache(cfg, model, token, cache, use_flash=False)


def prefill_chunk(cfg: ModelConfig, model, tokens, cache):
    """Continue a prefill at cache['index'] with a chunk [b, c] (masked
    per-position causal path, exact at any index)."""
    return _forward_with_cache(cfg, model, tokens, cache, use_flash=False)


def prefill_sp(cfg: ModelConfig, model, tokens, *, mesh, max_len: int,
               axis_name: str = 'sequence'):
    """Sequence-parallel full-prompt prefill for slice replicas.

    tokens [1, S] (S divisible by the mesh's sequence-axis size sp) ->
    a private prefill cache {'k', 'v': [L, 1, h_kv, max_len, d],
    'index': S}, the layout `prefill` returns, so `insert_prefill` /
    `insert_prefill_pages` adopt it unchanged.  Rank r of the sequence
    axis holds prompt rows [r S/sp, (r + 1) S/sp) on its device and
    runs the embedding, the norms, the projections, RoPE, o_proj and
    the MLP on them (its rows padded to the GPU's row bucket, as every
    forward pads them); attention runs through
    `ops.ring_attention.ring_attention_shards` (B3 per hop).  k/v are
    cached after RoPE, as the chunked path writes them, on the first
    rank's device.

    A plain Transformer runs as a TensorParallel of one rank, and each
    mesh device must be the weights' device (a list that repeats one
    card); its cache leaves are single tensors, as `prefill` returns
    them.  A TensorParallel model (models/tensor_parallel.py) runs over
    the mesh's sequence x tensor positions: position (r, t) runs tensor
    rank t's heads and d_ff columns of sequence rank r's rows on its
    own device, reading the model's shard of rank t there (a copy on
    each further card), with the row-parallel reductions over each
    sequence rank's tensor ranks; the ring runs once per tensor rank
    over its sequence ranks (B3 per hop at h / tp heads).  Its cache
    keeps one leaf per tensor rank, on that rank's (sequence rank 0)
    device.  A TensorParallel of one rank serves a mesh whose sequence
    ranks sit on distinct cards.

    MoE configs are refused: the capacity dispatch couples every prompt
    token, so a sequence split would change which tokens drop.
    """
    if cfg.n_experts > 0:
        raise ValueError('sequence-parallel prefill does not support '
                         'MoE configs (the capacity dispatch couples '
                         'every prompt token)')
    # Imported here as the reference does: the ring is this function's
    # alone.
    from skypilot_tpu_torch.ops import sp_common  # pylint: disable=import-outside-toplevel

    b, s = tokens.shape
    if b != 1:
        raise ValueError(f'prefill_sp serves one sequence, got '
                         f'batch {b}')
    shards = sp_common.sp_partition(mesh, axis_name, s)
    if isinstance(model, TensorParallel):
        return _tp_prefill_sp(cfg, model, tokens, mesh, shards, max_len,
                              axis_name)
    for sh in shards:
        if sh.device != model.device:
            raise ValueError(
                f'prefill_sp: sequence rank {sh.rank} is on {sh.device}, '
                f'the weights on {model.device}; pass the model as a '
                'TensorParallel over the mesh '
                '(convert.to_tensor_parallel), which keeps a copy on '
                'each card')
    cache = _tp_prefill_sp(cfg, TensorParallel(cfg, [model], mesh), tokens,
                           mesh, shards, max_len, axis_name)
    return {'k': cache['k'][0], 'v': cache['v'][0], 'index': s}


def _tp_prefill_sp(cfg: ModelConfig, model: TensorParallel, tokens, mesh,
                   seq, max_len: int, axis_name: str):
    """`prefill_sp` over a TensorParallel model (its docstring)."""
    from skypilot_tpu_torch.ops.ring_attention import ring_attention_shards  # pylint: disable=import-outside-toplevel
    tp = model.tp
    if mesh.shape.get('tensor', 1) != tp:
        raise ValueError(f'prefill_sp: a tensor-{tp} model over a mesh '
                         f'whose tensor axis is {mesh.shape.get("tensor", 1)}')
    rcfg = model.rank_cfg
    # groups[r][t]: rank t's shard on sequence rank r's position.
    groups = [model.group([
        mesh.devices[mesh.position(**{axis_name: sh.rank, 'tensor': t})]
        for t in range(tp)]) for sh in seq]
    n = tokens.shape[1] // len(seq)
    shape = (1, n)
    positions = [[torch.arange(sh.start, sh.stop, device=g.device)
                  for g in group] for sh, group in zip(seq, groups)]
    xs = [tensor_parallel.on_cards(_pad_rows(_embed(
        cfg, model, tokens[:, sh.start:sh.stop], group)[0]),
        [g.device for g in group]) for sh, group in zip(seq, groups)]
    out_shape = (cfg.n_layers, 1, rcfg.n_kv_heads, max_len, cfg.head_dim)
    cache = {name: [torch.zeros(out_shape, dtype=cfg.dtype, device=g.device)
                    for g in groups[0]] for name in ('k', 'v')}
    with torch.no_grad():
        for i in range(cfg.n_layers):
            qkv = [_tp_qkv(rcfg, [g.layers[i] for g in group], x, pos,
                           shape, False)
                   for group, x, pos in zip(groups, xs, positions)]
            outs = [[None] * tp for _ in seq]
            for t in range(tp):
                q, k, v = ([row[t][j].contiguous() for row in qkv]
                           for j in range(3))
                got = ring_attention_shards(
                    q, k, v, [group[t].device for group in groups],
                    causal=True, sm_scale=cfg.head_dim ** -0.5)
                for r, sh in enumerate(seq):
                    outs[r][t] = got[r]
                    # k/v cached post-RoPE, exactly like the chunked write.
                    for name, new in (('k', k[r]), ('v', v[r])):
                        dst = cache[name][t]
                        dst[i, :, :, sh.start:sh.stop] = new.to(dst.device,
                                                                cfg.dtype)
            xs = [_tp_out_and_mlp(rcfg, [g.layers[i] for g in group], x,
                                  out, False)
                  for group, x, out in zip(groups, xs, outs)]
    return {'k': cache['k'], 'v': cache['v'], 'index': tokens.shape[1]}


# ---------------------------------------------------- slot-batched decoding
# The serving engine's dense mode: a fixed pool of slots, each at its
# own depth, decoded together in one step.


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int,
                    device: Any = 'cuda', model=None) -> Dict[str, Any]:
    """Zeroed slot cache: like init_cache, with per-slot lengths (one
    k/v leaf per rank of a TensorParallel `model`; the lengths single,
    on `device`)."""
    shape = (cfg.n_layers, slots, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {'k': _kv_leaves(shape, cfg.dtype, device, model,
                            sharding.slot_cache_sharding),
            'v': _kv_leaves(shape, cfg.dtype, device, model,
                            sharding.slot_cache_sharding),
            'lengths': torch.zeros((slots,), dtype=torch.int32,
                                   device=device)}


def insert_prefill(slot_cache: Dict[str, Any], slot: int,
                   prefill_cache: Dict[str, Any], length) -> Dict[str, Any]:
    """Adopt a single-sequence prefill cache ([L, 1, h_kv, max_len, d])
    into slot `slot` at depth `length` (in place)."""
    for name in ('k', 'v'):
        for dst, src in zip(_rank_leaves(slot_cache[name]),
                            _rank_leaves(prefill_cache[name])):
            dst[:, slot] = src[:, 0].to(dst.dtype)
    slot_cache['lengths'][slot] = int(length)
    return slot_cache


def batched_step(cfg: ModelConfig, model, tokens, slot_cache, active=None):
    """One decode step across ALL slots, each attending its own depth.
    tokens [B, 1]; returns (logits [B, V], slot_cache with new lengths).
    Without `active` every length advances by 1; with `active` [B] bool
    only active slots advance, and inactive slots' writes land at their
    frozen length (garbage the next admission overwrites).  A write at
    a length of max_len or more lands at max_len - 1 of the slot's own
    row, where the reference's dynamic_update_slice clamps it."""
    lengths = slot_cache['lengths']
    positions = lengths.long()[:, None]                       # [B, 1]
    at = torch.clamp(positions[:, 0],
                     max=_first(slot_cache['k']).shape[3] - 1)
    slots = torch.arange(tokens.shape[0], device=tokens.device)
    local = _local()

    def write(c, new):
        # c [B, h_kv, max_len, d], new [B, h_kv, 1, d]: one indexed
        # write puts every slot's token at that slot's own depth.
        c[local(slots, c.device), :, local(at, c.device)] = (
            new[:, :, 0].to(c.dtype))

    with torch.no_grad():
        logits, k, v = _scan_layers_and_unembed(
            cfg, model, _embed(cfg, model, tokens), positions,
            slot_cache['k'], slot_cache['v'], write, use_flash=False,
            blocked=True)
    advance = (torch.ones_like(lengths) if active is None
               else active.to(lengths.dtype))
    return logits, {'k': k, 'v': v, 'lengths': lengths + advance}


def engine_step(cfg: ModelConfig, model, state, slot_cache, *,
                max_top_k: int = 64):
    """A serving tick against the slot cache: decode every active slot,
    select its next token, update the stop bookkeeping.  Inactive slots
    freeze (token, remaining and length unchanged).  Returns
    (new_state, new_cache, finished [B])."""
    return _select_and_bookkeep(state, *batched_step(
        cfg, model, state['tokens'][:, None], slot_cache,
        state['active']), max_top_k=max_top_k)


# -------------------------------------------------------------- sampling

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer on int64 tensors holding values in
    [0, 2^32).  Multipliers stay below 2^31 so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _key_hash(keys: torch.Tensor) -> torch.Tensor:
    """[N, 2] int64 (seed, counter) -> [N, 1] 32-bit row hash."""
    seed, ctr = keys[:, 0:1], keys[:, 1:2]
    h = _mix32(seed & _M32)
    h = _mix32(h ^ ((seed >> 32) & _M32))
    h = _mix32(h ^ (ctr & _M32))
    return _mix32(h ^ ((ctr >> 32) & _M32))


def fold_in(seed: int, data: int) -> int:
    """A new seed derived from (seed, data) (per-row streams)."""
    keys = torch.tensor([[seed, data]], dtype=torch.int64)
    return int(_key_hash(keys)[0, 0])


def split_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys [..., 2] -> (carry, draw): the draw key is the current
    (seed, counter); the carry advances the counter by one."""
    bump = torch.zeros_like(keys)
    bump[..., 1] = 1
    return keys + bump, keys


def _gumbel(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise [N, vocab] f32 from per-row keys [N, 2]."""
    idx = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    h = _mix32(_key_hash(keys) ^ _mix32(idx)[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _sample(logits, keys, temperature: float, *, greedy: bool,
            top_k: int):
    """logits [b, V], keys [b, 2] -> token ids [b]."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        top = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < top, NEG_INF)
    return torch.argmax(logits + _gumbel(keys, logits.shape[-1]), dim=-1)


def generate(cfg: ModelConfig, model, prompt, *, max_new_tokens: int,
             max_len: Optional[int] = None,
             sampling: Optional[SamplingConfig] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy/temperature generation on a dense cache.  prompt [b, s] ->
    (tokens [b, s + max_new_tokens], new tokens [b, max_new_tokens]).
    Row i samples from its own stream fold_in(seed, i)."""
    sampling = sampling or SamplingConfig()
    b, prompt_len = prompt.shape
    max_len = max_len or (prompt_len + max_new_tokens)
    if max_len < prompt_len + max_new_tokens:
        raise ValueError(f'max_len {max_len} < prompt {prompt_len} + '
                         f'new {max_new_tokens}')
    greedy = sampling.temperature <= 0.0
    temperature = max(sampling.temperature, 1e-6)
    seeds = torch.tensor([fold_in(sampling.seed, i) for i in range(b)],
                         dtype=torch.int64, device=prompt.device)

    def keys(t: int) -> torch.Tensor:
        return torch.stack([seeds, torch.full_like(seeds, t)], dim=1)

    logits, cache = prefill(cfg, model, prompt, max_len=max_len)
    token = _sample(logits, keys(0), temperature, greedy=greedy,
                    top_k=sampling.top_k)
    out = [token]
    for t in range(1, max_new_tokens):
        logits, cache = decode_step(cfg, model, token[:, None], cache)
        token = _sample(logits, keys(t), temperature, greedy=greedy,
                        top_k=sampling.top_k)
        out.append(token)
    new = torch.stack(out, dim=1).to(prompt.dtype)
    return torch.cat([prompt, new], dim=1), new


def batched_sample(logits, keys, temperature, top_k, *,
                   max_top_k: int = 64):
    """Per-slot token selection on the device: logits [B, V], keys
    [B, 2], temperature [B] (<= 0: greedy), top_k [B] (0: no filter).
    The top `max_top_k` values are computed once and each slot reads
    its own k-th threshold from that table."""
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    kk = min(max(int(max_top_k), 1), logits.shape[-1])
    topvals = torch.topk(scaled, kk, dim=-1).values          # [B, kk]
    idx = torch.clamp(top_k.long() - 1, 0, kk - 1)[:, None]
    kth = torch.gather(topvals, 1, idx)                      # [B, 1]
    scaled = scaled.masked_fill((top_k[:, None] > 0) & (scaled < kth),
                                NEG_INF)
    sampled = torch.argmax(scaled + _gumbel(keys, logits.shape[-1]),
                           dim=-1)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)


def init_engine_state(slots: int, max_stop_ids: int = 16,
                      device: Any = 'cuda') -> Dict[str, Any]:
    """Device-resident per-slot decode state:

    tokens      [B]    next input token (tick t+1 input IS tick t output)
    active      [B]    slot is decoding (flips off ON DEVICE at stop)
    remaining   [B]    max_new_tokens countdown
    stop_ids    [B,S]  per-slot stop set, -1 padded
    keys        [B,2]  per-slot (seed, counter), split once per token
    temperature [B]    <= 0 -> greedy
    top_k       [B]    0 -> no filtering
    """
    kw = dict(device=device)
    return {
        'tokens': torch.zeros((slots,), dtype=torch.int32, **kw),
        'active': torch.zeros((slots,), dtype=torch.bool, **kw),
        'remaining': torch.zeros((slots,), dtype=torch.int32, **kw),
        'stop_ids': torch.full((slots, max_stop_ids), -1,
                               dtype=torch.int32, **kw),
        'keys': torch.zeros((slots, 2), dtype=torch.int64, **kw),
        'temperature': torch.zeros((slots,), dtype=torch.float32, **kw),
        'top_k': torch.zeros((slots,), dtype=torch.int32, **kw),
    }


def _select_and_bookkeep(state, logits, new_cache, *, max_top_k: int):
    """Shared tick tail: on-device token selection + stop/countdown
    bookkeeping.  Returns (new_state, new_cache, finished [B])."""
    active = state['active']
    carry, draw = split_keys(state['keys'])
    nxt = batched_sample(logits, draw, state['temperature'],
                         state['top_k'], max_top_k=max_top_k)
    nxt = torch.where(active, nxt.to(torch.int32), state['tokens'])
    stopped = torch.any(nxt[:, None] == state['stop_ids'], dim=1)
    remaining = state['remaining'] - active.to(torch.int32)
    finished = active & (stopped | (remaining <= 0))
    new_state = dict(state, tokens=nxt, active=active & ~finished,
                     remaining=remaining, keys=carry)
    return new_state, new_cache, finished


def admit_slot_state(state, slot: int, token: int, max_new_tokens: int,
                     stop_row, key, temperature: float, top_k: int
                     ) -> Dict[str, Any]:
    """One slot's admission written into a NEW state dict (the previous
    tick's state may still await its one-tick-behind host read)."""
    new = {name: t.clone() for name, t in state.items()}
    new['tokens'][slot] = int(token)
    new['active'][slot] = True
    new['remaining'][slot] = int(max_new_tokens)
    new['stop_ids'][slot] = torch.as_tensor(stop_row, dtype=torch.int32)
    new['keys'][slot] = torch.as_tensor(key, dtype=torch.int64)
    new['temperature'][slot] = float(temperature)
    new['top_k'][slot] = int(top_k)
    return new


# ------------------------------------------------------------ paged cache


def _page_size_of(paged: Dict[str, Any]) -> int:
    leaf = _first(paged['k'])
    leaf = leaf['q'] if isinstance(leaf, dict) else leaf
    return leaf.shape[3]


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     slots: int, max_pages_per_slot: int,
                     quantize_kv: bool = False,
                     device: Any = 'cuda', model=None) -> Dict[str, Any]:
    """Zeroed page pool: k/v [L, n_pages, h_kv, ps, d] (int8 {'q',
    'scale'} leaves when quantize_kv); block_tables [B, P] (0 = null
    page); lengths [B].  A TensorParallel `model`: one contiguous pool
    leaf per rank ([L, n_pages, h_kv / tp, ...] on its device); tables
    and lengths single, on `device`."""
    kv_shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
                cfg.head_dim)

    def kv_leaf():
        if quantize_kv:
            q = _kv_leaves(kv_shape, torch.int8, device, model,
                           sharding.page_pool_sharding)
            scale = _kv_leaves(kv_shape[:-1], torch.float32, device,
                               model, sharding.page_scale_sharding, fill=1.0)
            if isinstance(q, list):
                return [{'q': a, 'scale': b} for a, b in zip(q, scale)]
            return {'q': q, 'scale': scale}
        return _kv_leaves(kv_shape, cfg.dtype, device, model,
                          sharding.page_pool_sharding)

    return {
        'k': kv_leaf(),
        'v': kv_leaf(),
        'block_tables': torch.zeros((slots, max_pages_per_slot),
                                    dtype=torch.int32, device=device),
        'lengths': torch.zeros((slots,), dtype=torch.int32, device=device),
    }


def _quant_kv(x):
    """Symmetric absmax int8 over the last (head_dim) axis -> (int8
    values, f32 scales without the last axis); round half to even, like
    the reference, so the pools match byte for byte."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127,
                    127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant_kv(leaf_slice, dtype):
    if isinstance(leaf_slice, dict):
        return (leaf_slice['q'].to(dtype) *
                leaf_slice['scale'].to(dtype)[..., None])
    return leaf_slice.to(dtype)


def _paged_forward(cfg: ModelConfig, model, tokens, paged, *,
                   all_positions: bool = False):
    """Write-then-attend body of a paged tick: tokens [B, S] land at
    positions lengths..lengths+S-1 (scattered in place into the pool),
    then every query attends through the paged kernel.  Lengths are NOT
    advanced (callers own that).  Positions past the slot's table go to
    the null page 0, never clipped onto its last valid page."""
    lengths = paged['lengths']
    tables = paged['block_tables']
    ps = _page_size_of(paged)
    n_rows = tables.shape[1]
    b, s_q = tokens.shape
    positions = (lengths.long()[:, None] +
                 torch.arange(s_q, device=tokens.device)[None, :])
    rows_raw = positions // ps
    in_range = rows_raw < n_rows
    rows = torch.clamp(rows_raw, 0, n_rows - 1)
    pages = torch.where(in_range, torch.gather(tables, 1, rows).long(),
                        torch.zeros_like(rows))
    flat_pages = pages.reshape(-1)
    flat_off = (positions % ps).reshape(-1)
    local = _local()

    def write(c, new):
        # new [B, h_kv, S, d] -> one (page, offset) write per (slot, token).
        tok = new.permute(0, 2, 1, 3).reshape(b * s_q, new.shape[1],
                                              new.shape[3])
        dev = _leaf_device(c)
        at_pages, at_off = local(flat_pages, dev), local(flat_off, dev)
        if isinstance(c, dict):
            q, scale = _quant_kv(tok)
            c['q'][at_pages, :, at_off] = q
            c['scale'][at_pages, :, at_off] = scale
        else:
            c[at_pages, :, at_off] = tok.to(c.dtype)

    def view(c):
        dev = _leaf_device(c)
        return _PagedView(c, local(tables, dev), local(lengths, dev))

    with torch.no_grad():
        return _scan_layers_and_unembed(
            cfg, model, _embed(cfg, model, tokens), positions, paged['k'],
            paged['v'], write, use_flash=False, view_fn=view,
            all_positions=all_positions, blocked=True)


def paged_batched_step(cfg: ModelConfig, model, tokens, paged,
                       active=None):
    """One decode step across all slots against the page pool; returns
    (logits [B, V], paged with lengths advanced for active slots)."""
    logits, new_k, new_v = _paged_forward(cfg, model, tokens, paged)
    lengths = paged['lengths']
    advance = (torch.ones_like(lengths) if active is None
               else active.to(lengths.dtype))
    return logits, dict(paged, k=new_k, v=new_v, lengths=lengths + advance)


def paged_engine_step(cfg: ModelConfig, model, state, paged, *,
                      max_top_k: int = 64):
    """A serving tick against the page pool: decode every active slot,
    select its next token, update the stop bookkeeping.  Returns
    (new_state, new_paged, finished [B])."""
    return _select_and_bookkeep(state, *paged_batched_step(
        cfg, model, state['tokens'][:, None], paged, state['active']),
        max_top_k=max_top_k)


def paged_spec_engine_step(cfg: ModelConfig, model, state, paged, drafts,
                           *, max_top_k: int = 64):
    """Self-speculative verify tick: one forward over [t0, d1..dk] per
    slot (the paged kernel with S = k + 1), then the longest exactly
    matching draft prefix plus the bonus token is emitted.  Token
    selection replays the slot's key stream ONE SPLIT PER EMITTED
    TOKEN, so output equals plain ticking for greedy and seeded
    sampling alike.  Returns (new_state, new_paged, finished [B],
    toks [B, k+1], counts [B])."""
    active = state['active']
    b = drafts.shape[0]
    s_q = drafts.shape[1] + 1
    drafts = drafts.to(torch.int32)
    tokens = torch.cat([state['tokens'][:, None], drafts], dim=1)
    logits, new_k, new_v = _paged_forward(cfg, model, tokens, paged,
                                          all_positions=True)
    # Position j draws with the key a plain tick would use at that
    # step (counter + j); carries[j] is the state after j + 1 splits.
    step = torch.zeros((s_q, 2), dtype=torch.int64, device=tokens.device)
    step[:, 1] = torch.arange(s_q, device=tokens.device)
    draw_keys = state['keys'][:, None, :] + step[None]          # [B, S, 2]
    carries, _ = split_keys(draw_keys)
    vocab = logits.shape[-1]
    toks = batched_sample(
        logits.reshape(b * s_q, vocab), draw_keys.reshape(b * s_q, 2),
        state['temperature'].repeat_interleave(s_q),
        state['top_k'].repeat_interleave(s_q),
        max_top_k=max_top_k).reshape(b, s_q).to(torch.int32)

    match = drafts == toks[:, :-1]
    accepted = torch.cumprod(match.to(torch.int32), dim=1)
    num_accepted = accepted.sum(dim=1)                          # [B]
    is_stop = torch.any(toks[:, :, None] == state['stop_ids'][:, None, :],
                        dim=2)
    stop_i = is_stop.to(torch.int32)
    stops_before = torch.cumsum(stop_i, dim=1) - stop_i
    idx = torch.arange(s_q, device=tokens.device)[None, :]
    emit = ((idx <= num_accepted[:, None]) & (stops_before == 0) &
            (idx < state['remaining'][:, None]) & active[:, None])
    counts = emit.sum(dim=1).to(torch.int32)                    # [B]

    last = torch.clamp(counts.long() - 1, 0, s_q - 1)[:, None]
    nxt = torch.gather(toks, 1, last)[:, 0]
    nxt = torch.where(active, nxt, state['tokens'])
    picked = torch.gather(carries, 1, last[:, :, None].expand(b, 1, 2))
    new_keys = torch.where(active[:, None], picked[:, 0], carries[:, 0])
    remaining = state['remaining'] - counts
    emitted_stop = torch.any(is_stop & emit, dim=1)
    finished = active & (emitted_stop | (remaining <= 0))
    new_state = dict(state, tokens=nxt, active=active & ~finished,
                     remaining=remaining, keys=new_keys)
    new_paged = dict(paged, k=new_k, v=new_v,
                     lengths=paged['lengths'] + counts)
    return new_state, new_paged, finished, toks, counts


def paged_admit_slot(paged, slot: int, pages_row, length: int):
    """Point `slot` at its pages and depth (in place)."""
    paged['block_tables'][slot] = torch.as_tensor(pages_row,
                                                  dtype=torch.int32)
    paged['lengths'][slot] = int(length)
    return paged


def paged_release_slot(paged, slot: int):
    """Park a freed slot's table on the null page BEFORE its pages are
    recycled (in place): a tick already queued may still write at the
    slot's frozen length, and that write must land in garbage."""
    paged['block_tables'][slot] = 0
    paged['lengths'][slot] = 0
    return paged


def _private_as_pages(private_leaf, ps: int):
    """[L, 1, h_kv, T, d] private prefill cache -> [L, T/ps, h_kv, ps, d]
    page-major layout (T a multiple of ps)."""
    l, _, h, t, d = private_leaf.shape
    return private_leaf.reshape(l, h, t // ps, ps, d).permute(0, 2, 1, 3,
                                                              4)


def insert_prefill_pages(paged, private_cache, pages_row, *,
                         first_page: int):
    """Scatter a completed private prefill cache's pages [first_page,
    first_page + len(pages_row)) into pool pages `pages_row` (in
    place; quantizing for int8 pools).  The first_page prefix-cache
    hits already hold identical content and are not rewritten."""
    ps = _page_size_of(paged)
    n = len(pages_row)
    if n == 0:
        return paged
    ids = torch.as_tensor(pages_row, dtype=torch.long,
                          device=_first(private_cache['k']).device)
    local = _local()

    def leaf(pool_leaf, private_leaf):
        piece = _private_as_pages(private_leaf, ps)[
            :, first_page:first_page + n]      # [L, n, h_kv, ps, d]
        at = local(ids, _leaf_device(pool_leaf))
        if isinstance(pool_leaf, dict):
            q, scale = _quant_kv(piece)
            pool_leaf['q'][:, at] = q
            pool_leaf['scale'][:, at] = scale
        else:
            pool_leaf[:, at] = piece.to(pool_leaf.dtype)

    for name in ('k', 'v'):
        for pool_leaf, private_leaf in zip(_rank_leaves(paged[name]),
                                           _rank_leaves(private_cache[name])):
            leaf(pool_leaf, private_leaf)
    return paged


def paged_seed_private(cfg: ModelConfig, paged, pages_row, *,
                       priv_len: int):
    """A private prefill cache whose leading positions are the
    (dequantized) contents of cached pages `pages_row`: the prefix-hit
    admission path continues the prefill from index
    len(pages_row) * page_size.  The pool is only read."""
    ps = _page_size_of(paged)
    r = len(pages_row)
    ids = torch.as_tensor(pages_row, dtype=torch.long,
                          device=_leaf_device(_first(paged['k'])))
    local = _local()

    def leaf(pool_leaf):
        at = local(ids, _leaf_device(pool_leaf))
        if isinstance(pool_leaf, dict):
            arr = _dequant_kv({'q': pool_leaf['q'][:, at],
                               'scale': pool_leaf['scale'][:, at]},
                              cfg.dtype)
        else:
            arr = pool_leaf[:, at]             # [L, r, h_kv, ps, d]
        l, _, h, _, d = arr.shape
        dense = arr.permute(0, 2, 1, 3, 4).reshape(l, 1, h, r * ps, d)
        out = torch.zeros((l, 1, h, priv_len, d), dtype=cfg.dtype,
                          device=arr.device)
        out[:, :, :, :r * ps] = dense.to(cfg.dtype)
        return out

    def leaves(pool):
        if isinstance(pool, list):
            return [leaf(rank) for rank in pool]
        return leaf(pool)

    return {'k': leaves(paged['k']), 'v': leaves(paged['v']),
            'index': r * ps}


def write_pages(paged, k_pages, v_pages, pages_row):
    """Adopt IMPORTED page contents (KV handoff) into pool pages
    `pages_row` (in place).  k_pages / v_pages are float
    [L, n, h_kv, ps, d] (the wire's f32); an int8 pool quantizes them
    with `_quant_kv`, which is round-trip stable, so a quantize ->
    dequantize -> requantize chain reproduces a local prefill's bytes."""
    ids = torch.as_tensor(pages_row, dtype=torch.long,
                          device=_leaf_device(_first(paged['k'])))
    local = _local()

    def leaf(pool_leaf, piece):
        dev = _leaf_device(pool_leaf)
        ids_here = local(ids, dev)
        piece = piece.to(dev)
        if isinstance(pool_leaf, dict):
            q, scale = _quant_kv(piece)
            pool_leaf['q'][:, ids_here] = q
            pool_leaf['scale'][:, ids_here] = scale
        else:
            pool_leaf[:, ids_here] = piece.to(pool_leaf.dtype)

    for name, pages in (('k', k_pages), ('v', v_pages)):
        ranks = _rank_leaves(paged[name])
        for pool_leaf, piece in zip(ranks, _split_heads(pages, len(ranks))):
            leaf(pool_leaf, piece)
    return paged


def write_pages_quantized(paged, k_q, v_q, k_scale, v_scale, pages_row):
    """Adopt ALREADY-QUANTIZED pages into an int8 pool (in place): the
    wire's int8 values and f32 scales land verbatim."""
    ids = torch.as_tensor(pages_row, dtype=torch.long,
                          device=_leaf_device(_first(paged['k'])))
    local = _local()
    for name, q, scale in (('k', k_q, k_scale), ('v', v_q, v_scale)):
        ranks = _rank_leaves(paged[name])
        for leaf, q_t, s_t in zip(ranks, _split_heads(q, len(ranks)),
                                  _split_heads(scale, len(ranks))):
            at = local(ids, leaf['q'].device)
            leaf['q'][:, at] = q_t.to(at.device)
            leaf['scale'][:, at] = s_t.to(at.device)
    return paged


def export_private_pages(private_cache, n_pages: int, page_size: int,
                         quantize: bool = False):
    """A private prefill cache's first `n_pages` FULL pages in the
    wire's page-major layout: (k, v) as f32 [L, n_pages, h_kv, ps, d]
    (exact from bf16), or with `quantize` (k, v, k_scale, v_scale) as
    int8 values and f32 scales from `_quant_kv`, the int8 pool's own
    quantizer."""
    span = n_pages * page_size
    k, v = (_private_as_pages(_join_heads(private_cache[name])[
        :, :, :, :span], page_size) for name in ('k', 'v'))
    if quantize:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        return kq, vq, ks, vs
    return k.to(torch.float32), v.to(torch.float32)


def read_pages(paged, pages_row, quantized: bool):
    """Pool pages `pages_row` in the wire's layout, the ranks' kv heads
    joined in rank order: (k, v) as f32 [L, n, h_kv, ps, d], or for an
    int8 pool (k, v, k_scale, v_scale) as stored."""
    k, v = paged['k'], paged['v']
    dev = _leaf_device(_first(k))
    ids = torch.tensor(list(pages_row), dtype=torch.long, device=dev)
    local = _local()

    def take(leaf, part=None):
        ranks = [(r[part] if part else r)[:, local(ids, _leaf_device(r))]
                 for r in _rank_leaves(leaf)]
        return _join_heads(ranks) if isinstance(leaf, list) else ranks[0]

    if quantized:
        return take(k, 'q'), take(v, 'q'), take(k, 'scale'), take(v, 'scale')
    return take(k).float(), take(v).float()
