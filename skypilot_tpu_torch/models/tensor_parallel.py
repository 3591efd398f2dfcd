"""Tensor-parallel serving models: the 'tensor' mesh axis made explicit.

The reference places its parameters by `LOGICAL_AXIS_RULES`
('heads', 'kv_heads', 'mlp' and 'vocab' on 'tensor') and lets GSPMD
partition the decode.  The port does that work itself.  A
`TensorParallel` is one narrow `Transformer` per tensor rank, built
from `rank_config(cfg, tp)`; rank t holds its slice of every leaf as
`parallel/sharding.Placement.index` cuts it (models/convert.py):

- q_proj columns for heads [t h/tp, (t + 1) h/tp), k/v_proj columns
  for the kv heads of the same range, o_proj rows for the same heads;
- gate/up columns and down rows for d_ff / tp;
- an MoE layer's expert stacks ('expert', 'embed', 'mlp') and
  ('expert', 'mlp', 'embed'): rank t holds gate/up [E, d, f / tp]
  and down [E, f / tp, d], every expert (E is not split); the router
  [d, E] (f32) replicated;
- embedding rows and lm_head columns for vocab / tp;
- norm scales replicated; a q/k/v bias cut with its kernel's heads.

`models/decode.py` runs each rank's narrow layer and joins the ranks
where the reference's collectives sit:

- row-parallel products (o_proj, down_proj): the ranks' partials
  [M, d] summed in f32 in rank order, rounded once to the activation
  dtype, and the sum placed on every rank's device (`all_reduce`, an
  all-reduce by copies; ranks that share a card share one sum);
- the vocab-parallel embedding: each rank looks up its own vocab
  range, masked, and the lookups are summed the same way (exact: one
  rank contributes per token);
- the vocab-parallel head: each rank's logits [rows, V / tp]
  concatenated in rank order on rank 0's device (models/heads.py);
- an MoE block (`decode._tp_moe_mlp`): the routing (router logits in
  f32, softmax, top-k, the capacity dispatch) once a card from the
  replicated normed rows; each rank's expert products over its d_ff /
  tp slice, the down product row-parallel: the ranks' partials (the
  expert outputs [E, C, d] of a dispatch, the gated [N, d] f32 rows of
  a one-token tick) summed as `reduce_sum` sums them.

Devices: the ranks are positions of a mesh (parallel/mesh.py) along
its 'tensor' axis; `ranks[t]` lives on the device of position
(tensor=t) with every other axis at 0.  The list may repeat one card.
A slice's mesh also has a 'sequence' axis: each further card its
positions name gets one copy of the shards its ranks need
(`shard(t, device)`), so a sequence rank on a card of its own reads
its own copy.  A `TensorParallel` of one rank is the degenerate case a
slice whose sequence ranks sit on distinct cards serves.

Training over a mesh with a 'tensor' axis (models/transformer.py's
`mesh_forward`) runs the same layer body under autograd: each tensor
rank's slices are gathered from the sharded state and bound to a
narrow meta model, `reduce_sum` is out of place (autograd hands each
partial the sum's gradient on its own device), and the loss is
vocab-parallel (models/losses.py).

int8 weights are refused at tensor > 1, as the reference refuses them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import Transformer

# The dims the 'tensor' axis splits, with the config field of each.
TENSOR_DIMS = ('n_heads', 'n_kv_heads', 'd_ff', 'vocab_size')


def check_degree(cfg: ModelConfig, tp: int) -> None:
    """Refuse a tensor degree the config's shapes or kind do not take."""
    if tp < 1:
        raise ValueError(f'tensor must be >= 1, got {tp}')
    for dim in TENSOR_DIMS:
        value = getattr(cfg, dim)
        if value % tp:
            raise ValueError(f'tensor={tp} must divide {dim} ({value})')


def rank_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config of one tensor rank's narrow Transformer: heads, kv
    heads, d_ff and vocab divided by tp, the head dim pinned."""
    check_degree(cfg, tp)
    if tp == 1:
        return cfg
    return cfg.replace(n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp,
                       d_ff=cfg.d_ff // tp,
                       vocab_size=cfg.vocab_size // tp,
                       head_dim_override=cfg.head_dim)


def rank_devices(mesh) -> List[torch.device]:
    """The device of each tensor rank: the mesh's positions along
    'tensor', every other axis at 0."""
    return mesh.axis_devices('tensor')


def copy_model(model: Transformer, device) -> Transformer:
    """`model`'s leaves copied onto `device` (one leaf at a time)."""
    out = Transformer(model.cfg, device=device, quantized=model.quantized)
    out.load_state_dict(model.state_dict())
    return out.eval()


class TensorParallel(nn.Module):
    """A serving model over a mesh's 'tensor' axis (module docstring):
    `ranks[t]` the narrow Transformer of rank t, `cfg` the full config,
    `rank_cfg` the ranks' one."""

    def __init__(self, cfg: ModelConfig, ranks: Sequence[Transformer],
                 mesh) -> None:
        super().__init__()
        tp = len(ranks)
        if mesh.shape.get('tensor', 1) != tp:
            raise ValueError(f'{tp} ranks for a mesh whose tensor axis is '
                             f'{mesh.shape.get("tensor", 1)}')
        self.cfg = cfg
        self.rank_cfg = rank_config(cfg, tp)
        self.mesh = mesh
        self.ranks = nn.ModuleList(ranks)
        for t, (rank, dev) in enumerate(zip(ranks, rank_devices(mesh))):
            if rank.cfg != self.rank_cfg or rank.quantized:
                raise ValueError(f'rank {t} is not a float model of the '
                                 f'rank config {self.rank_cfg}')
            if rank.device != dev:
                raise ValueError(f'rank {t} on {rank.device}, its mesh '
                                 f'position on {dev}')
        # One copy of a rank's shard on each further card the mesh's
        # positions name (kept out of `parameters()`).
        self._copies: Dict[Tuple[int, torch.device], Transformer] = {}
        for pos, dev in enumerate(mesh.devices):
            t = mesh.coords(pos).get('tensor', 0)
            if dev != ranks[t].device and (t, dev) not in self._copies:
                self._copies[(t, dev)] = copy_model(ranks[t], dev)

    @property
    def tp(self) -> int:
        return len(self.ranks)

    @property
    def device(self) -> torch.device:
        return self.ranks[0].device

    @property
    def devices(self) -> List[torch.device]:
        return [rank.device for rank in self.ranks]

    @property
    def quantized(self) -> bool:
        return False

    def layout(self) -> Tuple[int, Tuple[torch.device, ...]]:
        """(tp, every mesh position's device): two models of one layout
        hold their shards alike."""
        return mesh_layout(self.mesh)

    def shard(self, t: int, device) -> Transformer:
        """Rank t's shard on `device` (a card the mesh names)."""
        device = torch.device(device)
        if self.ranks[t].device == device:
            return self.ranks[t]
        return self._copies[(t, device)]

    def group(self, devices: Sequence[torch.device]) -> List[Transformer]:
        """The shards of a row of tensor ranks on `devices`."""
        return [self.shard(t, d) for t, d in enumerate(devices)]

    def n_elements(self) -> int:
        """Elements of the unsharded tree: every rank's slices, the
        replicated leaves (norm scales) once."""
        total = 0
        for t, rank in enumerate(self.ranks):
            for name, p in rank.named_parameters():
                if t == 0 or not name.endswith('norm.scale'):
                    total += p.numel()
        return total


def degree(model) -> int:
    """A model's tensor degree (1 for a plain Transformer)."""
    return model.tp if isinstance(model, TensorParallel) else 1


def layout(model) -> Optional[Tuple[int, Tuple[torch.device, ...]]]:
    """A TensorParallel's layout; None for a plain Transformer."""
    return model.layout() if isinstance(model, TensorParallel) else None


def mesh_layout(mesh) -> Tuple[int, Tuple[torch.device, ...]]:
    """The layout a TensorParallel over `mesh` has."""
    return int(mesh.shape.get('tensor', 1)), tuple(mesh.devices)


def cards(model) -> List[torch.device]:
    """The distinct devices that hold a model's weights."""
    if isinstance(model, TensorParallel):
        return model.mesh.distinct_devices()
    return [model.device]


def needs_ranks(mesh, device, cfg: ModelConfig) -> bool:
    """Whether a mesh needs a TensorParallel model: a tensor axis above
    1, or a position on another card than the weights' `device`.  An
    MoE model takes ranks for a tensor axis only: a slice runs no SP
    prefill for it, so no sequence rank reads its weights on another
    card."""
    if mesh.shape.get('tensor', 1) > 1:
        return True
    return cfg.n_experts == 0 and any(d != torch.device(device)
                                      for d in mesh.devices)


def reduce_sum(parts: Sequence[torch.Tensor], device,
               dtype: torch.dtype) -> torch.Tensor:
    """The sum of the ranks' partials on `device`: f32 adds in rank
    order, rounded once to `dtype`.  One partial is returned as it is.
    Out of place, so the partials keep their values (a partial already
    f32 on `device` is its own `.to`) and autograd hands each partial
    the sum's gradient on its own device."""
    if len(parts) == 1:
        return parts[0]
    acc = parts[0].to(device=device, dtype=torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc.to(dtype)


def on_cards(x: torch.Tensor, devices: Sequence[torch.device]
             ) -> List[torch.Tensor]:
    """x on each of `devices`, one copy per card (entries that name one
    card share it; x itself where it lies)."""
    copies = {x.device: x}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d)
        out.append(copies[d])
    return out


def all_reduce(parts: Sequence[torch.Tensor], dtype: torch.dtype
               ) -> List[torch.Tensor]:
    """The row-parallel reduction: `reduce_sum` on rank 0's device,
    then placed on every rank's device (`on_cards`)."""
    devices = [p.device for p in parts]
    return on_cards(reduce_sum(parts, devices[0], dtype), devices)


def per_card(fn, *lists):
    """[fn(*args) for args in zip(*lists)], computed once per card: the
    first list's entries name the card, and ranks that share one reuse
    the first rank's result there."""
    seen: Dict[torch.device, object] = {}
    out = []
    for args in zip(*lists):
        dev = args[0].device
        if dev not in seen:
            seen[dev] = fn(*args)
        out.append(seen[dev])
    return out
