"""Mixture-of-Experts layer (mirrors `skypilot_tpu/models/moe.py`).

GShard-style top-k dispatch with a static per-expert capacity: one-hot
dispatch and combine tensors, tokens past an expert's capacity dropped
(their residual path still carries them).  `moe_apply` is the routing
math, shared by the training forward (`DecoderLayer.forward`) and the
decode path's prefill and verify ticks (`decode._tp_moe_mlp`), so it
exists once; every step is the reference's, in the same order and
dtypes:

- router softmax in f32; top-k with the reference's tie order (the
  lower expert index first); gates renormalised over the k chosen;
- capacity = max(1, int(factor * N * k / E)) in Python floats;
- buffer positions from a cumsum over the [N*k, E] one-hot, token-major
  (earlier tokens fill an expert first);
- dispatch / combine [N, E, C] in f32; the expert inputs and stacks
  cast to cfg.dtype for the three expert products; the combine in f32;
- the Switch Transformer load-balancing aux loss (returned; the
  reference's trainer never reads it, so over a host's rows it keeps
  its local form).

Across hosts the dispatch runs over the global batch from a host's
rows: `dispatch(prefix=, n_global=)` offsets each row's local buffer
position by the assignments the earlier hosts' rows made to its
expert (`prefix`, the exclusive sum of their `expert_counts`) and
takes the capacity of the `n_global` tokens of every host, so each
row keeps or drops its assignment as the reference's cumsum over the
global batch decides.  The expert products are row-independent, so a
host's buffer holds its own kept slots alone: expert e's global slots
[prefix_e, prefix_e + kept_e) sit at [0, kept_e) of an [E, W, d]
buffer, W the largest kept_e (at most C), and the host combines its
own rows from it; the other hosts' slots are neither stored nor
multiplied here.  `HostDispatch` is the exchange behind it in a
training step (models/train.py): one all-gather of the counts over
the data group of hosts per MoE block and microbatch, kept for the
remat recompute, which must not gather them again.

Its three parts (`dispatch`, `expert_products`, `combine_outputs`) are
public, so a tensor-parallel layer routes once and runs the expert
products once per rank over the rank's d_ff / tp slice of the stacks.

`MoEMLP` holds the reference tree's leaves: router.kernel [d, E] (f32)
and the raw expert stacks gate_proj / up_proj [E, d, f] and down_proj
[E, f, d], or with int8 weights one `QuantStack` each (per-expert,
per-output-channel scales, models/quantize.py).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.models import quantize as quantize_lib
from skypilot_tpu_torch.models.configs import ModelConfig

STACKS = ('gate_proj', 'up_proj', 'down_proj')


def act_fn(cfg: ModelConfig):
    if cfg.mlp_act == 'silu':
        return F.silu
    if cfg.mlp_act == 'gelu':
        # jax.nn.gelu defaults to the tanh approximation.
        return lambda x: F.gelu(x, approximate='tanh')
    raise ValueError(f'Unknown mlp_act {cfg.mlp_act!r}')


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: the k largest values in
    descending order, equal values in ascending index order (a stable
    descending sort; torch.topk promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_logits: torch.Tensor, k: int):
    """-> (probs [N, E] f32, gates [N, k] renormalised, expert ids
    [N, k])."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return probs, gate_vals, gate_idx


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    return max(1, int(cfg.expert_capacity_factor * n_tokens *
                      cfg.expert_top_k / cfg.n_experts))


def expert_counts(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[E] int64: how many (token, slot) assignments chose each expert
    (gate_idx [N, k], `route`'s expert ids)."""
    return torch.bincount(gate_idx.reshape(-1), minlength=n_experts)


def dispatch(tokens: torch.Tensor, router_logits: torch.Tensor,
             cfg: ModelConfig, *, prefix: Optional[torch.Tensor] = None,
             n_global: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing half of `moe_apply`: tokens [N, d] and router logits
    [N, E] -> (expert inputs [E, C, d] in cfg.dtype, combine weights
    [N, E, C] f32, aux loss scalar).  These rows as a part of a larger
    batch (module docstring): `prefix` [E], the assignments of the rows
    before them, and `n_global`, the whole batch's token count, which
    sets C; with `prefix` the buffer holds these rows' kept slots only
    ([E, W, d] and [N, E, W], expert e's slot j being its global slot
    prefix_e + j)."""
    n_exp, k = cfg.n_experts, cfg.expert_top_k
    n_tokens = tokens.shape[0]
    probs, gate_vals, gate_idx = route(router_logits, k)
    cap = capacity(cfg, n_tokens if n_global is None else n_global)

    # One-hot expert choice per (token, slot) [N, k, E]; each token's
    # buffer position within its expert, over the token-major order.
    choice = F.one_hot(gate_idx, n_exp).to(torch.float32)
    flat = choice.reshape(n_tokens * k, n_exp)
    position = torch.cumsum(flat, dim=0) * flat - 1.0
    if prefix is None:
        in_cap = (position >= 0) & (position < cap)
        width = cap
    else:
        # Global position prefix_e + local < C: the slots left to these
        # rows, which fill them from their buffer's slot 0.
        room = cap - prefix.to(position.device, torch.float32)
        in_cap = (position >= 0) & (position < room)
        width = max(1, int(in_cap.sum(dim=0).max()))
    position = position.reshape(n_tokens, k, n_exp)
    kept = in_cap.reshape(n_tokens, k, n_exp).to(torch.float32)

    # jax.nn.one_hot of a float position: zeros for -1 and past C.
    slots = torch.arange(width, dtype=torch.float32, device=tokens.device)
    pos_onehot = (position[..., None] == slots).to(torch.float32)
    chosen = choice * kept
    placed = pos_onehot * kept[..., None]
    dispatched = torch.einsum('nke,nkec->nec', chosen, placed)
    combine = torch.einsum('nk,nke,nkec->nec', gate_vals, chosen, placed)
    expert_in = torch.einsum('nec,nd->ecd', dispatched,
                             tokens.to(torch.float32)).to(cfg.dtype)

    # Load-balancing auxiliary loss (Switch Transformer eq. 4).
    density = torch.mean(choice[:, 0, :], dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = (torch.sum(density * density_proxy) * n_exp *
           cfg.router_aux_loss_coef)
    return expert_in, combine, aux


def expert_products(expert_in: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The three expert products of `moe_apply` in cfg.dtype: expert
    inputs [E, C, d] -> expert outputs [E, C, d].  Over one tensor
    rank's stacks ([E, d, f / tp] and [E, f / tp, d]) this is the
    rank's partial of the row-parallel down product."""
    act = act_fn(cfg)
    h = act(torch.matmul(expert_in, w_gate.to(cfg.dtype)))
    h = h * torch.matmul(expert_in, w_up.to(cfg.dtype))
    return torch.matmul(h, w_down.to(cfg.dtype))


def combine_outputs(combine: torch.Tensor,
                    expert_out: torch.Tensor) -> torch.Tensor:
    """The combine of `moe_apply` in f32: [N, E, C] x [E, C, d] ->
    [N, d]."""
    return torch.einsum('nec,ecd->nd', combine,
                        expert_out.to(torch.float32))


def moe_apply(tokens: torch.Tensor, router_logits: torch.Tensor,
              w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, cfg: ModelConfig, *,
              prefix: Optional[torch.Tensor] = None,
              n_global: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatched top-k MoE on tokens [N, d] given router
    logits [N, E]; returns (out [N, d] f32, aux loss scalar):
    `dispatch` (with its `prefix` and `n_global`), `expert_products`,
    `combine_outputs`."""
    expert_in, combine, aux = dispatch(tokens, router_logits, cfg,
                                       prefix=prefix, n_global=n_global)
    out = combine_outputs(
        combine, expert_products(expert_in, w_gate, w_up, w_down, cfg))
    return out, aux


def dropped_tokens(router_logits: torch.Tensor, cfg: ModelConfig) -> int:
    """How many (token, expert) assignments `moe_apply` drops for these
    router logits (past their expert's capacity)."""
    _, _, gate_idx = route(router_logits, cfg.expert_top_k)
    counts = torch.bincount(gate_idx.reshape(-1), minlength=cfg.n_experts)
    cap = capacity(cfg, router_logits.shape[0])
    return int(torch.clamp(counts - cap, min=0).sum())


class HostDispatch:
    """Where a host's rows sit in the global token order of each MoE
    dispatch of one training step (module docstring): `place(key,
    gate_idx)` -> (prefix [E], n_global), `key` naming the dispatch
    (its block and microbatch, and its sequence group).  The first call
    for a key all-gathers this host's [E] counts and token count over
    `group` (the hosts that hold the block, in the order of their rows:
    data coordinate major); a second call for the key (the remat
    recompute inside the backward, which autograd may run on a thread
    of its own a device) reuses the first's answer, so the hosts meet
    their collectives in the forward's order alone.  `gathers` counts
    the collectives."""

    def __init__(self, group, host_index: int) -> None:
        self.group = group
        self.host_index = int(host_index)
        self.gathers = 0
        self._placed: Dict[Any, Tuple[torch.Tensor, int]] = {}

    def place(self, key, gate_idx: torch.Tensor, n_experts: int
              ) -> Tuple[torch.Tensor, int]:
        if key not in self._placed:
            from skypilot_tpu_torch.parallel import distributed  # pylint: disable=import-outside-toplevel
            counts = torch.cat([
                expert_counts(gate_idx, n_experts),
                torch.tensor([gate_idx.shape[0]], device=gate_idx.device)])
            every = distributed.all_gather(counts, self.group).cpu()
            self.gathers += 1
            prefix = every[:self.host_index, :-1].sum(dim=0)
            self._placed[key] = (prefix.to(gate_idx.device),
                                 int(every[:, -1].sum()))
        return self._placed[key]


_HOST_DISPATCH: Optional[HostDispatch] = None


@contextlib.contextmanager
def host_dispatch(exchange: Optional[HostDispatch]):
    """Run the block's capacity dispatches inside (a training step's
    forward and backward) over the global batch through `exchange`
    (None: each over the rows it is given)."""
    global _HOST_DISPATCH  # pylint: disable=global-statement
    before, _HOST_DISPATCH = _HOST_DISPATCH, exchange
    try:
        yield exchange
    finally:
        _HOST_DISPATCH = before


def active_host_dispatch() -> Optional[HostDispatch]:
    return _HOST_DISPATCH


class QuantStack(nn.Module):
    """An int8 expert stack: buffers qvalue [E, in, out] (int8) and scale
    [E, 1, out] (f32), the reference tree's {'qvalue', 'scale'} leaf."""

    def __init__(self, shape, *, device) -> None:
        super().__init__()
        self.fan_in = shape[0] * shape[1]
        self.register_buffer('qvalue', torch.empty(
            tuple(shape), dtype=torch.int8, device=device))
        self.register_buffer('scale', torch.empty(
            (shape[0], 1, shape[2]), dtype=torch.float32, device=device))

    def leaf(self):
        return {'qvalue': self.qvalue, 'scale': self.scale}


class MoEMLP(nn.Module):
    """The MoE block's parameters (module docstring); `dense` is the
    float Dense class the router is made of.  The stacks are
    created before the router, so a float and an int8 model list their
    leaves in one order (the seeded init draws them alike)."""

    def __init__(self, cfg: ModelConfig, *, dtype, router_dtype, device,
                 dense, quantized: bool = False) -> None:
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        shapes = {'gate_proj': (e, d, f), 'up_proj': (e, d, f),
                  'down_proj': (e, f, d)}
        for name in STACKS:
            if quantized:
                setattr(self, name, QuantStack(shapes[name], device=device))
            else:
                setattr(self, name, nn.Parameter(
                    torch.empty(shapes[name], dtype=dtype, device=device),
                    requires_grad=False))
        self.router = dense((d,), (e,), dtype=router_dtype, device=device)

    def stack(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Expert stack `name` in `dtype`: the reference's
        maybe_dequant(stack, dtype) (int8 as qvalue * scale in `dtype`)."""
        leaf = getattr(self, name)
        if isinstance(leaf, QuantStack):
            return quantize_lib.dequant(leaf.leaf(), dtype)
        return leaf.to(dtype)

    def tree(self):
        """This block's subtree of the reference tree (the model's own
        tensors)."""
        node = {'router': {'kernel': self.router.kernel}}
        for name in STACKS:
            leaf = getattr(self, name)
            node[name] = (leaf.leaf() if isinstance(leaf, QuantStack)
                          else leaf)
        return node
