"""Training step for the model family (mirrors
`skypilot_tpu/models/train.py`).

The reference jit-compiles a sharded step over an optax chain; the port
runs eagerly: `create_train_state` builds a trainable `Transformer` (f32
master parameters, cfg.dtype compute) and an AdamW optimizer, and
`train_step` takes one optimizer step.  Unlike the reference's pure
step, `train_step` UPDATES THE STATE IN PLACE (the parameters, the
optimizer's moments, the step count) and returns the same object, so
the f32 state never exists twice on the card.

Meshes (`create_train_state(mesh=)`, parallel/mesh.py): every leaf and
both AdamW moments are split over the mesh axes that the reference's
logical-axis rules give its dims (`transformer.ShardedParams`: 'embed'
over 'fsdp'; 'heads', 'kv_heads', 'mlp' and 'vocab' over 'tensor';
replicated over 'data' and 'sequence').  Each distinct block has a copy
on every distinct device entry of the mesh that holds it
(`sharding.Placement.holders`: a list that repeats one card keeps one
copy, four cards keep four), and each position reads its own entry's
copies, or the owner's (the first holder's) where its entry holds
none.  The step
(`make_train_step`, the counterpart of `jit_train_step`) runs each
batch rank's rows on its own devices (`transformer.mesh_forward`; a
tensor rank gathers only its slice of each leaf and the row-parallel
partials are summed across the tensor ranks), sums the NLL of every
(batch, sequence) rank once over the global denominator (the fused CE
vocab-parallel over the tensor ranks' head columns) and backpropagates
once: autograd turns each layer's weight gather into a sum of the
gradient slices into each copy's `.grad`, and the step sums each
block's copies into the owner's, in f32 in holder order (the
reduce-scatter, and over 'data' the all-reduce, that GSPMD inserts).
The clip takes the global norm over the owners (each element once),
the clipped gradient is copied back to the other copies, and AdamW
steps every copy elementwise: every copy holds the same bits after the
step, as every device holds the same bits in the reference, with no
broadcast of the parameters (`check_copies`).  A mesh of one position is the
unsharded state on its device.  `abstract_train_state` builds the same
layout on the 'meta' device, for `data.checkpoints.restore_sharded`.

Attention's gradient runs the flash backward kernels (ops/attention.py)
on CUDA tensors; the loss is `loss_fn` or, with `fused_ce`, the fused
linear + CE of models/losses.py; each layer is rematerialised per
cfg.remat / cfg.remat_policy (models/transformer.py).

Checkpoints: `snapshot` turns a TrainState into host copies of its
leaves (the params, the AdamW moments by tree path, the optimizer's
count, the step) for data/checkpoints.py to write, `load_train_step`
puts a saved step back in place, and `load_pretrained_params` starts a
finetune from a params-only checkpoint (an import) with fresh moments.

A sharded state reads and writes the same step files (whole leaves,
gathered to the host from the owners): either kind restores onto any
mesh, and a restore fills every copy (`fill_copies`).

Across hosts (a mesh with `hosts` > 1, parallel/mesh.py): each host
passes its stripe of the global batch, in host-rank order, and the step
all-gathers the stripes (token ids and the mask) and takes the rows
its positions hold in the reference's order, microbatch major
(`pipeline.microbatch_rows` over every host's batch ranks), so the
accumulation microbatches are the reference's global row ranges.  The
denominator (the token count or mask sum of each stripe) is summed
over every host before the backward.  Each host runs the step above on
its own mesh: its stages of a pipeline across hosts (parallel/
pipeline.py: the boundaries sent host to host, the backward driven
host by host), and an MoE block dispatches over the global batch
(`moe.HostDispatch`: one all-gather of the expert counts over the data
group of hosts per block and microbatch).  Then `state.host_reduce`
sums, before the clip, each layer's gradient (its owner, after the
copies' sum) over the data group (the hosts that hold its stage), and
the loss (the last stage's) and the embedding's, final norm's and
head's gradients over every host, where a tied embedding's two stages
meet.  The clip's norm adds each host's layers' squares over its
pipeline group and the end blocks once, so every host steps the same
bits.  Each host sums its own positions first (autograd onto its
blocks), then the hosts: the reference's GSPMD sums in an order of its
own.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import losses
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models import transformer as transformer_lib
from skypilot_tpu_torch.models.transformer import ShardedParams
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel.mesh import Mesh
from skypilot_tpu_torch.utils import safetensors_io


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # Fused linear + CE (models/losses.py): the forward returns the
    # final hidden states and the lm-head kernel and the loss computes
    # vocab chunks on the fly, so the [b, s, V] logits never exist.
    fused_ce: bool = False
    # Vocab chunk width for the fused CE.
    vocab_chunk: int = 8192
    # Microbatch gradient accumulation: the batch is split into
    # accum_steps microbatches whose SUMMED NLL gradients accumulate and
    # are normalised by the full batch's denominator, so accum_steps=k
    # matches one big batch while activations stay at one microbatch.
    accum_steps: int = 1


@dataclasses.dataclass
class TrainState:
    """step, the trainable model and its optimizer (updated in place by
    `train_step`), and the global-norm clip that precedes the optimizer,
    fixed when the state is made as the reference's chain fixes it.
    Over a mesh of several positions, `shards` holds the parameters'
    blocks (every copy is an optimizer tensor) and `model` lives on
    'meta'.  On a mesh that spans hosts, `host_reduce` sums each step
    over them."""
    step: int
    model: Transformer
    optimizer: torch.optim.Optimizer
    grad_clip: float
    shards: Optional[ShardedParams] = None
    host_reduce: Optional[distributed.HostReduction] = None

    def parameters(self) -> List[torch.Tensor]:
        """The tensors the optimizer steps: the model's parameters, or
        every copy of every block over a mesh."""
        if self.shards is not None:
            return self.shards.parameters()
        return list(self.model.parameters())

    def owners(self) -> List[torch.Tensor]:
        """The tensors that hold each element once: the model's
        parameters, or each block's owner copy over a mesh."""
        if self.shards is not None:
            return self.shards.owner_parameters()
        return list(self.model.parameters())


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         g_norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g_norm is the square root of
    the sum of squares over every element (optax's global_norm; given,
    where the gradients lie on several hosts), and every gradient is
    scaled by max_norm / g_norm when g_norm >= max_norm (no epsilon,
    unlike torch's clip_grad_norm_).  Returns the pre-clip g_norm, a
    0-dim f32 tensor on the device (no host sync)."""
    dev = grads[0].device
    if g_norm is None:
        g_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.to(torch.float32)).to(dev)
             for g in grads]))
    scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
    for g in grads:
        g.mul_(scale.to(g.device, g.dtype))
    return g_norm


def make_optimizer(params, tcfg: TrainConfig) -> torch.optim.AdamW:
    """The update half of the reference chain
    `optax.chain(clip_by_global_norm(grad_clip), adamw(...))`, whose
    clip `train_step` applies first (`clip_by_global_norm_`).  torch's
    AdamW with eps 1e-8 has optax.adamw's numerics: bias-corrected
    moments, m_hat / (sqrt(v_hat) + eps), and decoupled weight decay
    lr * wd * p on every leaf (optax's default mask)."""
    return torch.optim.AdamW(params, lr=tcfg.learning_rate,
                             betas=(tcfg.b1, tcfg.b2), eps=1e-8,
                             weight_decay=tcfg.weight_decay)


def loss_fn(logits, targets, mask=None, reduction: str = 'mean'):
    """Next-token cross entropy; logits [b, s, V], targets [b, s].  The
    full f32 log-softmax (the fused path in models/losses.py is pinned
    against it); 'sum' returns the raw summed NLL."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is not None:
        ll = ll * mask
    if reduction == 'sum':
        return -ll.sum()
    if mask is None:
        return -ll.mean()
    return -ll.sum() / torch.clamp(mask.sum(), min=1)


def _host_reduction(mesh: Optional[Mesh]
                    ) -> Optional[distributed.HostReduction]:
    """The cross-host sums of a mesh that spans hosts (None on one)."""
    if mesh is None or mesh.hosts <= 1:
        return None
    return distributed.HostReduction(mesh.host_grid, mesh.host_rank)


def _one_position(mesh: Mesh) -> bool:
    """A mesh whose state is the unsharded model on its one device: one
    position, which holds every layer."""
    return mesh.size == 1 and transformer_lib.global_stages(mesh) == 1


def _stages_span_hosts(state: TrainState) -> bool:
    return (state.host_reduce is not None and
            state.host_reduce.grid[1] > 1)


def create_train_state(cfg: ModelConfig,
                       tcfg: Optional[TrainConfig] = None, *,
                       mesh: Optional[Mesh] = None,
                       device: Union[str, torch.device] = 'cuda',
                       seed: int = 0) -> Tuple[TrainState, Optional[dict]]:
    """-> (state, shardings): seeded trainable parameters on `device`,
    and None where the reference returns its shardings; or over `mesh`
    (its devices; `device` is not used), with {parameter name:
    sharding.Placement}.  The blocks gathered are bit-equal to the
    mesh=None state of the same seed on the mesh's first device, and no
    device ever holds more than one full leaf at a time."""
    tcfg = tcfg or TrainConfig()
    host_reduce = _host_reduction(mesh)
    if mesh is None or _one_position(mesh):
        dev = resolve_device(device if mesh is None else mesh.devices[0])
        model = init_params(cfg, seed=seed, device=dev, trainable=True)
        shardings = (None if mesh is None else
                     transformer_lib.placements(model, mesh))
        return TrainState(step=0, model=model,
                          optimizer=make_optimizer(model.parameters(), tcfg),
                          grad_clip=tcfg.grad_clip,
                          host_reduce=host_reduce), shardings
    transformer_lib.check_mesh(mesh, cfg)
    for dev in mesh.distinct_devices():
        resolve_device(dev)
    model = Transformer(cfg, device='meta', trainable=True)
    shards = ShardedParams.init(model, mesh, seed)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(shards.parameters(), tcfg),
                      grad_clip=tcfg.grad_clip, shards=shards,
                      host_reduce=host_reduce), dict(shards.placements)


def abstract_train_state(cfg: ModelConfig,
                         tcfg: Optional[TrainConfig] = None, *,
                         mesh: Mesh) -> Tuple[TrainState, dict]:
    """-> (abstract state, shardings) on `mesh` without materialising
    anything: the state's tensors live on the 'meta' device, laid out
    as `create_train_state(mesh=)` lays them out.  The elastic entry
    point: `data.checkpoints.restore_sharded` puts a checkpoint onto
    these shardings."""
    tcfg = tcfg or TrainConfig()
    host_reduce = _host_reduction(mesh)
    transformer_lib.check_mesh(mesh, cfg)
    model = Transformer(cfg, device='meta', trainable=True)
    shards = ShardedParams.empty(model, mesh, device='meta')
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(shards.parameters(), tcfg),
                      grad_clip=tcfg.grad_clip, shards=shards,
                      host_reduce=host_reduce), dict(shards.placements)


def materialize(abstract: TrainState, shardings: dict) -> TrainState:
    """An uninitialised state with the layout of `shardings` (from
    `abstract_train_state` or `create_train_state`), with `abstract`'s
    config and optimizer settings: the whole model on the device of a
    one-position mesh, else every block's copies on their holders."""
    mesh = next(iter(shardings.values())).mesh
    cfg = abstract.model.cfg
    opt = abstract.optimizer
    if _one_position(mesh):
        model = Transformer(cfg, device=resolve_device(mesh.devices[0]),
                            trainable=True)
        params, shards = list(model.parameters()), None
    else:
        for dev in mesh.distinct_devices():
            resolve_device(dev)
        model = Transformer(cfg, device='meta', trainable=True)
        shards = ShardedParams.empty(model, mesh)
        params = shards.parameters()
    settings = {k: opt.defaults[k] for k in ('lr', 'betas', 'eps',
                                               'weight_decay')}
    return TrainState(step=0, model=model,
                      optimizer=torch.optim.AdamW(params, **settings),
                      grad_clip=abstract.grad_clip, shards=shards,
                      host_reduce=_host_reduction(mesh))


def _microbatch_nll(model, inputs, targets, mask, tcfg: TrainConfig,
                    microbatch: int = 0):
    """Summed (unnormalised) NLL of accumulation microbatch
    `microbatch`."""
    if tcfg.fused_ce:
        hidden, kernel = model(inputs, return_hidden=True,
                               microbatch=microbatch)
        return losses.fused_linear_cross_entropy(
            hidden, kernel, targets, mask, vocab_chunk=tcfg.vocab_chunk,
            reduction='sum')
    return loss_fn(model(inputs, microbatch=microbatch), targets, mask,
                   reduction='sum')


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               tcfg: Optional[TrainConfig] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step, in place.  batch = {'tokens': [b, s + 1]} or
    {'inputs', 'targets'} (+ optional 'mask').  With a TrainConfig,
    fused_ce routes the loss through models/losses.py and accum_steps > 1
    accumulates summed-NLL gradients over microbatches, normalised by
    the full batch's denominator.  Metrics: 'loss' and 'grad_norm'
    (before clipping), 0-dim tensors on the device."""
    loss = value_and_grad(state, batch, tcfg)
    grads = [p.grad for p in state.owners() if p.grad is not None]
    grad_norm = clip_by_global_norm_(grads, state.grad_clip,
                                     _host_norm(state, grads[0].device))
    if state.shards is not None:
        state.shards.copy_owner_grads()
    state.optimizer.step()
    state.step += 1
    return state, {'loss': loss.detach(), 'grad_norm': grad_norm}


def value_and_grad(state: TrainState, batch: Dict[str, torch.Tensor],
                   tcfg: Optional[TrainConfig] = None) -> torch.Tensor:
    """`train_step` without the clip and the update: the step's loss,
    with the gradient of every parameter (over a mesh, of every block,
    summed over its copies into the owner's; the other copies' dropped)
    left in its `.grad`, zeroed first; across hosts both are the global
    ones, the same on every host."""
    if state.shards is not None:
        loss = _mesh_value_and_grad(state, batch, tcfg)
    else:
        loss = _plain_value_and_grad(state, batch, tcfg)
    if state.host_reduce is None:
        return loss
    loss = loss.detach().clone()
    _host_sums(state, loss)
    return loss


def _owner_groups(state: TrainState
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(the layers' owner blocks, the embedding's, final norm's and
    head's) of a sharded state."""
    layers, ends = [], []
    for name, blocks in state.shards.blocks.items():
        (layers if name.startswith('layers.') else ends).extend(
            blocks.values())
    return layers, ends


@torch.no_grad()
def _host_sums(state: TrainState, loss: torch.Tensor) -> None:
    """The step's sums across hosts (module docstring): without a
    pipeline across hosts the loss and every gradient over every host;
    with one, the layers' over the data group, the loss and the end
    blocks' (zeros where this host's stages made none) over every
    host."""
    reduce = state.host_reduce
    if not _stages_span_hosts(state):
        reduce([loss] + [p.grad for p in state.owners()
                         if p.grad is not None])
        return
    layers, ends = _owner_groups(state)
    for p in ends:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    reduce([p.grad for p in layers if p.grad is not None], over='data')
    reduce([loss] + [p.grad for p in ends])


@torch.no_grad()
def _host_norm(state: TrainState, dev) -> Optional[torch.Tensor]:
    """The global gradient norm where a pipeline spans hosts (None
    elsewhere): the squares of this host's layers summed over its
    pipeline group, plus the end blocks' once."""
    if not _stages_span_hosts(state):
        return None

    def squares(params) -> torch.Tensor:
        total = torch.zeros(1, device=dev)
        for p in params:
            if p.grad is not None:
                total += torch.linalg.vector_norm(
                    p.grad.to(torch.float32)).to(dev) ** 2
        return total
    layers, ends = _owner_groups(state)
    layer_sq = squares(layers)
    state.host_reduce([layer_sq], over='pipeline')
    return torch.sqrt(layer_sq + squares(ends))[0]


def _host_dispatch(state: TrainState) -> Optional[moe_lib.HostDispatch]:
    """A step's MoE exchange over the data group (None on one host or
    for a dense model)."""
    reduce = state.host_reduce
    if reduce is None or state.model.cfg.n_experts == 0:
        return None
    return moe_lib.HostDispatch(reduce.group('data'),
                                reduce.host // reduce.grid[1])


def _denominator(state: TrainState, count: torch.Tensor) -> torch.Tensor:
    """clamp(count, 1) as f32, `count` (the token count or the mask
    sum) summed over the hosts first where the state spans them."""
    count = count.to(torch.float32)
    if state.host_reduce is not None:
        count = count.clone()
        state.host_reduce([count])
    return torch.clamp(count, min=1)


def _joined(x) -> torch.Tensor:
    """A batch array given as row blocks (one a batch rank), joined."""
    if isinstance(x, (list, tuple)):
        return x[0] if len(x) == 1 else torch.cat(
            [t.to(x[0].device) for t in x])
    return x


def _global_batch(state: TrainState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """({'inputs', 'targets'[, 'mask']} of the global batch, the
    denominator): this host's stripe (its row blocks joined), every
    host's stripe all-gathered in host order across hosts; the
    denominator is the stripes' token count or mask sum, summed over
    the hosts."""
    if 'tokens' in batch:
        arrays = {'tokens': _joined(batch['tokens'])}
        targets = arrays['tokens'][:, 1:]
    else:
        arrays = {k: _joined(batch[k]) for k in ('inputs', 'targets')}
        targets = arrays['targets']
    if batch.get('mask') is not None:
        arrays['mask'] = _joined(batch['mask'])
    denom = _denominator(state, torch.tensor(
        float(targets.numel()), device=targets.device)
        if 'mask' not in arrays else arrays['mask'].sum())
    if state.host_reduce is not None:
        arrays = {k: distributed.all_gather(v).reshape(-1, *v.shape[1:])
                  for k, v in arrays.items()}
    if 'tokens' in arrays:
        toks = arrays.pop('tokens')
        arrays['inputs'], arrays['targets'] = toks[:, :-1], toks[:, 1:]
    return arrays, denom


def _plain_value_and_grad(state: TrainState, batch,
                          tcfg: Optional[TrainConfig]) -> torch.Tensor:
    """`value_and_grad` of an unsharded state."""
    # A one-position mesh's batch: its one shard.
    batch = {k: v[0] if isinstance(v, (list, tuple)) else v
             for k, v in batch.items()}
    if 'tokens' in batch:
        inputs = batch['tokens'][:, :-1]
        targets = batch['tokens'][:, 1:]
    else:
        inputs, targets = batch['inputs'], batch['targets']
    mask = batch.get('mask')
    model = state.model
    state.optimizer.zero_grad(set_to_none=True)

    if state.host_reduce is None and (
            tcfg is None or (not tcfg.fused_ce and tcfg.accum_steps <= 1)):
        loss = loss_fn(model(inputs), targets, mask)
        loss.backward()
        return loss
    from skypilot_tpu_torch.parallel import pipeline  # pylint: disable=import-outside-toplevel
    tcfg = tcfg or TrainConfig()
    accum = max(tcfg.accum_steps, 1)
    whole, denom = _global_batch(state, batch)
    reduce = state.host_reduce
    if reduce is not None:
        # This host's rows of each global microbatch, microbatch major.
        whole = {k: pipeline.microbatch_rows(v, reduce.grid[0], accum)[
            reduce.host] for k, v in whole.items()}
    b = whole['inputs'].shape[0]
    if b % accum:
        raise ValueError(f'batch size {b} not divisible by accum_steps '
                         f'{accum}')
    mb = b // accum
    nll = torch.zeros((), device=whole['inputs'].device)
    with moe_lib.host_dispatch(_host_dispatch(state)):
        for i in range(accum):
            rows = {k: v[i * mb:(i + 1) * mb] for k, v in whole.items()}
            part = _microbatch_nll(model, rows['inputs'], rows['targets'],
                                   rows.get('mask'), tcfg, i)
            part.backward()
            nll = nll + part.detach()
    loss = nll / denom.to(nll.device)
    _divide_grads(state, denom)
    return loss


def _rank_rows(x, geo, mesh: Mesh) -> List[torch.Tensor]:
    """A batch array as one row block per batch rank, each on the rank's
    first device (`token_batch_sharding`: rows split over 'data' x
    'fsdp'); a list is taken as those blocks already."""
    devs = [mesh.devices[rank[0][0]] for rank in geo.ranks]
    if isinstance(x, (list, tuple)):
        if len(x) != len(devs):
            raise ValueError(f'{len(x)} batch shards for {len(devs)} batch '
                             'ranks')
        return [t.to(dev) for t, dev in zip(x, devs)]
    if x.shape[0] % len(devs):
        raise ValueError(f'batch size {x.shape[0]} not divisible by the '
                         f'{len(devs)} batch ranks of the mesh')
    n = x.shape[0] // len(devs)
    return [x[i * n:(i + 1) * n].to(dev) for i, dev in enumerate(devs)]


def _position_cols(xs: List[torch.Tensor], geo, mesh: Mesh
                   ) -> List[torch.Tensor]:
    """Per-rank [b_i, s] blocks -> each (batch, sequence) rank's columns
    (its sequence rank's chunk), on the last pipeline stage's tensor
    rank 0 device, batch rank major: `mesh_forward`'s outputs, one a
    row of tensor ranks, so each target's NLL counts once."""
    chunk = xs[0].shape[1] // geo.sp
    return [x[:, r * chunk:(r + 1) * chunk].to(mesh.devices[row[0]])
            for x, rank in zip(xs, geo.stages[-1])
            for r, row in enumerate(rank)]


def _sum_to(parts: List[torch.Tensor], device) -> torch.Tensor:
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def mesh_nll(model: Transformer, shards: ShardedParams, part,
             tcfg: Optional[TrainConfig], num_microbatches: int = 1,
             microbatch: int = 0) -> torch.Tensor:
    """Summed NLL of one batch over a mesh ({'inputs', 'targets'[,
    'mask']}: one row block a batch rank, `_rank_rows`), on the mesh's
    first device; the fused CE with tcfg.fused_ce.  Over a pipeline the
    blocks are microbatch major (`pipeline.microbatch_rows`); None on a
    host of a pipeline across hosts that does not hold its last
    stage.  `microbatch`: which accumulation microbatch the rows are
    (`Transformer.forward`)."""
    mesh = shards.mesh
    geo = transformer_lib.mesh_geometry(mesh, model.cfg)
    targets = _position_cols(part['targets'], geo, mesh)
    mask = (None if part.get('mask') is None else
            _position_cols(part['mask'], geo, mesh))
    fused = tcfg is not None and tcfg.fused_ce
    outs = model(part['inputs'], return_hidden=fused, shards=shards,
                 num_microbatches=num_microbatches, microbatch=microbatch)
    if outs is None:    # the last stage is another host's
        return None
    sums = []
    for i, (out, t) in enumerate(zip(outs, targets)):
        m = None if mask is None else mask[i]
        if fused:
            sums.append(losses.fused_linear_cross_entropy(
                out[0], out[1], t, m, vocab_chunk=tcfg.vocab_chunk,
                reduction='sum'))
        else:
            sums.append(loss_fn(out, t, m, reduction='sum'))
    return _sum_to(sums, mesh.devices[0])


def _host_blocks(x: torch.Tensor, mesh: Mesh, n_ranks: int,
                 num_microbatches: int) -> List[torch.Tensor]:
    """This host's `n_ranks` batch ranks' rows of the global batch x,
    microbatch major: `pipeline.microbatch_rows` over every host's
    batch ranks ('data' x 'fsdp', data major)."""
    from skypilot_tpu_torch.parallel import pipeline  # pylint: disable=import-outside-toplevel
    fsdp = mesh.shape.get('fsdp', 1)
    first = mesh.offsets['data'] * fsdp
    every = pipeline.microbatch_rows(
        x, mesh.global_shape.get('data', 1) * fsdp, num_microbatches)
    return every[first:first + n_ranks]


def _mesh_value_and_grad(state: TrainState, batch,
                         tcfg: Optional[TrainConfig]) -> torch.Tensor:
    """`value_and_grad` over a mesh (module docstring): batch arrays are
    global tensors or one row block per batch rank (`prefetch_to_device
    (sharding=)`); accum_steps microbatches are the global batch's
    consecutive row ranges, each split over the batch ranks, as the
    reference's reshape of the global batch cuts them.  Over a pipeline
    they are the GPipe schedule's microbatches: one forward over all of
    them and one backward (across hosts, driven host by host)."""
    from skypilot_tpu_torch.parallel import pipeline  # pylint: disable=import-outside-toplevel
    shards = state.shards
    mesh = shards.mesh
    geo = transformer_lib.mesh_geometry(mesh, state.model.cfg)
    dev0 = mesh.devices[0]
    whole, denom = _global_batch(state, batch)
    denom = denom.to(dev0)
    state.optimizer.zero_grad(set_to_none=True)
    accum = 1 if tcfg is None else max(tcfg.accum_steps, 1)
    staged = transformer_lib.global_stages(mesh) > 1
    fused = tcfg is not None and tcfg.fused_ce
    blocks = {k: _host_blocks(v, mesh, len(geo.ranks), accum)
              for k, v in whole.items()}
    with moe_lib.host_dispatch(_host_dispatch(state)), \
            pipeline.host_link(mesh) as link:
        if accum <= 1 or staged:
            part = {k: _rank_rows(v, geo, mesh) for k, v in blocks.items()}
            total = mesh_nll(state.model, shards, part, tcfg,
                             accum if staged else 1)
            # Where another host holds the last stage: no loss here.
            objective = (None if total is None else
                         total if fused else total / denom)
            if link is None:
                objective.backward()
            else:
                link.backward(objective)
            loss = (torch.zeros((), device=dev0) if total is None
                    else total.detach() / denom)
        else:
            q = blocks['inputs'][0].shape[0] // accum
            total = torch.zeros((), device=dev0)
            for i in range(accum):
                part = {k: _rank_rows([blk[i * q:(i + 1) * q] for blk in v],
                                      geo, mesh)
                        for k, v in blocks.items()}
                piece = mesh_nll(state.model, shards, part, tcfg,
                                 microbatch=i)
                piece.backward()
                total = total + piece.detach()
            loss = total / denom
    shards.sum_copy_grads()
    if fused or (accum > 1 and not staged):
        _divide_grads(state, denom)
    return loss


@torch.no_grad()
def _divide_grads(state: TrainState, denom: torch.Tensor) -> None:
    for p in state.owners():
        if p.grad is not None:
            p.grad.div_(denom.to(p.grad.device, p.grad.dtype))


def make_train_step(tcfg: Optional[TrainConfig] = None):
    """The counterpart of the reference's `jit_train_step(shardings,
    batch_sharding, tcfg)`: fn(state, batch) -> (state, metrics) with
    tcfg bound.  The placement travels with the state (its blocks) and
    the batch (global tensors, or `prefetch_to_device(sharding=)`'s row
    blocks), so nothing is compiled or bound to a layout here."""
    return lambda state, batch: train_step(state, batch, tcfg)


def peak_memory_bytes(device: Union[str, torch.device, Mesh] = 'cuda'
                      ) -> Optional[int]:
    """Peak bytes allocated on a CUDA device since the last
    torch.cuda.reset_peak_memory_stats (the port's counterpart of the
    reference's compiled_peak_memory, measured rather than compiled),
    fed to the training telemetry (callbacks.record_peak_memory:
    skytpu_train_peak_memory_bytes and summary.json); for a mesh, the
    largest peak over its distinct devices; None for the CPU, which
    keeps no such count."""
    devices = (device.distinct_devices() if isinstance(device, Mesh)
               else [torch.device(device)])
    cuda = [d for d in devices if d.type == 'cuda']
    if not cuda:
        return None
    peak = max(int(torch.cuda.max_memory_allocated(d)) for d in cuda)
    callbacks.record_peak_memory(peak)
    return peak


# ------------------------------------------------------------- checkpoints


def param_paths(model: Transformer) -> List[Tuple[Tuple[str, ...],
                                                   torch.nn.Parameter]]:
    """(tree path, parameter) for every parameter of a trainable model,
    in `convert.param_tree`'s order (the unstacked `layer_{i}` layout);
    raises unless they are exactly model.parameters()."""
    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from walk(value, prefix + (key,))
            else:
                yield prefix + (key,), value
    pairs = list(walk(convert.param_tree(model), ()))
    if ({id(p) for _, p in pairs} != {id(p) for p in model.parameters()} or
            len(pairs) != len(list(model.parameters()))):
        raise ValueError('param_tree does not cover the model\'s '
                         'parameters one to one')
    return pairs


def _pieces(state: TrainState) -> List[Tuple[Tuple[str, ...], List[Tuple[
        torch.Tensor, Tuple[slice, ...]]], torch.Size, torch.dtype]]:
    """(tree path, [(tensor, its slice of the full leaf)], full shape,
    dtype) of every leaf, in `param_paths`' order: a parameter as one
    piece, or over a mesh its blocks' owners (each element once; none
    for a layer of a stage another host holds)."""
    names = {id(p): name for name, p in state.model.named_parameters()}
    out = []
    for path, p in param_paths(state.model):
        if state.shards is None:
            pieces = [(p, (slice(None),) * p.dim())]
        else:
            pieces = state.shards.pieces(names[id(p)])
        out.append((path, pieces, p.shape, p.dtype))
    return out


def _holders(state: TrainState) -> List[List[int]]:
    """The hosts that hold each leaf (in `param_paths`' order), on a
    mesh that spans hosts: a layer's stage's data group, or every host
    for the embedding, final norm and head."""
    reduce = state.host_reduce
    data_hosts, pipe_hosts = reduce.grid
    every = list(range(data_hosts * pipe_hosts))
    if state.shards is None or pipe_hosts == 1:
        return [every for _ in param_paths(state.model)]
    mesh, cfg = state.shards.mesh, state.model.cfg
    names = {id(p): name for name, p in state.model.named_parameters()}
    out = []
    for _, p in param_paths(state.model):
        name = names[id(p)]
        if not name.startswith('layers.'):
            out.append(every)
            continue
        stage = transformer_lib.layer_stage(cfg, mesh,
                                            int(name.split('.')[1]))
        p_host = stage // mesh.shape.get('pipeline', 1)
        out.append([d * pipe_hosts + p_host for d in range(data_hosts)])
    return out


def _whole(pieces, shape, dtype, fn) -> torch.Tensor:
    """A full leaf on the host from fn(piece tensor) of every piece."""
    full = torch.empty(shape, dtype=dtype)
    for t, idx in pieces:
        full[idx] = fn(t).detach().to('cpu')
    return full


def _leaf_tensors(state: TrainState, pieces, shape, dtype,
                  counts: set) -> List[torch.Tensor]:
    """[param, exp_avg, exp_avg_sq] of one leaf, whole on the host."""
    out = [_whole(pieces, shape, dtype, lambda t: t)]
    for name in ('exp_avg', 'exp_avg_sq'):
        def moment(t, name=name):
            st = state.optimizer.state.get(t)
            counts.add(int(st['step']) if st else 0)
            return st[name] if st else torch.zeros_like(t)
        out.append(_whole(pieces, shape, dtype, moment))
    return out


@torch.no_grad()
def snapshot(state: TrainState) -> Optional[checkpoints.TrainSnapshot]:
    """Host copies of the state's leaves, all taken before this returns
    (`train_step` updates the state in place, so a snapshot that
    aliased it would change under a writer thread); over a mesh each
    leaf is gathered whole, so a sharded and an unsharded run of the
    same state write the same bytes.  A parameter the optimizer has not
    stepped yet has zero moments, as AdamW's lazy state starts.  Where
    the stages span hosts every host takes part: each leaf's first
    holder (`_holders`) sends the leaves host 0 does not hold, and host
    0 alone gets the snapshot (None on the others); elsewhere each host
    snapshots its own state."""
    spans = _stages_span_hosts(state)
    leaves = _pieces(state)
    sources = [held[0] for held in _holders(state)] if spans else None
    rank = state.host_reduce.host if spans else 0
    counts: set = set()
    whole: Dict[int, List[torch.Tensor]] = {}
    transfer = distributed.Transfer()
    for i, (_, pieces, shape, dtype) in enumerate(leaves):
        source = 0 if sources is None else sources[i]
        if rank == 0 and source == 0:
            whole[i] = _leaf_tensors(state, pieces, shape, dtype, counts)
        elif rank == 0:
            whole[i] = [transfer.recv(torch.empty(shape, dtype=dtype),
                                      source) for _ in range(3)]
        elif rank == source:
            for t in _leaf_tensors(state, pieces, shape, dtype, counts):
                transfer.send(t, 0)
    transfer.wait()
    if rank != 0:
        return None
    if len(counts) != 1:
        raise ValueError(f'optimizer step counts differ across '
                         f'parameters: {sorted(counts)}')
    return checkpoints.TrainSnapshot(
        params=[(path, whole[i][0]) for i, (path, *_) in enumerate(leaves)],
        mu=[(path, whole[i][1]) for i, (path, *_) in enumerate(leaves)],
        nu=[(path, whole[i][2]) for i, (path, *_) in enumerate(leaves)],
        count=counts.pop(), train_step=state.step)


def save_snapshot(state: TrainState
                  ) -> Optional[checkpoints.TrainSnapshot]:
    """The snapshot a checkpoint save writes, on host 0 of the gang;
    None on another host, which takes part only where the stages span
    hosts (it sends host 0 the leaves of its stages) and takes no
    snapshot where every host holds the same bits."""
    if _stages_span_hosts(state) or distributed.is_primary():
        return snapshot(state)
    return None


# `state_digest` hashes a state's bytes in pieces of this size, on this
# many threads at most.
DIGEST_CHUNK_BYTES = 64 << 20
DIGEST_THREADS = 8


@torch.no_grad()
def state_digest(state: TrainState) -> str:
    """A sha256 digest of the state's parameters and both AdamW
    moments: their bytes leaf by leaf in `param_paths`' order (for each
    leaf the parameter, exp_avg, exp_avg_sq; each whole, gathered to the
    host one at a time; a moment the optimizer has not made yet reads
    as zeros) cut into DIGEST_CHUNK_BYTES pieces, each piece's sha256
    taken on a thread pool, and the sha256 of those digests in order.
    Equal digests are equal bits, on any mesh.  Every host hashes each
    leaf it holds; where the stages span hosts (a host holds only some
    leaves) every host calls this, and a leaf the host does not hold
    takes the piece digests of its first holder (`_holders`).  So two
    hosts' digests are equal exactly when the holders of every leaf
    agree, and then equal to one process's digest of the same state."""
    leaves = _pieces(state)
    holders = _holders(state) if _stages_span_hosts(state) else None
    rank = 0 if holders is None else state.host_reduce.host
    digests: Dict[int, List[bytes]] = {}
    pending: List[Any] = []
    threads = max(1, min(DIGEST_THREADS, os.cpu_count() or 1))

    def settle(limit: int) -> None:
        while len(pending) > limit:
            i, future = pending.pop(0)
            digests.setdefault(i, []).append(future.result())
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for i, (_, pieces, shape, dtype) in enumerate(leaves):
            if holders is not None and rank not in holders[i]:
                continue
            digests[i] = []
            on_cards = any(t.device.type == 'cuda' for t, _ in pieces)
            for name in (None, 'exp_avg', 'exp_avg_sq'):
                # Straight from the cards into pinned memory.
                host = torch.empty(shape, dtype=dtype, pin_memory=on_cards)
                for t, idx in pieces:
                    opt = state.optimizer.state.get(t)
                    part = t if name is None else (
                        opt[name] if opt else torch.zeros_like(t))
                    host[idx].copy_(part.detach())
                for chunk in host.view(-1).view(torch.uint8).split(
                        DIGEST_CHUNK_BYTES):
                    pending.append((i, pool.submit(
                        lambda c: hashlib.sha256(c.numpy()).digest(),
                        chunk)))
                # Bound the host copies alive: at most 4 pieces a thread.
                settle(4 * threads)
        settle(0)
    if holders is not None:
        every: List[Any] = [None] * (state.host_reduce.grid[0] *
                                     state.host_reduce.grid[1])
        torch.distributed.all_gather_object(every, digests)
        for i, held in enumerate(holders):
            if i not in digests:
                digests[i] = every[held[0]][i]
    out = hashlib.sha256()
    for i in range(len(leaves)):
        for d in digests[i]:
            out.update(d)
    return out.hexdigest()


@torch.no_grad()
def load_train_step(state: TrainState, params, moments, *, count: int,
                    train_step: int) -> TrainState:
    """Put a saved training step back into `state` in place: every
    parameter, AdamW's exp_avg / exp_avg_sq and its step count (exactly:
    the bias correction of the next step reads it), and state.step;
    over a mesh each block's owner gets its slice of the whole leaves,
    and the other copies the owner's bits (`fill_copies`).
    `params` / `moments` are the step's open safetensors readers; every
    name, dtype and shape is checked before anything is written."""
    leaves = _pieces(state)
    want = {}
    for path, _, shape, dtype in leaves:
        name = '/'.join(path)
        spec = (safetensors_io.dtype_name(dtype), tuple(shape))
        want[(params, name)] = spec
        want[(moments, f'mu/{name}')] = spec
        want[(moments, f'nu/{name}')] = spec
    have = {(reader, name): (reader.dtype(name), reader.shape(name))
            for reader in (params, moments) for name in reader.keys()}
    if have != want:
        diff = sorted(f'{r.path}:{n} {have.get((r, n))} vs model '
                      f'{want.get((r, n))}' for r, n in set(have) | set(want)
                      if have.get((r, n)) != want.get((r, n)))
        raise ValueError(f'training step does not match this model '
                         f'(wrong model_config?): {diff[:4]}')
    for path, pieces, _, _ in leaves:
        if not pieces:      # a stage another host holds
            continue
        name = '/'.join(path)
        full = params.get_tensor(name)
        mu = moments.get_tensor(f'mu/{name}')
        nu = moments.get_tensor(f'nu/{name}')
        for t, idx in pieces:
            t.copy_(full[idx])
            state.optimizer.state[t] = {
                # make_optimizer's AdamW (neither capturable nor fused)
                # keeps its step count as a 0-dim tensor of the default
                # dtype on the host.
                'step': torch.tensor(float(count)),
                'exp_avg': mu[idx].to(t.device, copy=True).contiguous(),
                'exp_avg_sq': nu[idx].to(t.device, copy=True).contiguous(),
            }
    fill_copies(state)
    state.step = train_step
    return state


@torch.no_grad()
def fill_copies(state: TrainState) -> None:
    """Every block's other copies given its owner's bits: the parameter
    and, where the optimizer holds state for the owner, both moments
    and the step count (a copy's moments on its own entry, the count on
    the host as AdamW keeps it)."""
    if state.shards is None:
        return
    opt = state.optimizer.state
    for owner, *rest in state.shards.replicas():
        for t in rest:
            t.copy_(owner)
            if owner in opt:
                opt[t] = {k: v.clone() if k == 'step' else
                          v.to(t.device, copy=True)
                          for k, v in opt[owner].items()}
            else:
                opt.pop(t, None)


@torch.no_grad()
def check_copies(state: TrainState) -> int:
    """Raise ValueError unless every copy of every block equals its
    owner bit for bit: the parameter, both AdamW moments and the step
    count (a copy with no optimizer state only where the owner has
    none).  -> the number of copies besides the owners."""
    if state.shards is None:
        return 0
    opt = state.optimizer.state
    checked = 0
    for name, blocks in state.shards.copies.items():
        for held in blocks.values():
            owner, *rest = held.values()
            theirs = opt.get(owner, {})
            for t in rest:
                mine = opt.get(t, {})
                if not (torch.equal(t.to(owner.device), owner) and
                        mine.keys() == theirs.keys() and all(
                            torch.equal(mine[k].to(v.device), v)
                            for k, v in theirs.items())):
                    raise ValueError(f'{name}: a copy differs from its '
                                     'owner')
                checked += 1
    return checked


@torch.no_grad()
def load_pretrained_params(state: TrainState, directory: str) -> TrainState:
    """Start a finetune from a converted checkpoint (import_weights) or
    any params-bearing step of this port's format: each leaf of the
    newest step streams through `restore_params`' leaf_fn straight into
    the existing f32 master parameter (cast to its dtype; over a mesh,
    its slices into the owners' blocks, the leaf read on the host, then
    `fill_copies`), so no second
    tree exists on the device.  The optimizer's moments stay fresh:
    this is init, not resume.  Either layer layout is read (stacked
    `layers/layer/...` or `layer_{i}`); the leaf count and every shape
    are checked before anything is copied, and int8 weights are
    refused."""
    step = checkpoints.latest_step(directory)
    if step is None:
        raise FileNotFoundError(f'No checkpoint under {directory}')
    specs = checkpoints.step_specs(directory, step)
    int8 = sorted(n for n in specs if n.split('/')[-1] == 'qvalue')
    if int8:
        raise ValueError(
            f'{directory} step {step} holds int8 weights ({int8[0]}, ...): '
            'a finetune starts from float weights; convert the HF source '
            'without quantization')
    targets = {path: (pieces, shape) for path, pieces, shape, _ in
               _pieces(state)}
    n_layers = state.model.cfg.n_layers
    stacked = any(n.startswith('layers/layer/') for n in specs)
    expected: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    for path, (_, shape) in targets.items():
        if stacked and path[0].startswith('layer_'):
            if path[0] == 'layer_0':
                expected[('layers', 'layer') + path[1:]] = (
                    (n_layers,) + tuple(shape))
        else:
            expected[path] = tuple(shape)
    if len(specs) != len(expected):
        raise ValueError(
            f'Checkpoint has {len(specs)} arrays; model expects '
            f'{len(expected)} — wrong model_config for this state?')
    for name, (_, shape) in specs.items():
        want = expected.get(tuple(name.split('/')))
        if want is None:
            raise ValueError(f'Checkpoint array {name} is not in this model '
                             '— wrong model_config for this state?')
        if tuple(shape) != want:
            raise ValueError(f'Shape mismatch: checkpoint {tuple(shape)} '
                             f'vs model {want} ({name})')

    def put(path: Tuple[str, ...], leaf: torch.Tensor) -> None:
        for t, idx in targets[path][0]:
            t.copy_(leaf[idx])

    def copy_in(path: Tuple[str, ...], leaf: torch.Tensor) -> Any:
        if stacked and path[:2] == ('layers', 'layer'):
            for i in range(n_layers):
                put((f'layer_{i}',) + path[2:], leaf[i])
        else:
            put(path, leaf)
        return None

    device = 'cpu' if state.shards is not None else state.model.device
    checkpoints.restore_params(directory, device=device, leaf_fn=copy_in,
                               step=step)
    fill_copies(state)
    return state
