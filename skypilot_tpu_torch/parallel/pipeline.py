"""Pipeline parallelism: the GPipe microbatch schedule over the
'pipeline' mesh axis (mirrors `skypilot_tpu/parallel/pipeline.py`).

The reference stacks every layer leaf into [S, L / S, ...] with the
stage dim over 'pipeline' and runs a partial-manual shard_map whose
scan ticks M + S - 1 times, `ppermute`-ing each stage's output one hop
down.  The port keeps per-layer leaves and places them by stage
(`transformer.placements`): layer i is held only by the positions at
'pipeline' = i // (L / S), split within the stage as the logical-axis
rules say (heads, kv heads, d_ff and vocab over 'tensor', embed over
'fsdp'); the embedding, final norm and head are replicated over
'pipeline'.  Every block has a copy on each distinct device entry that
holds it (parallel/sharding.py): on distinct cards, a stage's layer
blocks on its own cards, and the embedding, final norm and head on
every stage's, the last stage's included.

- `gpipe` launches the schedule from one host thread: at tick t, stage p
  runs microbatch t - p over its own ranks (transformer._mesh_layer,
  the mesh's one layer body: tensor ranks, ring or Ulysses attention
  over the sequence ranks, an MoE block's capacity dispatch) and its
  output moves to stage p + 1's devices with `.to(non_blocking=True)`,
  the reference's ppermute.  Only the M * S valid (stage, microbatch)
  pairs run: the reference's drain ticks compute on clipped inputs and
  discard the result.  Nothing in it waits for the device, so stages
  on distinct cards overlap.
- Backward is one `backward()` over the whole schedule; autograd runs
  each device's backward on a thread of its own, which gives the GPipe
  backward.  With cfg.remat each (stage, microbatch) is one reentrant
  checkpoint (the reference checkpoints its stage body each tick), so
  a stage keeps M boundary activations and recomputes one stage at a
  time.
- Microbatch m is the global rows m * mb ... (m + 1) * mb (mb = b / M),
  as the reference's reshape cuts the batch, and batch rank i takes the
  i-th of its equal parts (`microbatch_rows`).  An MoE block dispatches
  over the microbatch's rows in that global order, and with a sequence
  axis over each sequence rank's chunk alone, as the reference's stage
  body (manual over 'sequence') does.
- The embedding (and Gemma's sqrt(d) scale) runs on stage 0's ranks;
  the final norm and the unembed, tied or not, on the last stage's,
  each reading its own entries' copies (on a list that repeats one
  card, the one copy).  A tied embedding's gradient is the sum of the
  two stages' copies, which the step's copy sum forms
  (`ShardedParams.sum_copy_grads`).

Across hosts (a mesh whose 'pipeline' axis spans hosts, parallel/
mesh.py) each host runs the ticks of its own stages.  At a boundary
between hosts the stage's output is sent to the next host in tick
order (`distributed.Transfer`), where it is received into a leaf that
requires grad (`HostLink`, which a training step opens around its
forward and backward).  The backward is driven host by host, and no
collective runs inside autograd: the last host runs its backward,
sends each received leaf's gradient back, and the host before it runs
`torch.autograd.backward` on what it sent with those gradients, and so
on down to stage 0.  Inside a host the hops between its own stages and
its one backward over them are the ones above.

Correctness contract (tests/test_torch_pipeline.py): the pipelined
loss and gradients equal the reference's `pipeline_loss_fn` on the same
parameters, on pipeline, pipeline x data / fsdp / tensor / sequence
meshes, and a `pipeline_train_step` equals the reference's step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.models import transformer
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import sharding


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    return fn(node)


def _stack(*nodes):
    if isinstance(nodes[0], dict):
        return {k: _stack(*(n[k] for n in nodes)) for k in nodes[0]}
    if torch.is_tensor(nodes[0]):
        with torch.no_grad():
            return torch.stack(nodes)
    return np.stack(nodes)


def _stacked_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """The [L, ...] layer subtree of a tree in either layout: the
    reference's scanned `layers.layer`, or `layer_{i}` (`param_tree`)
    stacked."""
    if 'layers' in params:
        return params['layers']['layer']
    n = sum(1 for k in params if k.startswith('layer_'))
    if not n:
        raise ValueError('no layers in the tree (neither layers.layer nor '
                         'layer_{i})')
    return _stack(*(params[f'layer_{i}'] for i in range(n)))


def split_stage_params(params: Dict[str, Any], n_stages: int
                       ) -> Dict[str, Any]:
    """The reference tree's layer leaves [L, ...] -> [S, L // S, ...]
    (numpy or torch leaves; a `layer_{i}` tree is stacked first), the
    other subtrees as they are."""
    def split(leaf):
        n_layers = leaf.shape[0]
        if n_layers % n_stages:
            raise ValueError(
                f'n_layers={n_layers} not divisible by n_stages={n_stages}')
        return leaf.reshape(n_stages, n_layers // n_stages, *leaf.shape[1:])

    out = {k: v for k, v in params.items()
           if k != 'layers' and not k.startswith('layer_')}
    out['layers'] = {'layer': _map(split, _stacked_layers(params))}
    return out


def merge_stage_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of split_stage_params: [S, L // S, ...] -> [L, ...]."""
    out = dict(params)
    out['layers'] = {'layer': _map(
        lambda leaf: leaf.reshape(-1, *leaf.shape[2:]),
        params['layers']['layer'])}
    return out


def stage_param_shardings(cfg, mesh, n_stages: int
                          ) -> Dict[str, sharding.Placement]:
    """{parameter name: Placement} with full composition: layer i on
    its stage's positions ('pipeline' = i // (L / S)), split within
    the stage by its logical axes; the embedding, final norm and head
    replicated over 'pipeline' (`transformer.placements`)."""
    if n_stages != transformer.global_stages(mesh):
        raise ValueError(f'n_stages={n_stages} != pipeline axis size '
                         f'{transformer.global_stages(mesh)}')
    return transformer.placements(
        transformer.Transformer(cfg, device='meta', trainable=True), mesh)


def pipeline_param_shardings(model, mesh) -> Dict[str, sharding.Placement]:
    """DEPRECATED shape-only placement (the reference's alias): each
    layer on its stage's positions and replicated there, every other
    leaf replicated.  Prefer stage_param_shardings."""
    cfg = model.cfg
    transformer.check_mesh(mesh, cfg)
    out = {}
    for name, _ in model.named_parameters():
        if name.startswith('layers.'):
            stage = transformer.layer_stage(cfg, mesh,
                                            int(name.split('.')[1]))
            out[name] = sharding.Placement(
                mesh, (), at=(('pipeline', stage - mesh.global_stage),))
        else:
            out[name] = sharding.replicated(mesh)
    return out


def microbatch_rows(x: torch.Tensor, n_ranks: int,
                    num_microbatches: int) -> List[torch.Tensor]:
    """A global batch [b, ...] as one block a batch rank [b / n_ranks,
    ...]: rank i's part of every microbatch, microbatch major.
    Microbatch m is the rows m * mb ... (m + 1) * mb (mb = b / M), and
    rank i holds the i-th of its n_ranks equal parts."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f'batch {b} not divisible by num_microbatches '
                         f'{num_microbatches}')
    if (b // num_microbatches) % n_ranks:
        raise ValueError(f'microbatch of {b // num_microbatches} rows not '
                         f'divisible by the {n_ranks} batch ranks')
    q = b // num_microbatches // n_ranks
    parts = x.reshape(num_microbatches, n_ranks, q, *x.shape[1:])
    return [parts[:, i].reshape(num_microbatches * q, *x.shape[1:])
            for i in range(n_ranks)]


def _stage(model, shards, geo, layers: Sequence[int], b: int, chunk: int,
           devs, *xs: torch.Tensor, microbatch: int = 0
           ) -> Tuple[torch.Tensor, ...]:
    """One stage's layers over one microbatch's rows (the reference's
    stage_fn)."""
    for index in layers:
        xs = transformer._mesh_layer(model, shards, geo, index, b, chunk,  # pylint: disable=protected-access
                                     devs, *xs, seq_local=True,
                                     microbatch=microbatch)
    return xs


class HostLink:
    """A training step's pipeline boundaries between hosts (module
    docstring): this host's outputs sent to the next host and the
    leaves received from the one before, one a microbatch (every
    (batch, sequence) rank's rows packed into one tensor); the bytes
    moved and the seconds spent go to `BOUNDARY`."""

    def __init__(self, mesh) -> None:
        n_stages = transformer.global_stages(mesh)
        last = mesh.global_stage + mesh.shape.get('pipeline', 1)
        self.prev = mesh.host_rank - 1 if mesh.global_stage > 0 else None
        self.next = mesh.host_rank + 1 if last < n_stages else None
        self.sent: List[torch.Tensor] = []
        self.received: List[torch.Tensor] = []
        self._sends = distributed.Transfer()

    @staticmethod
    def _account(transfer: distributed.Transfer) -> None:
        BOUNDARY['bytes'] += transfer.bytes
        BOUNDARY['seconds'] += transfer.seconds
        transfer.bytes, transfer.seconds = 0, 0.0

    def receive(self, like: torch.Tensor) -> torch.Tensor:
        """The next microbatch's rows from the host before (a leaf that
        requires grad, of `like`'s shape, dtype and device)."""
        transfer = distributed.Transfer()
        out = transfer.recv(like, self.prev)
        transfer.wait()
        self._account(transfer)
        self.received.append(out.requires_grad_())
        return out

    def send(self, rows: torch.Tensor) -> None:
        """Start sending a microbatch's rows to the next host."""
        self._sends.send(rows, self.next)
        self.sent.append(rows)

    def finish_forward(self) -> None:
        self._sends.wait()
        self._account(self._sends)

    def backward(self, objective: Optional[torch.Tensor]) -> None:
        """The host-driven backward: `objective`'s backward where this
        host holds the last stage, else the sent outputs' with the
        gradients the next host sends back; then the received leaves'
        gradients to the host before."""
        if self.next is None:
            objective.backward()
        else:
            transfer = distributed.Transfer()
            grads = [transfer.recv(out, self.next) for out in self.sent]
            transfer.wait()
            self._account(transfer)
            torch.autograd.backward(self.sent, grads)
        if self.prev is not None:
            transfer = distributed.Transfer()
            for leaf in self.received:
                transfer.send(leaf.grad, self.prev)
            transfer.wait()
            self._account(transfer)
        self.sent, self.received = [], []


_LINK: Optional[HostLink] = None
# Every HostLink's bytes sent and received and seconds spent in its
# transfers (waits for the other host included), since `take_boundary`.
BOUNDARY = {'bytes': 0, 'seconds': 0.0}


def take_boundary() -> Tuple[float, int]:
    """(seconds, bytes) of the pipeline's host boundaries since the last
    take."""
    out = (BOUNDARY['seconds'], BOUNDARY['bytes'])
    BOUNDARY.update(bytes=0, seconds=0.0)
    return out


@contextlib.contextmanager
def host_link(mesh):
    """A `HostLink` for a step's forward and backward over `mesh` where
    its pipeline spans hosts (None where it does not)."""
    global _LINK  # pylint: disable=global-statement
    spans = transformer.global_stages(mesh) > mesh.shape.get('pipeline', 1)
    before, _LINK = _LINK, (HostLink(mesh) if spans else None)
    try:
        yield _LINK
    finally:
        _LINK = before


def gpipe(model, shards, geo: transformer.MeshGeometry, b: int, chunk: int,
          num_microbatches: int, xs: Optional[Sequence[torch.Tensor]]
          ) -> Optional[List[torch.Tensor]]:
    """The GPipe schedule (module docstring): xs[g] [b * chunk, d],
    each (batch, sequence) rank's embedded rows on stage 0's devices ->
    the same rows after every layer, on the last stage's devices.
    Across hosts this host runs its own stages: xs is None where stage
    0 is another host's, and None is returned where the last is."""
    cfg = model.cfg
    mesh = shards.mesh
    m_count, n_stages = num_microbatches, transformer.global_stages(mesh)
    first, local = mesh.global_stage, geo.pp
    link = _LINK
    if local < n_stages and link is None:
        raise RuntimeError('a pipeline across hosts runs inside a training '
                           'step (pipeline.host_link over its mesh)')
    if b % m_count:
        raise ValueError(f'{b} rows a batch rank not divisible by '
                         f'num_microbatches {m_count}')
    q = b // m_count
    per = cfg.n_layers // n_stages
    stages = [geo.stage(p) for p in range(local)]
    devs = [transformer.row_devices(mesh, s.ranks) for s in stages]
    if xs is not None:
        acts: List[Any] = [list(rows) for rows in zip(
            *(x.split(q * chunk) for x in xs))]
    else:       # received from the host before, every rank's rows packed
        acts = [None] * m_count
        like = torch.empty((len(devs[0]) * q * chunk, cfg.d_model),
                           dtype=cfg.dtype, device=devs[0][0][0])
    for tick in range(m_count + n_stages - 1):
        for p in range(max(first, tick - m_count + 1),
                       min(first + local, tick + 1)):
            m, lp = tick - p, p - first
            if acts[m] is None:
                acts[m] = link.receive(like).split(q * chunk)
            ins = [x.to(row[0], non_blocking=True)
                   for x, row in zip(acts[m], devs[lp])]
            fn = functools.partial(_stage, model, shards, stages[lp],
                                   range(p * per, (p + 1) * per), q, chunk,
                                   devs[lp], microbatch=m)
            acts[m] = (torch_checkpoint.checkpoint(fn, *ins,
                                                   use_reentrant=True)
                       if cfg.remat else fn(*ins))
            if lp == local - 1 and link is not None and link.next is not None:
                link.send(torch.cat([x.to(acts[m][0].device)
                                     for x in acts[m]]))
    if link is not None and link.next is not None:
        link.finish_forward()
        return None
    return [torch.cat(rows) if len(rows) > 1 else rows[0]
            for rows in zip(*acts)]


def _check_params(cfg, params, mesh) -> None:
    if (params.mesh.shape != mesh.shape or
            params.mesh.devices != mesh.devices):
        raise ValueError('the parameters are placed on another mesh')
    if params.model.cfg != cfg:
        raise ValueError('cfg differs from the config the parameters '
                         'were built for')


def pipeline_forward(cfg, params, inputs: torch.Tensor, *, mesh,
                     num_microbatches: int) -> torch.Tensor:
    """Pipelined forward: tokens [b, s] -> logits [b, s, V] f32 on the
    last stage's first device.  `params` is a `ShardedParams` on `mesh`
    (a state's `shards`, or `ShardedParams.from_model`)."""
    _check_params(cfg, params, mesh)
    geo = transformer.mesh_geometry(mesh, cfg)
    blocks = train._rank_rows(  # pylint: disable=protected-access
        microbatch_rows(inputs, len(geo.ranks), num_microbatches), geo, mesh)
    outs = params.model(blocks, shards=params,
                        num_microbatches=num_microbatches)
    dev = mesh.devices[geo.stages[-1][0][0][0]]
    # Each batch rank's sequence chunks side by side, then the ranks'
    # microbatch-major rows back into the global order.
    ranks = [torch.cat([o.to(dev) for o in outs[i * geo.sp:(i + 1) * geo.sp]],
                       dim=1).reshape(num_microbatches, -1,
                                      *inputs.shape[1:], cfg.vocab_size)
             for i in range(len(geo.ranks))]
    return torch.stack(ranks, dim=1).reshape(*inputs.shape, cfg.vocab_size)


def pipeline_loss_fn(cfg, params, tokens: torch.Tensor, *, mesh,
                     num_microbatches: int) -> torch.Tensor:
    """Next-token CE (`train.loss_fn`'s f32 log-softmax) on a pipelined
    forward; tokens [b, s + 1] -> the mean over b * s targets, a 0-dim
    tensor on the mesh's first device (differentiable).  After its
    backward, `params.sum_copy_grads()` sums each block's copies into
    its owner's gradient."""
    _check_params(cfg, params, mesh)
    geo = transformer.mesh_geometry(mesh, cfg)
    blocks = train._rank_rows(  # pylint: disable=protected-access
        microbatch_rows(tokens, len(geo.ranks), num_microbatches), geo, mesh)
    part = {'inputs': [t[:, :-1] for t in blocks],
            'targets': [t[:, 1:] for t in blocks]}
    nll = train.mesh_nll(params.model, params, part, None, num_microbatches)
    return nll / float(tokens.shape[0] * (tokens.shape[1] - 1))


# ------------------------------------------------------- TrainState path


def create_pipeline_train_state(cfg, tcfg: Optional[train.TrainConfig] = None,
                                *, mesh, batch_size: int, seq_len: int,
                                seed: int = 0
                                ) -> Tuple[train.TrainState, Dict[str, Any]]:
    """-> (state, {parameter name: Placement}): `train.create_train_state`
    on `mesh`, whose placement puts each layer on its stage's positions
    (stage_param_shardings); no device holds more than one full leaf at
    a time.  A batch of batch_size x seq_len tokens that the mesh cannot
    cut (its batch ranks, its sequence axis) is refused here."""
    transformer.check_mesh(mesh, cfg)
    ranks = mesh.shape.get('data', 1) * mesh.shape.get('fsdp', 1)
    if batch_size % ranks:
        raise ValueError(f'batch {batch_size} not divisible by the {ranks} '
                         'batch ranks')
    if seq_len % mesh.shape.get('sequence', 1):
        raise ValueError(f'seq {seq_len} not divisible by the sequence axis '
                         f'size {mesh.shape["sequence"]}')
    return train.create_train_state(cfg, tcfg, mesh=mesh, seed=seed)


def pipeline_train_step(cfg, mesh, num_microbatches: int,
                        tcfg: Optional[train.TrainConfig] = None):
    """fn(state, batch) -> (state, {'loss', 'grad_norm'}): one optimizer
    step (the clip and AdamW of `train.make_optimizer`, in place) on the
    pipelined forward over `num_microbatches` microbatches; the twin of
    `train.make_train_step`, whose accumulation microbatches are the
    schedule's on a pipeline mesh."""
    tcfg = dataclasses.replace(tcfg or train.TrainConfig(),
                               accum_steps=num_microbatches)

    def step(state, batch):
        if state.shards is not None:
            _check_params(cfg, state.shards, mesh)
        return train.train_step(state, batch, tcfg)

    return step


def run_pipeline_train_step(cfg, tcfg, mesh, *, batch: int, seq: int,
                            num_microbatches: int, seed: int = 0) -> float:
    """Build a stage-placed state on `mesh` (seed `seed`) and run ONE
    pipelined optimizer step on tokens drawn from seed + 1; -> the
    loss."""
    state, _ = create_pipeline_train_state(cfg, tcfg, mesh=mesh,
                                           batch_size=batch, seq_len=seq,
                                           seed=seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(seed + 1))
    step = pipeline_train_step(cfg, mesh, num_microbatches, tcfg)
    _, metrics = step(state, {'tokens': tokens})
    return float(metrics['loss'])
