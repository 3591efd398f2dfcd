"""Logical-axis placement rules and the shards they give (mirrors
`skypilot_tpu/parallel/sharding.py`).

Modules name the dims of their tensors with logical axes ('batch',
'embed', 'heads', ...), and `LOGICAL_AXIS_RULES` maps those onto the
mesh axes of parallel/mesh.py, as in the reference.  Where the
reference returns a NamedSharding and GSPMD inserts the collectives,
the port returns a `Placement` (the mesh and, for each dim, the mesh
axes that split it) and moves the shards itself:

- `Placement.index(position, shape)` is the slice of the full tensor
  that a mesh position holds, in the form of the reference's
  `addressable_shards[i].index`;
- `split(tensor, placement)` cuts a tensor into its distinct blocks
  and gives each block a copy on every distinct device entry of the
  mesh that holds it (`Placement.holders`), as the reference's GSPMD
  keeps a shard on every device that holds it.  Entries are distinct
  by `torch.device` equality: a list that repeats one card (or 'cpu')
  keeps one copy a block, and `cuda:0 ... cuda:3` (or the indexed CPU
  entries `cpu:0 ... cpu:3`, the CPU tests' stand-in for cards) keep
  one a card.  Copies are keyed by the entry that holds them, never by
  `tensor.device` (every CPU tensor reports `cpu`); the first is the
  owner's (`Placement.owners`), and whatever needs one copy a block
  reads that one.
- `gather(copies, placement, device)` joins the blocks on `device`
  with `.to` and `torch.cat`, each from the copy that entry holds, or
  from the owner's where it holds none; autograd carries the full
  tensor's gradient back to each copy as a sum over its readers: the
  reduce-scatter the reference's GSPMD inserts.  The step then sums
  each block's copies into the owner's gradient (models/train.py).

A placement may also pin mesh coordinates (`Placement.at`): only the
positions at those coordinates hold the tensor.  A pipeline stage's
layer is one such tensor, held by the positions at 'pipeline' = p (the
reference's leading 'stage' dim of a stacked layer leaf, over
'pipeline'); within them its dims split as `spec` says.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from skypilot_tpu_torch.parallel.mesh import Mesh

# (logical axis, mesh axis or tuple of mesh axes); the first matching
# rule wins.  batch rides data (+ fsdp), everything model-internal stays
# on ICI axes.
LOGICAL_AXIS_RULES: Tuple[Tuple[str, Optional[object]], ...] = (
    ('batch', ('data', 'fsdp')),
    ('seq', 'sequence'),
    ('embed', 'fsdp'),
    ('heads', 'tensor'),
    ('kv_heads', 'tensor'),
    ('mlp', 'tensor'),
    ('vocab', 'tensor'),
    ('expert', 'expert'),
    ('head_dim', None),
    ('kv', None),
    ('stage', 'pipeline'),
    ('layers', None),
)

Block = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Placement:
    """The port's NamedSharding: `spec[i]` is the tuple of mesh axes
    that split dim i (empty: replicated), the first axis major, as a
    PartitionSpec entry.  Dims past len(spec) are replicated.  `at`
    pins ((mesh axis, index), ...): only positions at those coordinates
    hold the tensor (empty: every position holds a block)."""
    mesh: Mesh
    spec: Tuple[Tuple[str, ...], ...]
    at: Tuple[Tuple[str, int], ...] = ()

    def holds(self, position: int) -> bool:
        """Whether mesh position `position` holds a block."""
        coords = self.mesh.coords(position)
        return all(coords[axis] == index for axis, index in self.at)

    def parts(self, ndim: int) -> Tuple[int, ...]:
        """How many blocks each of ndim dims is cut into."""
        spec = self.spec + ((),) * (ndim - len(self.spec))
        return tuple(math.prod(self.mesh.shape[a] for a in axes)
                     for axes in spec[:ndim])

    def block(self, position: int, ndim: int) -> Block:
        """The block index, per dim, that a mesh position holds (one
        that `holds` the tensor)."""
        coords = self.mesh.coords(position)
        spec = self.spec + ((),) * (ndim - len(self.spec))
        out = []
        for axes in spec[:ndim]:
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + coords[a]
            out.append(idx)
        return tuple(out)

    def index(self, position: int, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The slice of a `shape` tensor that `position` holds: slice(
        start, stop) on split dims and slice(None) on the others, as
        jax's Shard.index reads."""
        out = []
        for n, blk, dim in zip(self.parts(len(shape)),
                               self.block(position, len(shape)), shape):
            if n == 1:
                out.append(slice(None, None, None))
            else:
                if dim % n:
                    raise ValueError(f'dim of size {dim} does not divide '
                                     f'into {n} shards')
                out.append(slice(blk * dim // n, (blk + 1) * dim // n, None))
        return tuple(out)

    def holders(self, ndim: int) -> Dict[Block, List[int]]:
        """{block: the positions that keep a copy of it}, in block
        order: of the positions holding the block, the first at each
        distinct device entry (`torch.device` equality), in position
        order, so the owner comes first."""
        first: Dict[Block, Dict[torch.device, int]] = {}
        for pos in filter(self.holds, range(self.mesh.size)):
            first.setdefault(self.block(pos, ndim), {}).setdefault(
                self.mesh.devices[pos], pos)
        return {blk: list(held.values())
                for blk, held in sorted(first.items())}

    def owners(self, ndim: int) -> Dict[Block, int]:
        """{block: the first mesh position holding it}, in block
        order."""
        return {blk: pos[0] for blk, pos in self.holders(ndim).items()}

    def is_replicated(self) -> bool:
        return not self.at and all(n == 1 for n in self.parts(len(self.spec)))


def logical_sharding(mesh: Mesh, *logical_axes: Optional[str]) -> Placement:
    """The placement of a tensor whose dims carry these logical names.
    An axis not in the mesh, or already used by an earlier dim, is
    dropped (a mesh axis splits at most one dim of a tensor)."""
    rules = dict(LOGICAL_AXIS_RULES)
    spec = []
    used = set()
    for name in logical_axes:
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            spec.append(())
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        usable = tuple(a for a in mesh_axes
                       if a in mesh.axis_names and a not in used)
        used.update(usable)
        spec.append(usable)
    return Placement(mesh, tuple(spec))


def batch_sharding(mesh: Mesh) -> Placement:
    """Placement of [batch, seq, ...] activations."""
    return logical_sharding(mesh, 'batch', 'seq')


def token_batch_sharding(mesh: Mesh) -> Placement:
    """Placement of raw token batches [batch, seq_len + 1]: batch only
    (the + 1 column makes seq indivisible by a sequence axis; the
    model re-shards activations onto it after the embedding)."""
    return logical_sharding(mesh, 'batch', None)


def head_kernel_sharding(mesh: Mesh) -> Placement:
    """Placement of the lm-head kernel [embed, vocab] travelling as a
    plain tensor (the fused CE's argument)."""
    return logical_sharding(mesh, 'embed', 'vocab')


def slot_cache_sharding(mesh: Mesh) -> Placement:
    """Placement of the engine's slot KV cache [layers, slots,
    kv_heads, max_len, head_dim]: kv heads on 'tensor', like the
    attention kernels, so a tensor rank reads and writes its own heads
    (models/decode.py keeps one such cache per rank)."""
    return logical_sharding(mesh, 'layers', None, 'kv_heads', None,
                            'head_dim')


def page_pool_sharding(mesh: Mesh) -> Placement:
    """Placement of one paged-KV pool leaf [layers, n_pages, kv_heads,
    page_size, head_dim]: kv heads on 'tensor'; every rank holds every
    page's slice of its own heads, so one page id names the same page
    in each rank's pool."""
    return logical_sharding(mesh, 'layers', None, 'kv_heads', None,
                            'head_dim')


def page_scale_sharding(mesh: Mesh) -> Placement:
    """Placement of an int8 pool's per-token scales [layers, n_pages,
    kv_heads, page_size]."""
    return logical_sharding(mesh, 'layers', None, 'kv_heads', None)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def shard_of(x, placement: Placement, position: int):
    """The slice of `x` (a tensor or numpy array) that mesh position
    `position` holds under `placement` (a view where slicing gives
    one)."""
    return x[placement.index(position, x.shape)]


def split(x: torch.Tensor, placement: Placement,
          requires_grad: bool = False
          ) -> Dict[Block, Dict[torch.device, torch.Tensor]]:
    """x cut into its distinct blocks, each as {holder entry: its copy}
    (`Placement.holders`, the owner first): new contiguous tensors of
    the same bits on each entry (leaves with `requires_grad` when
    asked)."""
    devices = placement.mesh.devices
    out = {}
    for blk, positions in placement.holders(x.dim()).items():
        piece = x[placement.index(positions[0], x.shape)]
        out[blk] = {
            devices[pos]: piece.to(devices[pos], copy=True).contiguous(
            ).requires_grad_(requires_grad) for pos in positions}
    return out


def gather(copies: Dict[Block, Dict[torch.device, torch.Tensor]],
           placement: Placement, device: Union[str, torch.device],
           fixed: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The full tensor on `device`, joined from its blocks
    (differentiable): each block from the copy that entry `device`
    holds, else from the owner's (the first); with `fixed` ({mesh axis:
    index}), the slice that index holds along a dim that axis splits,
    the other dims joined whole (a tensor rank's slice: fixed={'tensor':
    t}).  One block is returned as it is when `device` holds it."""
    device = torch.device(device)

    def read(blk: Block) -> torch.Tensor:
        held = copies[blk]
        if device in held:
            return held[device]
        # A copy into host memory is waited for: the join below reads
        # it on the host.
        return next(iter(held.values())).to(
            device, non_blocking=device.type != 'cpu')

    if len(copies) == 1:
        return read(next(iter(copies)))
    ndim = next(iter(next(iter(copies.values())).values())).dim()
    parts = placement.parts(ndim)
    spec = placement.spec + ((),) * (ndim - len(placement.spec))
    fixed = fixed or {}

    def choices(d: int) -> Sequence[int]:
        held = [a for a in spec[d] if a in fixed]
        if not held:
            return range(parts[d])
        if len(spec[d]) != 1:
            raise ValueError(f'dim {d} is split by {spec[d]}; a fixed '
                             'axis must split a dim alone')
        return [fixed[held[0]]]

    def join(prefix: Block) -> torch.Tensor:
        d = len(prefix)
        if d == ndim:
            return read(prefix)
        pieces = [join(prefix + (i,)) for i in choices(d)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=d)
    return join(())
