"""Mesh plumbing shared by the sequence-parallel attention ops (mirrors
`skypilot_tpu/ops/sp_common.py`).

ring_attention and ulysses_attention cut the sequence the same way, so
the axis selection and the GQA broadcast live here once.  Degenerate
meshes are first-class: a mesh without the sequence axis, or with it at
size 1, is degree 1 ("no sequence collective"), so a slice replica runs
one code path for every `num_hosts`.

Where the reference hands a PartitionSpec to shard_map, the port cuts
the global [b, h, s, d] tensors itself: `sp_partition` names the rows
of the sequence each position of the mesh's sequence axis holds, and
on which device.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from skypilot_tpu_torch.ops.attention import _repeat_kv


class SeqShard(NamedTuple):
    """One rank of the sequence axis: its device and its rows
    [start, stop) of the sequence."""
    rank: int
    device: torch.device
    start: int
    stop: int


def sp_degree(mesh, axis_name: str) -> int:
    """Size of the sequence-parallel axis; 1 when the mesh does not
    carry the axis or carries it at size 1 (both mean "no sequence
    collective")."""
    if mesh is None or axis_name not in mesh.axis_names:
        return 1
    return int(mesh.shape[axis_name])


def tensor_degree(mesh) -> int:
    """The head-sharding factor: the mesh's 'tensor' axis, 1 without
    it."""
    if mesh is None:
        return 1
    return int(mesh.shape.get('tensor', 1))


def sp_partition(mesh, axis_name: str, seq_len: int) -> List[SeqShard]:
    """The shard of a `seq_len` sequence each rank of `axis_name` holds:
    rank r holds rows [r * seq_len / sp, (r + 1) * seq_len / sp) on the
    r-th device along the axis.  A mesh without the axis is one shard
    on its first device.  Raises when sp does not divide seq_len, as
    shard_map refuses an uneven split."""
    sp = sp_degree(mesh, axis_name)
    if seq_len % sp:
        raise ValueError(f'sequence length {seq_len} is not divisible by '
                         f'the {axis_name!r} axis ({sp})')
    chunk = seq_len // sp
    return [SeqShard(r, dev, r * chunk, (r + 1) * chunk)
            for r, dev in enumerate(mesh.axis_devices(axis_name))]


def broadcast_gqa_if_indivisible(q, k, v, divisor: int):
    """Broadcast kv heads up to q heads when they don't divide the head
    sharding (`divisor` = the product of head-sharding mesh axes)."""
    if k.shape[1] % divisor:
        k, v = _repeat_kv(q, k, v)
    return k, v


def shard(x: torch.Tensor, shards: List[SeqShard]) -> List[torch.Tensor]:
    """x [b, h, s, d] cut along the sequence into each rank's rows, on
    its device (contiguous, as the flash kernel takes them)."""
    return [x[:, :, s.start:s.stop].to(s.device).contiguous()
            for s in shards]
