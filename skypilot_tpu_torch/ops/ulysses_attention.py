"""Ulysses-style all-to-all sequence parallelism (mirrors
`skypilot_tpu/ops/ulysses_attention.py`).

The other long-context strategy beside ring attention: the sequence
shards are regrouped into head groups (the reference's first
all-to-all), so rank r holds heads [r h/sp, (r + 1) h/sp) over the
WHOLE sequence and runs ONE ordinary causal flash call (the CUDA
kernel B3 on CUDA tensors, its plain version on the CPU); the inverse
regroup hands every rank its rows of every head back.  Each regroup
moves shards with `.to(device, non_blocking=True)`.  Requires the q
heads (and the kv heads, unless they are broadcast up) to divide the
sequence axis.  Serving's `prefill_sp` is ring-only; sharded training
runs it with `cfg.sequence_parallel='ulysses'`
(models/transformer.mesh_forward), and autograd carries the gradients
back through both regroups' moves.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from skypilot_tpu_torch.ops import sp_common
from skypilot_tpu_torch.ops.attention import flash_attention


def ulysses_attention_shards(qs: Sequence[torch.Tensor],
                             ks: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor],
                             devices: Sequence[torch.device], *,
                             causal: bool, sm_scale: float,
                             axis_name: str = 'sequence'
                             ) -> List[torch.Tensor]:
    """Per-rank shards [b, h, s/sp, d] on devices[r] -> each rank's
    output shard on its device.  The heads' divisibility is checked
    against the axis size here too, and kv heads that do not divide it
    are broadcast up, as in the reference's body under shard_map."""
    sp = len(devices)
    if qs[0].shape[1] % sp:
        raise ValueError(
            f'ulysses needs num_heads ({qs[0].shape[1]}) divisible by the '
            f'{axis_name!r} axis ({sp}); use ring attention instead.')
    pairs = [sp_common.broadcast_gqa_if_indivisible(q, k, v, sp)
             for q, k, v in zip(qs, ks, vs)]
    ks, vs = [p[0] for p in pairs], [p[1] for p in pairs]

    def to_heads(xs, r):
        # [b, h, s/sp, d] shards -> rank r's [b, h/sp, s, d] head group.
        g = xs[0].shape[1] // sp
        return torch.cat([x[:, r * g:(r + 1) * g].to(devices[r],
                                                      non_blocking=True)
                          for x in xs], dim=2).contiguous()

    outs = [flash_attention(to_heads(qs, r), to_heads(ks, r),
                            to_heads(vs, r), causal=causal,
                            sm_scale=sm_scale) for r in range(sp)]
    chunk = qs[0].shape[2]
    # [b, h/sp, s, d] head groups -> rank j's [b, h, s/sp, d] rows.
    return [torch.cat([out[:, :, j * chunk:(j + 1) * chunk].to(
        devices[j], non_blocking=True) for out in outs], dim=1)
        for j in range(sp)]


def ulysses_attention(q, k, v, *, mesh, axis_name: str = 'sequence',
                      causal: bool = True,
                      sm_scale: Optional[float] = None):
    """All-to-all sequence-parallel attention.

    Args:
      q, k, v: [batch, heads, seq, head_dim] GLOBAL tensors.  Requires q
        heads (and kv heads, unless they are broadcast up) to divide the
        sequence-axis size times the tensor factor.
      mesh: the port's Mesh (parallel/mesh.py).
    """
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if mesh is None or axis_name not in mesh.axis_names:
        # Degenerate slice without the axis: one party's all-to-all is
        # the identity, so this IS plain flash.
        return flash_attention(q, k, v, causal=causal,
                               sm_scale=float(sm_scale))
    sp = sp_common.sp_degree(mesh, axis_name)
    tp = sp_common.tensor_degree(mesh)
    if q.shape[1] % (tp * sp):
        raise ValueError(
            f'ulysses needs num_heads ({q.shape[1]}) divisible by '
            f'tensor ({tp}) x {axis_name} ({sp}); use ring attention '
            'instead.')
    k, v = sp_common.broadcast_gqa_if_indivisible(q, k, v, tp * sp)
    shards = sp_common.sp_partition(mesh, axis_name, q.shape[2])
    outs = ulysses_attention_shards(
        sp_common.shard(q, shards), sp_common.shard(k, shards),
        sp_common.shard(v, shards), [s.device for s in shards],
        causal=causal, sm_scale=float(sm_scale), axis_name=axis_name)
    return torch.cat([out.to(q.device) for out in outs], dim=2)
