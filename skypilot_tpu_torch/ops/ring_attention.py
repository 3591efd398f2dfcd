"""Ring attention: sequence-parallel attention over a slice mesh (mirrors
`skypilot_tpu/ops/ring_attention.py`).

The sequence is cut into `sp` shards, one on each device of the mesh's
sequence axis.  For `sp` steps every rank attends its q shard against
the k/v shard it currently holds, then hands that k/v shard to the
next rank (`.to(next_device, non_blocking=True)`, the counterpart of
the reference's `ppermute`; on a list that repeats one card it moves
nothing).  At step t rank r holds the shard of rank
kv_idx = (r - t) % sp, and with `causal`:
- kv_idx == r (the diagonal) runs the flash kernel causal;
- kv_idx < r (an earlier chunk) runs it non-causal;
- kv_idx > r (a later chunk) is fully masked and launches nothing.

Each hop is `ops.attention.flash_attention_with_lse`: the CUDA kernel
B3 on CUDA tensors, its plain version on CPU tensors.  The hops merge
in f32 as the reference merges them outside its Pallas kernel, with
PyTorch ops: lse_new = logaddexp(lse, lse_c), o = o * exp(lse -
lse_new) + o_c * exp(lse_c - lse_new), from o = 0 and lse = NEG_INF
(finite, so a fully masked row stays free of NaN).  A skipped hop's
merge would be the identity (its lse is NEG_INF), so it is not run.
The result is cast to q's dtype.

Per rank and call the kernel launches r + 1 times under `causal`, so a
causal ring launches sp (sp + 1) / 2 times; every hop launches without
`causal`.

Differentiable (sharded training, models/transformer.mesh_forward):
autograd runs back through the hops, each `.to` moving its gradient to
the rank that sent the shard, and the merge gives every hop's
`flash_attention_with_lse` an out and an lse cotangent, so the backward
kernels run once per hop that ran (non-causal on earlier chunks).  The
layer's checkpoint already recomputes the ring; no second one is taken
here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from skypilot_tpu_torch.ops import sp_common
from skypilot_tpu_torch.ops.attention import NEG_INF
from skypilot_tpu_torch.ops.attention import flash_attention_with_lse


def ring_attention_shards(qs: Sequence[torch.Tensor],
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor],
                          devices: Sequence[torch.device], *,
                          causal: bool, sm_scale: float
                          ) -> List[torch.Tensor]:
    """The ring over per-rank shards: qs[r], ks[r], vs[r] ([b, h, s/sp,
    d] and [b, h_kv, s/sp, d], contiguous) on devices[r].  Returns each
    rank's output shard on its device, in q's dtype."""
    sp = len(devices)
    o = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
         for q in qs]
    lse = [torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                      device=q.device) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for step in range(sp):
        for r in range(sp):
            kv_idx = (r - step) % sp
            if causal and kv_idx > r:
                continue   # a later chunk: fully masked
            o_c, lse_c = flash_attention_with_lse(
                qs[r], k_cur[r], v_cur[r],
                causal=causal and kv_idx == r, sm_scale=sm_scale)
            lse_new = torch.logaddexp(lse[r], lse_c)
            alpha = torch.exp(lse[r] - lse_new)
            beta = torch.exp(lse_c - lse_new)
            o[r] = (o[r] * alpha[..., None] +
                    o_c.to(torch.float32) * beta[..., None])
            lse[r] = lse_new
        if step + 1 < sp:
            # One hop around the ring: rank r receives rank r - 1's k/v.
            k_cur = [k_cur[r - 1].to(devices[r], non_blocking=True)
                     for r in range(sp)]
            v_cur = [v_cur[r - 1].to(devices[r], non_blocking=True)
                     for r in range(sp)]
    return [o_r.to(q.dtype) for o_r, q in zip(o, qs)]


def ring_attention(q, k, v, *, mesh, axis_name: str = 'sequence',
                   causal: bool = True, sm_scale: Optional[float] = None):
    """Sequence-parallel attention.

    Args:
      q, k, v: [batch, heads, seq, head_dim] GLOBAL tensors; seq must be
        divisible by the mesh's `axis_name` size.
      mesh: the port's Mesh (parallel/mesh.py).
    Returns the [batch, heads, seq, head_dim] output on q's device, in
    q's dtype.
    """
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if mesh is None or axis_name not in mesh.axis_names:
        # Degenerate slice without the axis: a one-hop ring IS the
        # plain flash kernel.
        out, _ = flash_attention_with_lse(q, k, v, causal=causal,
                                          sm_scale=float(sm_scale))
        return out
    shards = sp_common.sp_partition(mesh, axis_name, q.shape[2])
    outs = ring_attention_shards(
        sp_common.shard(q, shards), sp_common.shard(k, shards),
        sp_common.shard(v, shards), [s.device for s in shards],
        causal=causal, sm_scale=float(sm_scale))
    return torch.cat([out.to(q.device) for out in outs], dim=2)
