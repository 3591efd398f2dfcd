"""Output head shared by the forward and the decode paths (mirrors
`skypilot_tpu/models/heads.py`).

A `TensorParallel` model's head is vocab-parallel: each rank holds the
lm_head columns (or tied embedding rows) of its vocab range and
computes its logits [..., V / tp] on its own device; the pieces are
concatenated in rank order on the device of the rows (rank 0's).  A
training mesh's row of tensor ranks (narrow models bound to their
slices) takes the same head through `unembed_ranks`."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models.configs import ModelConfig


def head_kernel(model, cfg: ModelConfig):
    """The lm-head kernel [d, V] in the logits matmul dtype (f32 or the
    activation dtype per cfg.logits_in_f32; tied: the embedding's
    transpose; int8: dequantized to that dtype, as the reference's
    maybe_dequant(kernel, mm_dtype)).  A TensorParallel model: one
    [d, V / tp] kernel per rank, on its device."""
    if isinstance(model, tensor_parallel.TensorParallel):
        return [head_kernel(rank, model.rank_cfg) for rank in model.ranks]
    mm_dtype = torch.float32 if cfg.logits_in_f32 else cfg.dtype
    if cfg.tie_embeddings:
        return model.embed.embedding.to(mm_dtype).t()
    return model.lm_head.matrix(mm_dtype)


def unembed(x: torch.Tensor, model, cfg: ModelConfig,
            kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., d] -> logits [..., V], always RETURNED in f32, with the
    matmul in `head_kernel`'s dtype (`kernel`: head_kernel's result,
    made once by a caller that unembeds in blocks).  A TensorParallel
    model: x is read on each rank's device (one copy a card) and the
    ranks' logits are joined on x's device."""
    if kernel is None:
        kernel = head_kernel(model, cfg)
    if isinstance(model, tensor_parallel.TensorParallel):
        return unembed_ranks(x, list(model.ranks), model.rank_cfg, kernel)
    logits = x.reshape(-1, x.shape[-1]).to(kernel.dtype) @ kernel
    return logits.reshape(*x.shape[:-1], -1).to(torch.float32)


def unembed_ranks(x: torch.Tensor, ranks: Sequence, rcfg: ModelConfig,
                  kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    """The vocab-parallel head over a row of tensor ranks (their narrow
    models `ranks` of config `rcfg` and `head_kernel`s `kernels`): x is
    read on each rank's device (one copy a card) and the ranks' logits
    are joined in rank order on x's device.  One rank is the plain
    head."""
    if len(ranks) == 1:
        return unembed(x, ranks[0], rcfg, kernels[0])
    xs = tensor_parallel.on_cards(x, [k.device for k in kernels])
    return torch.cat([unembed(xr, rank, rcfg, k).to(x.device)
                      for xr, rank, k in zip(xs, ranks, kernels)], dim=-1)
