"""Output head shared by the forward and the decode paths (mirrors
`skypilot_tpu/models/heads.py`)."""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.models.configs import ModelConfig


def head_kernel(model, cfg: ModelConfig) -> torch.Tensor:
    """The lm-head kernel [d, V] in the logits matmul dtype (f32 or the
    activation dtype per cfg.logits_in_f32; tied: the embedding's
    transpose; int8: dequantized to that dtype, as the reference's
    maybe_dequant(kernel, mm_dtype))."""
    mm_dtype = torch.float32 if cfg.logits_in_f32 else cfg.dtype
    if cfg.tie_embeddings:
        return model.embed.embedding.to(mm_dtype).t()
    return model.lm_head.matrix(mm_dtype)


def unembed(x: torch.Tensor, model, cfg: ModelConfig,
            kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., d] -> logits [..., V], always RETURNED in f32, with the
    matmul in `head_kernel`'s dtype (`kernel`: head_kernel's result,
    made once by a caller that unembeds in blocks)."""
    if kernel is None:
        kernel = head_kernel(model, cfg)
    logits = x.reshape(-1, x.shape[-1]).to(kernel.dtype) @ kernel
    return logits.reshape(*x.shape[:-1], -1).to(torch.float32)
