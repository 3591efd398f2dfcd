"""Output head shared by the decode paths (mirrors
`skypilot_tpu/models/heads.py`)."""
from __future__ import annotations

import torch

from skypilot_tpu_torch.models.configs import ModelConfig


def unembed(x: torch.Tensor, model, cfg: ModelConfig) -> torch.Tensor:
    """[..., d] -> logits [..., V], always RETURNED in f32, with the
    matmul itself in f32 or the activation dtype per
    cfg.logits_in_f32 (tied: the embedding's transpose)."""
    mm_dtype = torch.float32 if cfg.logits_in_f32 else cfg.dtype
    if cfg.tie_embeddings:
        kernel = model.embed.embedding.to(mm_dtype).t()     # [d, V]
    else:
        kernel = model.lm_head.kernel.to(mm_dtype)
    logits = x.reshape(-1, x.shape[-1]).to(mm_dtype) @ kernel
    return logits.reshape(*x.shape[:-1], -1).to(torch.float32)
