"""Attention ops of the port: a hand-written CUDA kernel behind each,
with its plain PyTorch version for CPU tensors.  Paged decode
attention lives in `ops/paged_attention.py`."""
from skypilot_tpu_torch.ops.attention import flash_attention
from skypilot_tpu_torch.ops.attention import flash_attention_with_lse

__all__ = ['flash_attention', 'flash_attention_with_lse']
