"""Device resolution for every entry point of the port.

Entry points take an explicit `device` that defaults to 'cuda'.  With
no CUDA device they raise instead of carrying on on the CPU: a serving
replica that silently ran on the host would answer at a fraction of
the speed and look healthy.  Tests pass device='cpu' explicitly.

TF32 is switched off for matmuls and cuDNN: the port is held against
the JAX reference in float32 (tiny presets), and TF32 keeps only ~10
mantissa bits, far outside the parity tolerances.  bf16 models are
unaffected (their matmuls are bf16 on the tensor cores either way).
"""
from __future__ import annotations

import contextlib
from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = 'cuda'


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    """'cuda' (default), 'cuda:N' or 'cpu' -> torch.device; raises when
    CUDA is asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: skypilot_tpu_torch runs on the GPU by '
                "default; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {device!r}; have cuda, cpu')
    return dev


def device_scope(device: torch.device):
    """Make `device` the calling thread's current CUDA device (a no-op
    on the CPU).  PyTorch keeps the current device and stream per
    thread, and the kernel wrappers launch on the current stream: a
    thread that runs device work outside the engine's worker (an HTTP or
    executor thread) enters this first instead of relying on defaults."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()
