"""skypilot_tpu_torch: the PyTorch/CUDA port of the model path.

A second package beside `skypilot_tpu/` (the JAX reference, which it
mirrors module for module): the same Llama/Gemma/Qwen decoders, the
paged-KV continuous-batching engine and its HTTP front, and the
single-GPU training step (losses, AdamW, remat), written in PyTorch for
an NVIDIA H100.  The five Pallas kernels of the reference (flash
attention forward and its two backward kernels, paged decode attention
in native dtype and int8) are CUDA C++ kernels under `csrc/`, built
with nvcc at first use and bound with ctypes; each keeps a
plain-PyTorch version beside it that runs on the CPU and is held
against the JAX package in the tests.

Every entry point takes an explicit `device` (default 'cuda') and
raises when no CUDA device is present unless the caller asks for the
CPU.  The package imports neither JAX nor `skypilot_tpu`.
"""
