#!/usr/bin/env python3
"""Drive the PyTorch port (skypilot_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each one that fails makes the script exit non-zero):

1. The device: CUDA must be present; prints the card's name and power
   limit as `nvidia-smi --query-gpu=name,power.limit` gives them.
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per
   source, in parallel) and prints the build seconds; then, for every
   kernel instantiation (flash and paged), ptxas's registers, stack
   and spills and the HGMMA / HMMA / FFMA counts of `cuobjdump -sass`
   (a wgmma kernel without HGMMA, or a wgmma or paged kernel with
   spills, fails the run).
3. Kernel parity on the card at the Llama-3-8B shapes (h_q 32, h_kv 8,
   d 128, bf16, page size 16): B1 paged decode and B2 int8 paged decode
   (one split-context kernel: splits of `split_pages` pages merged in
   order) with
   ragged lengths (1, 15, 16, 17, 1000), S = 1 and S = 5, tables that
   include the null page, and a full batch of 8 slots at 1000 (two
   launches bit-equal); B3 flash forward at q_len 1, 100, 512
   and q_len < k_len, at the training shape (b 2 x 2048) and at
   `small`'s (16/8, d 64, b 8 x 512); one f32 case each.  B4 (dQ) and
   B5 (dK/dV) flash
   backward with a random output cotangent and a non-zero LSE
   cotangent: the training shape (b 2, 2048), ragged 100 and 1000,
   q 100 < k 612, Qwen2's group (28/4, rep 7), Gemma's (8/1, d 256),
   d 64 (`small`), one f32 and one non-causal case; two launches must
   give the same bits.  Each kernel is held against its plain PyTorch
   version on the same inputs: bf16 outputs within atol/rtol 2e-2
   (compared as f32; both accumulate in f32, in different orders), f32
   within 1e-4, the LSE within 1e-3; backward gradients within the same
   2e-2 / 1e-4 of the plain version's largest |value|.  A kernel's
   `ms` and the `library_ms` of its PyTorch yardstick are device time:
   the summed durations of the kernels 20 calls launch, after 3
   warm-up calls, in a torch.profiler trace, over 20; `ms_with_host`
   (CUDA events around the same 20 calls) keeps the host's launch work,
   and the plain version is timed that way.  B3 is timed at the
   training shape and the 512-token chunk, B1 (S = 1) and B2 (S = 5)
   at the ragged lengths and the full batch.  Bounds from this run's
   bytes and FLOPs against 3.35 TB/s and 989 TFLOP/s (H100 SXM data
   sheet), labelled by whichever of the two is larger.  B4/B5 are timed at the training
   shape; their plain version computes dQ, dK and dV together, and so
   does their yardstick, SDPA's backward (the device time of fwd + bwd
   minus fwd's).
4. The serving path: ModelServer('llama3-8b') with seeded random
   weights at full width and depth, paged continuous batching,
   answering concurrent POST /generate requests over HTTP (greedy, one
   seeded sampled request, then prefix-cache hits); then an int8-KV
   engine with speculative decoding (k = 4) on the same weights, whose
   greedy tokens must equal the same int8 engine's with speculation
   off.  Launch counts are zeroed just before and read just after:
   every serving kernel must have run on it.
   Then, on the same server before it closes, the observability plane
   in two windows, each with its own launch counts, zeroed just before
   its requests and read just after its route reads: "observability"
   on phase 4's bf16 pool (B1, B3), then "observability (int8 pool)" on
   a second server with an int8 pool over the same weights (B2, B3).
   Each window: 6 concurrent /generate requests with client-chosen
   X-SkyTPU-Request-Ids (each echoed).
   /metrics parses, and once the engine is idle its ticks and decode
   tokens grew by what engine.stats() counted, the TTFT histogram by 6;
   /spans holds one engine segment per id (status ok, TTFT within the
   duration, queue -> prefill -> decode in order without overlap,
   tokens as returned); /profile a non-empty ring of the reference's
   phases, each tick's phases within its duration, memory within the
   allocator's peak; /logs one access record per id.  After the
   windows, in this thread on identical inputs (clones of one cache
   and state), the sentinel-wrapped step and prefill between
   begin_tick / lap / end_tick launch the bare entries' kernels
   (`serve/plane_check.py`: per-call kernel-name multisets from
   torch.profiler and B1/B2/B3 counts equal).  Then an
   engine with SKYTPU_PROFILE_DISABLE=1 on the same weights gives the
   same greedy tokens as the server's engine on two prompt sets new to
   both (off, on, on, off).  The host ms a tick of each, the tick
   profile and the plane's modeled cost are printed, never held: which
   ticks admit or prefill is up to the worker thread's timing.
5. More serving paths on the same 8B weights, each with its own launch
   counts, zeroed just before it and read just after:
   - "replica front": a paged server behind the asyncio front
     (`async_server.start_background`): greedy /generate, 5 concurrent
     /generate_stream, a batch-class request (the class's
     max_new_tokens set to 8 through SKYTPU_QOS_SPEC), POST
     /role_budget decode then a 24-token prompt (prefill pieces of one
     token: B3's chunk 0 at the 16 bucket, then 22 width-1 masked
     continuations) then mixed, POST /drain with a stream in flight
     (/generate must answer 503 + Retry-After while the stream ends
     with all its tokens), and a stream whose client hangs up after
     two events (its span must read 'cancelled', the busy slots and the
     pages held beyond the prefix cache's must come back to their
     baseline within 120 s).  B1 and B3 must run, B2 must not.  After
     the read, the threaded front of a second server on the same
     weights serves the same prompts (new to both, so no prefix hit
     changes what runs), unclamped: /generate, the streams and the
     drained stream must give equal tokens, the batch request the first
     8 of its prompt's; the decode-budget prompt equal tokens or, where
     they part, every token held at its own context as below (its
     pieces ran the masked path, the reference's prefill the flash
     kernel).  TTFT, tokens/s and ms are printed, never held.
   - "spec beyond one bucket": the int8 + spec engine at 16 slots,
     k = 4 (an 80-row verify tick, two 64-row blocks), counted alone;
     greedy tokens must equal those of spec-off, run after the read.  Then one verify tick timed in its blocks
     and as one 128-row call (what the blocks cost).
   - "dense serving": ModelServer in the reference's default mode
     (continuous batching, no --kv-pages: the dense slot cache) over
     HTTP: 6 concurrent /generate requests (tokens/s), TTFT of a
     100-token prompt, /generate_stream (equal to /generate) and
     /generate_text (streamed text equal to the whole).  B3 must run,
     B1 and B2 must not.
   - "legacy": the un-pipelined loop (pipelined=False) on the same
     prompts.
   - "handoff": a prefill engine (paged bf16) exports a 100-token
     prompt through the binary frame (B3 must run there, and no paged
     kernel); a decode engine (paged bf16, then an int8 pool) imports
     it and generates (B1, then B2, must run there).
   Each window holds the engine work only: the reference paths and the
   checks run after its counts are read.  Then, outside the windows:
   each decode engine serves the prompt again while a single engine of
   its pool type serves it at the same time, each engine on its own
   CUDA stream (the two streams' paged launches overlap): the decode
   engine's tokens must equal its own from the window, and every
   ticket counter must read 0 after.  Every generated token is held
   at its own context (teacher forcing): under the logits of one flash
   forward of prompt + tokens, each token is the argmax at its
   position or within twice the largest logit difference between that
   forward and the masked einsum path on the same tokens (for an int8
   pool, that path's k/v go through the pool's quantizer).  The
   reference path's tokens (dense: decode.generate; legacy: the dense
   pipelined engine; handoff: the single engine) say where the two
   part.
5b. Real weights (models/quantize.py, models/import_weights.py,
   data/checkpoints.py), each path with its own launch counts:
   - quantize_params over a depth-1 full-width llama3-8b f32 tree on
     the card equals the same call on the CPU, byte for byte.
   - "int8 weights": ModelServer('llama3-8b', quantize='int8') at full
     width and depth (seeded init quantized on the card leaf by leaf,
     paged, 1024 pages) answers 6 concurrent greedy /generate requests;
     its weights' GiB are printed beside the bf16 model's.  After the
     read, a server on the bf16 model whose kernels are the dequantized
     values (`convert.dequantize_model`, computed once) answers the same
     requests: the tokens must be equal (both GEMMs see the same bf16
     operands).  Then the int8 and the bf16 paged ticks are timed with
     profile_decode's method (printed, not held).  B1 and B3 must run,
     B2 must not.
   - "checkpoint": a seeded depth-2 llama3-8b-width model whose values
     are all bf16 values is written as an HF source (HF names, [out, in],
     rotate-half q/k rows, BF16, config.json, a tiny SentencePiece
     tokenizer.model) with the port's safetensors writer;
     `import_weights.convert` makes step 0, whose restore must equal the
     writer bit for bit; ModelServer('auto', checkpoint_dir=...) answers
     /generate and /generate_text, a second seed is saved as step 1 and
     POST /weights_swap must answer weight_version 1.  After the read,
     in-memory servers on the same weights must give the same tokens
     (and /generate_text the tokenizer's decode of them).  The
     temporary directories are deleted as soon as they are not needed;
     the disk use, convert and restore seconds are printed.
5c. MoE: mixtral-8x7b at full width (d_model 4096, 32/8 heads,
   head_dim 128, d_ff 14336, 8 experts, top-2, vocab 32000), its 32
   layers cut to 8 (2.90 GB a layer in bf16: 32 would not fit the
   card's 80 GB), seeded bf16 weights, after the 8B models are freed.
   Three windows, each with its own launch counts, zeroed just before
   its requests and read just after: "moe paged" (ModelServer
   ('mixtral-8x7b'), paged, 1024 pages of 16, max_len 1024, 8 slots),
   "moe int8 pool" (the same with int8 KV) and "moe dense" (the dense
   slot cache).  Each answers 6 concurrent greedy /generate requests of
   5-700 tokens and one seeded sampled request, 32 new tokens each,
   then the 100-token prompt again (the same tokens, and no prefix
   entry: MoE prefill couples every prompt token, so pages never
   share).  Each prompt prefills whole, so B3 must run exactly once per
   prompt and layer; B1 only on the bf16 pool, B2 only on the int8
   pool, neither in dense mode.  After the windows every greedy token
   is held at its own context as in phase 5, the forward computing the
   MoE blocks as the engine does (the capacity dispatch over the
   prompt's rows, the dense gather over each generated row); the
   (token, expert) assignments the prefill dispatch dropped are
   printed per prompt.  Printed, not held: the paged MoE tick at 8
   slots (`profile_decode.profile_tick`: host ms, device ms, kernels)
   and the f32 expert casts' ms a tick, by CUDA events (the
   reference's decode ticks compute every expert in f32).  "moe checkpoint": a depth-1
   Mixtral-width HF source (the port's writer, BF16) ->
   `import_weights.convert` -> ModelServer('auto') answers /generate
   (B1, B3), the directories deleted once read; after the read an
   in-memory server on the writer's weights must give the same tokens.
   Then a depth-1 f32 cut served on the GPU (kernels) and the CPU
   (plain versions) from the same weights must give the same greedy
   tokens for 2 prompts, paged and dense.
6. A reference check: a depth-2, f32 cut of llama3-8b served on the
   GPU (CUDA kernels) and on the CPU (the plain versions) from the same
   weights must give the same greedy tokens, paged and dense engines.
7. The training path: llama3-8b at full width cut to 4 layers, seeded
   random trainable weights (f32 master copy, bf16 compute), batch
   2 x 2048, TrainConfig() defaults, 2 warm-up and 5 timed
   `train_step`s on one repeated batch: step ms, tokens/s, peak memory,
   the loss per step (finite and falling), one profiled step (its wall
   time, device busy time and idle share, all from the one trace).
   Launch counts are zeroed just before and read
   just after: B3 must run 2L times a step (forward and its remat
   recompute), B4 and B5 L times.  Then 2 steps with fused CE and
   accum_steps = 2 from the same initial weights, whose step-1 loss and
   grad_norm must equal the unfused run's within 1e-3 relative; then
   the CLI, `train_llama --model small` (d 64 kernels) for 3 steps.
7b. Training resume (data/loader.py, data/prefetch.py, the training
   half of data/checkpoints.py, callbacks/): llama3-8b at full width
   (d_model 4096, 32/8 heads, head_dim 128, d_ff 14336, vocab 128256),
   depth cut 32 -> 1 (a training step is 12 B a parameter: 15.2 GB on
   disk and in host RAM at depth 1), batch 2 x 2048.  A seeded token
   file (4,194,304 ids, uint32) and a depth-1 HF source written with the
   port's safetensors writer, converted into an init directory; then
   `train_llama.run` with `--model auto --init-from <init> --data
   <tokens>`: run U (5 steps, no checkpoint directory), run A
   (SKYTPU_CHECKPOINT_DIR set, 1 step: saves step 0, on the 10-step
   interval), run B (the same directory, 5 steps: resumes at 1).  Held:
   A's step-0 loss equal to U's; B's losses for steps 1-4 within 1e-5
   relative of U's (the largest difference and whether they are
   bit-equal printed); the state `restore_or_init` restores bit-equal
   to run A's final state (every parameter, both moments, the counts);
   the prefetched batches equal `batch_at` for steps 0 and 1;
   ModelServer('auto', checkpoint_dir=<ckpt>) restores the step's
   params bit-equal to the in-memory cast and answers /generate with an
   in-memory server's greedy tokens (2 prompts).  Launch counts are
   zeroed just before U and read just after B ("training resume"): B3
   exactly 20, B4 and B5 exactly 10 (10 steps, 2L / L / L).  Printed
   with the card: convert, checkpoint write (the save histogram),
   blocked and restore seconds, each run's summary.json
   (compute_seconds_per_step, data_wait_seconds, prefetch_wait_seconds,
   peak memory), the free disk before and the disk used at peak, the
   phase's seconds.  Every temporary directory is deleted.
8. A training reference check: depth-1 f32 llama3-8b, one 256-token
   sequence, loss.backward() on the GPU (kernels) and on the CPU (the
   plain versions) from the same weights: the loss and every gradient
   within 1e-3 of the CPU's largest |value| for that leaf.

The line before the last is the `kernels` JSON: each kernel's
`launches` is its count on the path `path` names (serving for B1/B2,
"training resume" for B3/B4/B5), and `launches_by_path` holds every
driven path's own count (serving, the two observability windows, the
five paths of phase 5, "int8 weights" and "checkpoint" of phase 5b,
the four MoE paths of phase 5c, training, `train_llama small`,
"training resume"), each path
zeroed just before it and read just after.  B3's entry carries the
512-token chunk under `serving_chunk`, B1's and B2's the full batch
under `full_batch`, and B1's and B2's their split span in pages,
`split_pages`.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense tensor cores
F32_FLOPS = 67e12               # outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], check=True,
                          capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def is_device_event(e) -> bool:
    """A profiler event that ran on the card (a kernel, memcpy or
    memset); a user annotation spans kernels that are counted alone."""
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA and
            not getattr(e, 'is_user_annotation', False))


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: the summed durations of every kernel that
    `iters` calls launch (torch.profiler, CUDA activity), over `iters`,
    after `warmup` calls.  Unlike `time_ms` it holds no host time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if is_device_event(e))
    if us <= 0:
        raise AssertionError('device_ms: the profiler saw no device time')
    return us / 1e3 / iters


def timed_call(fn) -> dict:
    """{'ms': device time per call, 'ms_with_host': CUDA-event time per
    call, the host's launch work included}."""
    return {'ms': device_ms(fn), 'ms_with_host': time_ms(fn)}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_summary(r) -> str:
    """One kernel's times: device ms with its roofline share, the
    CUDA-event ms with the host, plain and library ms, bound."""
    return (f'{r["ms"]:.4f} ms device ({100 * r["bound_ms"] / r["ms"]:.1f}% '
            f'of the bound), {r["ms_with_host"]:.4f} ms per call with host; '
            f'plain {r["plain_ms"]:.4f}, bound {r["bound_ms"]:.4f} by '
            f'{r["bound_by"]}, library {r["library_ms"]}')


def check_close(name, out, ref, tol) -> float:
    import torch
    err = max_err(out, ref)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f'{name}: non-finite output')
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol,
                               msg=lambda m: f'{name}: {m}')
    return err


def zero_counts(counters) -> None:
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for table in counters.values():
        for key in table:
            table[key] = 0


def read_counts(counters) -> dict:
    """{kernel: launches since the last zero_counts}."""
    return {name: table[name] for name, table in counters.items()}


# ------------------------------------------------------------ phase 2


def kernel_label(mangled: str) -> str:
    """`flash_fwd_wgmma_kernel<bf16, d 128>` from a mangled name;
    `paged_decode_split_kernel<bf16, int8 pool, d 128>` for B2."""
    name = re.search(r'\d+((?:flash|paged)_[a-z0-9_]*kernel)', mangled)
    d = re.search(r'Li(\d+)E', mangled)
    if not name or not d:
        return mangled
    # wgmma kernels are bf16 only and the scalar forward f32 only; the
    # scalar backward and the paged kernels carry their (query) type,
    # the paged kernel then its pool's (int8_t mangles as 'a').
    types = mangled.split('Li')[0]
    dtype = ('bf16' if 'wgmma' in mangled or '__nv_bfloat16' in types
             else 'f32')
    pool = 'int8 pool, ' if types.endswith('a') else ''
    return f'{name.group(1)}<{dtype}, {pool}d {d.group(1)}>'


def compiled_report(build) -> None:
    """What nvcc made of every kernel: per kernel instantiation, ptxas's
    registers, stack and spills (from the build log) and the tensor-core
    (HGMMA, HMMA) and scalar FMA (FFMA) instructions in `cuobjdump
    -sass`.  Fails if a wgmma kernel has no HGMMA or spills."""
    import os
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
    for source in ('flash_fwd', 'flash_bwd', 'paged_attention'):
        ptxas, fn = {}, None
        for line in build.build_log(source).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill '
                          r'stores, (\d+) bytes spill loads', line)
            if m and fn:
                ptxas[fn] = dict(stack=int(m.group(1)),
                                 spills=int(m.group(2)) + int(m.group(3)))
            m = re.search(r'Used (\d+) registers', line)
            if m and fn:
                ptxas.setdefault(fn, {})['registers'] = int(m.group(1))
                fn = None
        sass = subprocess.run([cuobjdump, '-sass', build.library_path(source)],
                              check=True, capture_output=True,
                              text=True).stdout
        ops, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r'Function : (\S+)', line)
            if m:
                fn = m.group(1)
                ops[fn] = dict(HGMMA=0, HMMA=0, FFMA=0)
            elif fn:
                for op in ops[fn]:
                    ops[fn][op] += bool(re.search(rf'\b{op}\b', line))
        for fn in sorted(ops, key=kernel_label):
            log(f'  {source}: {kernel_label(fn)}: ptxas {ptxas.get(fn)}; '
                f'sass {ops[fn]}')
            if 'wgmma' in fn and ops[fn]['HGMMA'] == 0:
                raise AssertionError(f'{kernel_label(fn)}: no HGMMA in its '
                                     'SASS')
            if (('wgmma' in fn or 'paged' in fn) and
                    (ptxas.get(fn) or {}).get('spills')):
                raise AssertionError(f'{kernel_label(fn)}: spills '
                                     f'{ptxas[fn]}')


# ------------------------------------------------------------ phase 3


# Slot lengths of the paged cases: ragged (the timed tick) and a full
# batch of 8 slots at 1000 positions, as the 1024-token server holds it.
PAGED_RAGGED = [1, 15, 16, 17, 1000]
PAGED_FULL = [1000] * 8


def paged_case(dev, dtype, quantized, s_q, seed, lengths=PAGED_RAGGED):
    """Pool, q, tables, lengths at the 8B decode shapes."""
    import torch
    from skypilot_tpu_torch.models import decode
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h_q, h_kv, d, ps, rows = len(lengths), 32, 8, 128, 16, 64
    n_pages = 1 + b * rows
    kshape = (n_pages, h_kv, ps, d)
    k = torch.randn(kshape, generator=gen, device=dev)
    v = torch.randn(kshape, generator=gen, device=dev)
    if quantized:
        kq, ks = decode._quant_kv(k)  # pylint: disable=protected-access
        vq, vs = decode._quant_kv(v)  # pylint: disable=protected-access
        k_leaf, v_leaf = {'q': kq, 'scale': ks}, {'q': vq, 'scale': vs}
    else:
        k_leaf, v_leaf = k.to(dtype), v.to(dtype)
    tables = torch.zeros((b, rows), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    for i, length in enumerate(lengths):
        need = -(-(length + s_q) // ps)
        tables[i, :need] = perm[i * rows:i * rows + need].to(torch.int32)
    tables[0, 0] = 0                    # a live row on the null page
    q = torch.randn((b, h_q, s_q, d), generator=gen, device=dev).to(dtype)
    return (q, k_leaf, v_leaf, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def bound(n_bytes, flops, peak):
    """(bound_ms, bound_by): the larger of the bytes' time over the
    memory rate and the operations' time over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def paged_bound(q, k_leaf, tables, lengths, quantized):
    b, h_q, s_q, d = q.shape
    pool = k_leaf['q'] if quantized else k_leaf
    h_kv, ps = pool.shape[1], pool.shape[2]
    pages = sum(min(tables.shape[1], -(-(int(n) + s_q) // ps))
                for n in lengths.tolist())
    per_token = d * pool.element_size() + (4 if quantized else 0)
    kv_bytes = 2 * pages * h_kv * ps * per_token
    io_bytes = 2 * q.numel() * q.element_size() + tables.numel() * 4 + b * 4
    keys = sum(int(n) + s_q for n in lengths.tolist())
    flops = 4 * h_q * s_q * keys * d
    peak = F32_FLOPS if q.dtype.itemsize == 4 else BF16_FLOPS
    return bound(kv_bytes + io_bytes, flops, peak)


def check_paged(dev, quantized):
    """B1 or B2 against its plain version (bf16 S = 1 and 5, f32 S = 5 on
    the ragged lengths, the timed dtype and S on the full batch); two
    launches must give the same bits.  Timed at the main path's tick (S
    = 1 native, S = 5 (spec) int8) on the ragged lengths, with the full
    batch under `full_batch`; both record their split span."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    errs = []
    timed = {}
    s_main = 5 if quantized else 1
    cases = [(torch.bfloat16, 1, PAGED_RAGGED), (torch.bfloat16, 5,
                                                 PAGED_RAGGED),
             (torch.float32, 5, PAGED_RAGGED),
             (torch.bfloat16, s_main, PAGED_FULL)]
    for dtype, s_q, lens in cases:
        q, kl, vl, tables, lengths = paged_case(dev, dtype, quantized, s_q,
                                                seed=s_q, lengths=lens)
        scale = q.shape[-1] ** -0.5
        out = pa.paged_attention(q, kl, vl, tables, lengths)
        again = pa.paged_attention(q, kl, vl, tables, lengths)
        ref = pa._paged_attention_reference(  # pylint: disable=protected-access
            q, kl, vl, tables, lengths, sm_scale=scale)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        shape = ('full batch 8 x 1000' if lens is PAGED_FULL else
                 f'lengths {lens}')
        name = f'paged{"_int8" if quantized else ""} {dtype} S={s_q} {shape}'
        if not torch.equal(out, again):
            raise AssertionError(f'{name}: two launches differ')
        errs.append(check_close(name, out, ref, tol))
        log(f'  {name}: max_abs_err {errs[-1]:.3g} (tol {tol}); two '
            'launches bit-equal')
        if dtype == torch.bfloat16 and s_q == s_main:
            timed[lens is PAGED_FULL] = (q, kl, vl, tables, lengths, scale)
    shapes = {}
    for full, (q, kl, vl, tables, lengths, scale) in timed.items():
        kernel = timed_call(lambda: pa.paged_attention(q, kl, vl, tables,
                                                       lengths))
        plain = time_ms(lambda: pa._paged_attention_reference(  # pylint: disable=protected-access
            q, kl, vl, tables, lengths, sm_scale=scale))
        bound_ms, bound_by = paged_bound(q, kl, tables, lengths, quantized)
        shapes[full] = dict(max_abs_err=max(errs), **kernel, plain_ms=plain,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
    return dict(shapes[False], full_batch=shapes[True],
                split_pages=pa.SPLIT_PAGES)


# (dtype, b, h, h_kv, d, q_len, k_len) of B3 against its plain version:
# 8B serving prefill chunks (ragged, q_len < k_len, one f32), the
# training shape (b 2 x 2048) and `train_llama --model small`'s (16/8,
# d 64, b 8 x 512).  The 512-token chunk and the training shape are
# the ones timed.
FLASH_CASES = [
    ('bf16', 1, 32, 8, 128, 1, 1),
    ('bf16', 1, 32, 8, 128, 100, 100),
    ('bf16', 1, 32, 8, 128, 512, 512),
    ('bf16', 1, 32, 8, 128, 100, 612),
    ('f32', 1, 32, 8, 128, 100, 100),
    ('bf16', 2, 32, 8, 128, 2048, 2048),
    ('bf16', 8, 16, 8, 64, 512, 512),
]


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import attention
    dtypes = {'bf16': torch.bfloat16, 'f32': torch.float32}
    errs = []
    cases = {}
    for dt, b, h, h_kv, d, q_len, k_len in FLASH_CASES:
        dtype = dtypes[dt]
        gen = torch.Generator(device=dev).manual_seed(q_len + k_len)
        q = torch.randn((b, h, q_len, d), generator=gen, device=dev)
        k = torch.randn((b, h_kv, k_len, d), generator=gen, device=dev)
        v = torch.randn((b, h_kv, k_len, d), generator=gen, device=dev)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        out, lse = attention.flash_attention_with_lse(q, k, v)
        ref, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=True, sm_scale=d ** -0.5, return_lse=True)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = (f'flash {dt} b={b} h={h}/{h_kv} d={d} q_len={q_len} '
                f'k_len={k_len}')
        errs.append(check_close(name, out, ref, tol))
        check_close(name + ' lse', lse, ref_lse, 1e-3)
        log(f'  {name}: max_abs_err {errs[-1]:.3g} (tol {tol})')
        if dt == 'bf16' and d == 128 and q_len == k_len and \
                (b, q_len) in ((1, 512), (TRAIN_BATCH, TRAIN_SEQ)):
            cases[q_len] = (q, k, v)
    # The 512-token serving chunk and the training shape; the kernels
    # line carries the training shape (B3's launches are the training
    # path's), the chunk rides along under `serving_chunk`.
    shapes = {}
    for n, (q, k, v) in cases.items():
        b, h, _, d = q.shape
        kernel = timed_call(lambda: attention.flash_attention(q, k, v))
        plain = time_ms(lambda: attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=True, sm_scale=d ** -0.5))
        library = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        flops = 4 * d * visible_entries(b, h, n, n, True)
        io = ((2 * q.numel() + 2 * k.numel()) * q.element_size() +
              b * h * n * 4)
        bound_ms, bound_by = bound(io, flops, BF16_FLOPS)
        shapes[n] = dict(max_abs_err=max(errs), **kernel, plain_ms=plain,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library)
    return dict(shapes[TRAIN_SEQ], serving_chunk=shapes[512])


# (dtype, b, h, h_kv, d, q_len, k_len, causal); the first is the
# training shape and is the one timed.
BWD_CASES = [
    ('bf16', 2, 32, 8, 128, 2048, 2048, True),
    ('bf16', 1, 32, 8, 128, 100, 100, True),
    ('bf16', 1, 32, 8, 128, 1000, 1000, True),
    ('bf16', 1, 32, 8, 128, 100, 612, True),
    ('bf16', 1, 28, 4, 128, 300, 300, True),      # Qwen2's group, rep 7
    ('bf16', 1, 8, 1, 256, 300, 300, True),       # Gemma's, rep 8, d 256
    ('bf16', 2, 16, 8, 64, 512, 512, True),       # small, d 64
    ('f32', 1, 32, 8, 128, 100, 100, True),
    ('bf16', 1, 32, 8, 128, 300, 300, False),
]


def bwd_inputs(dev, dtype, b, h, h_kv, d, q_len, k_len, causal, seed):
    """q, k, v, the forward's out and lse, a random output cotangent g
    and a non-zero LSE cotangent."""
    import torch
    from skypilot_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((b, h, q_len, d), (b, h_kv, k_len, d),
                                (b, h_kv, k_len, d), (b, h, q_len, d)))
    g_lse = torch.randn((b, h, q_len), generator=gen, device=dev)
    out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, out, lse, g, g_lse


def visible_entries(b, h, q_len, k_len, causal) -> int:
    """Score entries the mask keeps: b * h * sum over query rows of the
    keys each sees."""
    if not causal:
        return b * h * q_len * k_len
    off = k_len - q_len
    return b * h * (q_len * off + q_len * (q_len + 1) // 2)


def bwd_bound(q, k, n_products, out_numel):
    """Bound of a backward kernel: n_products products of 2 d FLOPs per
    visible score entry; bytes of q, dO, k, v, lse and delta read once
    and out_numel gradient elements written once."""
    b, h, q_len, d = q.shape
    entries = visible_entries(b, h, q_len, k.shape[2], True)
    n_bytes = ((2 * q.numel() + 2 * k.numel() + out_numel) *
               q.element_size() + 2 * b * h * q_len * 4)
    peak = F32_FLOPS if q.dtype.itemsize == 4 else BF16_FLOPS
    return bound(n_bytes, n_products * 2 * d * entries, peak)


def check_flash_bwd(dev):
    """B4 and B5 against _flash_bwd_reference; -> {name: result}, timed
    at the training shape."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import attention
    dtypes = {'bf16': torch.bfloat16, 'f32': torch.float32}
    errs = {'flash_bwd_dq': [], 'flash_bwd_dkv': []}
    timed = None
    for i, (dt, b, h, h_kv, d, q_len, k_len, causal) in enumerate(BWD_CASES):
        dtype = dtypes[dt]
        args = bwd_inputs(dev, dtype, b, h, h_kv, d, q_len, k_len, causal,
                          seed=100 + i)
        kw = dict(causal=causal, sm_scale=d ** -0.5)
        got = attention._flash_bwd_cuda(*args, **kw)  # pylint: disable=protected-access
        again = attention._flash_bwd_cuda(*args, **kw)  # pylint: disable=protected-access
        ref = attention._flash_bwd_reference(*args, **kw)  # pylint: disable=protected-access
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = (f'flash_bwd {dt} b={b} h={h}/{h_kv} d={d} q_len={q_len} '
                f'k_len={k_len}{"" if causal else " non-causal"}')
        rels = []
        for grad, a, a2, r in zip(('dq', 'dk', 'dv'), got, again, ref):
            if not torch.equal(a, a2):
                raise AssertionError(f'{name} {grad}: two launches differ')
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f'{name} {grad}: non-finite output')
            err = max_err(a, r)
            rel = err / max(float(r.float().abs().max()), 1e-30)
            if rel > tol:
                raise AssertionError(f'{name} {grad}: max err {err:.3g} is '
                                     f'{rel:.3g} of max |ref| (tol {tol})')
            errs['flash_bwd_dq' if grad == 'dq' else
                 'flash_bwd_dkv'].append(err)
            rels.append(rel)
        log(f'  {name}: rel err dq/dk/dv '
            f'{" ".join(f"{x:.2g}" for x in rels)} (tol {tol}); two '
            f'launches bit-equal')
        if i == 0:
            timed = args
    q, k, v, out, lse, g, g_lse = timed
    kw = dict(causal=True, sm_scale=q.shape[-1] ** -0.5)
    delta = attention._delta(out, g, g_lse).contiguous()  # pylint: disable=protected-access
    dq = timed_call(lambda: attention._flash_bwd_dq_cuda(  # pylint: disable=protected-access
        q, k, v, g, lse, delta, **kw))
    dkv = timed_call(lambda: attention._flash_bwd_dkv_cuda(  # pylint: disable=protected-access
        q, k, v, g, lse, delta, **kw))
    plain = time_ms(lambda: attention._flash_bwd_reference(  # pylint: disable=protected-access
        q, k, v, out, lse, g, g_lse, **kw))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=True)
    # SDPA's backward: the device time of forward + backward less the
    # forward's.
    sdpa_bwd = (device_ms(lambda: torch.autograd.grad(sdpa(), leaves, g)) -
                device_ms(sdpa))
    results = {}
    for name, kernel, n_products, out_numel in (
            ('flash_bwd_dq', dq, 3, q.numel()),
            ('flash_bwd_dkv', dkv, 4, 2 * k.numel())):
        bound_ms, bound_by = bwd_bound(q, k, n_products, out_numel)
        results[name] = dict(max_abs_err=max(errs[name]), **kernel,
                             plain_ms=plain, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=sdpa_bwd)
    return results


# ------------------------------------------------------------ phase 4


def http_call(port, path, rid=None, body=None):
    """(status, echoed X-SkyTPU-Request-Id, body bytes) of a GET, or of
    a JSON POST when `body` is given."""
    from skypilot_tpu_torch.serve import http_protocol
    headers = {http_protocol.REQUEST_ID_HEADER: rid} if rid else {}
    data = None
    if body is not None:
        headers['Content-Type'] = 'application/json'
        data = json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=600) as resp:
        return (resp.status, resp.headers.get(
            http_protocol.REQUEST_ID_HEADER), resp.read())


def post(port, body):
    from skypilot_tpu_torch.serve import http_protocol
    status, _, raw = http_call(port, http_protocol.GENERATE, body=body)
    return status, json.loads(raw)


def prompt(seed, n, vocab):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=gen).tolist()


def serve_over_http(server, vocab, new_tokens):
    """Concurrent /generate round, then a prefix-hit round."""
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    port, stop = model_server.start_background(server)
    try:
        with urllib.request.urlopen(
                f'http://127.0.0.1:{port}{http_protocol.HEALTH}',
                timeout=60) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health['status'] != 'ok':
            raise AssertionError(f'/health: {resp.status} {health}')
        lengths = [5, 37, 64, 100, 250, 700]
        bodies = [{'prompt_ids': [prompt(i, n, vocab)],
                   'max_new_tokens': new_tokens} for i, n in
                  enumerate(lengths)]
        bodies[2].update(temperature=0.8, top_k=40, seed=7)
        # Prefix hits: the 100- and 250-token prompts again, new tails.
        hits = [{'prompt_ids': [bodies[i]['prompt_ids'][0][:96] +
                                prompt(50 + i, 9, vocab)],
                 'max_new_tokens': new_tokens} for i in (3, 4)]
        results = [None] * len(bodies)

        def run(i):
            results[i] = post(port, bodies[i])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        hit_results = [post(port, body) for body in hits]
    finally:
        stop()
    for (code, out), body in zip(results + hit_results, bodies + hits):
        toks = out['tokens']
        if code != 200 or len(toks) != 1 or len(toks[0]) != new_tokens:
            raise AssertionError(f'/generate {code}: {out}')
        if not all(0 <= t < vocab for t in toks[0]):
            raise AssertionError(f'out-of-vocab tokens: {toks}')
    n_tokens = new_tokens * len(bodies)
    return n_tokens / wall, wall


def int8_spec_parity(cfg, model, dev, new_tokens):
    from skypilot_tpu_torch.serve import batching_engine
    prompts = [prompt(100 + i, n, cfg.vocab_size)
               for i, n in enumerate([12, 60, 130, 333])]
    out = {}
    stats = {}
    for spec in (0, 4):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=1024, slots=8, kv_pages=1024,
            page_size=16, quantize_kv=True, spec_tokens=spec, device=dev)
        try:
            reqs = [engine.submit(p, new_tokens) for p in prompts]
            out[spec] = [r.result(timeout=600) for r in reqs]
            stats[spec] = engine.stats()
        finally:
            engine.stop()
    if out[0] != out[4]:
        raise AssertionError(f'int8 greedy spec-on != spec-off:\n'
                             f'{out[4]}\n{out[0]}')
    return stats[4]


def reference_check(dev):
    """Depth-2 f32 llama3-8b: GPU kernels vs the CPU plain versions."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    cfg = configs.get_config('llama3-8b', n_layers=2, dtype=torch.float32)
    gpu_model = init_params(cfg, seed=1, device=dev)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu')
    prompts = [prompt(200, 12, cfg.vocab_size),
               prompt(201, 40, cfg.vocab_size)]
    toks = {}
    for mode, kv_pages in (('paged', 32), ('dense', None)):
        for device, model in (('gpu', gpu_model), ('cpu', cpu_model)):
            engine = batching_engine.ContinuousBatchingEngine(
                cfg, model, max_len=128, slots=2, kv_pages=kv_pages,
                page_size=16, device=model.device)
            try:
                toks[mode, device] = [engine.generate(p, 12)
                                      for p in prompts]
            finally:
                engine.stop()
        if toks[mode, 'gpu'] != toks[mode, 'cpu']:
            raise AssertionError(f'{mode}: GPU vs CPU greedy tokens '
                                 f'differ:\n{toks[mode, "gpu"]}\n'
                                 f'{toks[mode, "cpu"]}')
    p = torch.tensor([prompts[1]])
    gl, _ = decode.prefill(cfg, gpu_model, p.to(dev), max_len=64)
    cl, _ = decode.prefill(cfg, cpu_model, p, max_len=64)
    err = max_err(gl.cpu(), cl)
    if err > 1e-3:
        raise AssertionError(f'prefill logits GPU vs CPU: {err}')
    return err


# ---------------------------------------- phase 4, the observability plane


def family(parsed, name) -> float:
    """Sum of a parsed exposition family over its label sets."""
    return sum(parsed.get(name, {}).values())


def burst(engine, prompts, new_tokens):
    """Submit every prompt at once; (tokens, wall s, ticks) once the
    engine has read its last tick."""
    from skypilot_tpu_torch.serve import plane_check
    plane_check.settle(engine)
    ticks0 = engine.stats()['ticks']
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    out = [list(r.result(timeout=600)) for r in reqs]
    wall = time.perf_counter() - t0
    plane_check.settle(engine)
    return out, wall, engine.stats()['ticks'] - ticks0


def route_window(server, dev, prompts, ids, new_tokens, counters):
    """One window of the plane on `server`, over HTTP with client-chosen
    request ids: /metrics (deltas equal the engine's own), /spans (one
    ordered engine segment per id), /profile (phases of the vocabulary,
    each tick's phases within its duration, the memory watermark within
    the allocator's peak), /logs (one access record per id).  The launch
    counts are zeroed just before the requests and read just after the
    route reads, so they are this window's own."""
    import torch
    from skypilot_tpu_torch.observability import metrics
    from skypilot_tpu_torch.observability import profiling
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    from skypilot_tpu_torch.serve import plane_check
    engine = server.engine
    port, stop = model_server.start_background(server)
    try:
        plane_check.settle(engine)
        before = metrics.parse_exposition(
            http_call(port, http_protocol.METRICS)[2].decode())
        stats0 = engine.stats()
        replies = {}

        def run(p, rid):
            replies[rid] = http_call(port, http_protocol.GENERATE, rid, {
                'prompt_ids': [p], 'max_new_tokens': new_tokens})
        threads = [threading.Thread(target=run, args=(p, rid))
                   for p, rid in zip(prompts, ids)]
        zero_counts(counters)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        plane_check.settle(engine)
        status, echoed, body = http_call(port, http_protocol.METRICS,
                                         f'{ids[0]}-scrape')
        after = metrics.parse_exposition(body.decode())
        stats1 = engine.stats()
        spans = {rid: json.loads(http_call(
            port, f'{http_protocol.SPANS}?request_id={rid}')[2])['segments']
                 for rid in ids}
        payload = json.loads(http_call(port, http_protocol.PROFILE)[2])
        peak = torch.cuda.max_memory_allocated(dev)
        records = {rid: json.loads(http_call(
            port, f'{http_protocol.LOGS}?request_id={rid}')[2])['records']
                   for rid in ids}
        launches = read_counts(counters)
    finally:
        stop()
    if status != 200 or echoed != f'{ids[0]}-scrape':
        raise AssertionError(f'/metrics {status}, echoed {echoed}')
    tokens = {}
    for rid in ids:
        code, echoed, body = replies[rid]
        if code != 200 or echoed != rid:
            raise AssertionError(f'/generate {rid}: {code}, echoed {echoed}')
        tokens[rid] = json.loads(body)['tokens'][0]
    for name, key in (('skytpu_engine_ticks_total', 'ticks'),
                      ('skytpu_engine_decode_tokens_total',
                       'tokens_generated')):
        grown = family(after, name) - family(before, name)
        if grown != stats1[key] - stats0[key]:
            raise AssertionError(f'/metrics {name} grew {grown}, the '
                                 f'engine counted {stats1[key] - stats0[key]}')
    ttft = (family(after, 'skytpu_engine_ttft_seconds_count') -
            family(before, 'skytpu_engine_ttft_seconds_count'))
    if ttft != len(ids):
        raise AssertionError(f'TTFT histogram grew {ttft}, not {len(ids)}')
    for rid in ids:
        engine_segs = [s for s in spans[rid] if s['name'] == 'engine']
        if len(engine_segs) != 1:
            raise AssertionError(f'/spans {rid}: {spans[rid]}')
        seg = engine_segs[0]
        phases = seg['phases']
        if (seg['status'] != 'ok' or seg['tokens'] != len(tokens[rid]) or
                seg['ttft_ms'] > seg['duration_ms'] or
                [p['name'] for p in phases] != ['queue', 'prefill',
                                                'decode']):
            raise AssertionError(f'/spans {rid}: {seg}')
        for p, nxt in zip(phases, phases[1:]):
            if p['start'] + p['duration_ms'] / 1e3 > nxt['start'] + 1e-5:
                raise AssertionError(f'/spans {rid}: phases overlap {phases}')
        access = [r for r in records[rid] if r['msg'].startswith('POST ')]
        if [r['msg'] for r in access] != [
                f'POST {http_protocol.GENERATE} -> 200']:
            raise AssertionError(f'/logs {rid}: {records[rid]}')
    prof = payload['profile']
    if not prof['enabled'] or not prof['ring']:
        raise AssertionError('/profile: empty ring')
    for rec in prof['ring']:
        names = {name for name, _, _ in rec['phases']}
        if not names <= set(profiling.PHASES):
            raise AssertionError(f'/profile: phases {names}')
        if sum(d for _, _, d in rec['phases']) > rec['dur_s'] + 1e-9:
            raise AssertionError(f'/profile: phases exceed the tick {rec}')
        if not 0 < rec['mem_bytes'] <= peak:
            raise AssertionError(f'/profile: mem_bytes {rec["mem_bytes"]} '
                                 f'against the peak {peak}')
    return {'launches': launches, 'profile': prof}


def observability(server, dev, new_tokens, counters):
    """The plane on phase 4's full-width paged server (bf16 pool) and on
    a second server with an int8 pool over the same weights, one
    `route_window` each; then, in this thread on identical inputs, the
    wrapped step adds no device work (`plane_check`); then an engine
    with the plane off on the same weights gives the same tokens.  Times
    are printed, never held.  Returns the windows' launch counts under
    `launches`, by path."""
    import os
    import torch
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import model_server
    from skypilot_tpu_torch.serve import plane_check
    engine, cfg, vocab = server.engine, server.cfg, server.cfg.vocab_size
    lengths = (23, 77, 130, 300, 45, 200)
    prompts = [prompt(200 + i, n, vocab) for i, n in enumerate(lengths)]
    window = route_window(server, dev, prompts,
                          [f'chip-obs-{i}' for i in range(len(prompts))],
                          new_tokens, counters)
    int8_server = model_server.ModelServer(
        'llama3-8b', continuous_batching=True, kv_pages=1024,
        page_size=16, max_len=engine.max_len, max_batch=8,
        quantize_kv=True, device=dev, params=server.params)
    try:
        int8_window = route_window(
            int8_server, dev, prompts,
            [f'chip-obs-int8-{i}' for i in range(len(prompts))],
            new_tokens, counters)
    finally:
        int8_server.close()
    del int8_server
    prof = window['profile']
    laps = sum(agg['count'] for agg in prof['phases'].values())
    ring_bytes = len(json.dumps(prof['ring']))
    durs = sorted(rec['dur_s'] * 1e3 for rec in prof['ring'])

    tick_tokens = torch.tensor(
        [prompts[2][:128]], dtype=torch.int32, device=dev)
    work = plane_check.same_device_work(engine, tick_tokens)

    os.environ['SKYTPU_PROFILE_DISABLE'] = '1'
    try:
        off = batching_engine.ContinuousBatchingEngine(
            cfg, server.params, max_len=engine.max_len, slots=8,
            kv_pages=1024, page_size=16, device=dev)
    finally:
        del os.environ['SKYTPU_PROFILE_DISABLE']
    host_ms = {True: [], False: []}
    try:
        if off.profile()['enabled']:
            raise AssertionError('SKYTPU_PROFILE_DISABLE left the plane on')
        # Each prompt set is new to both engines (no prefix hit); the
        # order alternates: off, on, on, off.
        sets = [[prompt(300 + 10 * k + i, n, vocab)
                 for i, n in enumerate(lengths)] for k in range(2)]
        outs = {}
        for k, plane in ((0, False), (0, True), (1, True), (1, False)):
            outs[k, plane], wall, n_ticks = burst(
                engine if plane else off, sets[k], new_tokens)
            host_ms[plane].append(wall * 1e3 / n_ticks)
    finally:
        off.stop()
    for k in range(2):
        if outs[k, True] != outs[k, False]:
            raise AssertionError(f'prompt set {k}: the engine with the '
                                 'plane off gave other tokens than on')
    sentinel = prof['recompiles']
    int8_prof = int8_window['profile']
    return {
        'launches': {'observability': window['launches'],
                     'observability (int8 pool)': int8_window['launches']},
        'ticks': prof['ticks'], 'ring': len(prof['ring']),
        'int8_ticks': int8_prof['ticks'], 'int8_ring': len(int8_prof['ring']),
        'tick_ms_p50': durs[len(durs) // 2], 'tick_ms_min': durs[0],
        'tick_ms_max': durs[-1],
        'phases': {n: round(a['total_s'] * 1e3, 3)
                   for n, a in prof['phases'].items()},
        'overhead_ms': prof['overhead_s'] * 1e3,
        'per_lap_us': prof['overhead_s'] / laps * 1e6,
        'laps_per_tick': laps / prof['ticks'],
        'ring_bytes_per_tick': ring_bytes / len(prof['ring']),
        'ring_ticks': prof['ring_ticks'],
        'mem_watermark_gib': prof['device_memory']['watermark_bytes'] / 2**30,
        'recompiles': {n: (f['calls'], f['compiles'],
                           f['steady_recompiles'])
                       for n, f in sentinel['fns'].items() if f['calls']},
        'work': work, 'host_ms_on': host_ms[True],
        'host_ms_off': host_ms[False]}


# ------------------------------------------------- phase 5: more serving


def post_raw(port, path, body):
    """POST a JSON body; (status, raw response body)."""
    status, _, raw = http_call(port, path, body=body)
    return status, raw


def sse_events(raw: bytes) -> list:
    return [line[len(b'data: '):].decode() for line in raw.split(b'\n')
            if line.startswith(b'data: ')]


def path_logits(cfg, model, ids, use_flash, quantize=False):
    """Logits [len(ids), V] of one forward of `ids` from position 0,
    attention by the flash kernel (`use_flash`) or the masked grouped
    einsum; with `quantize`, every k/v goes through the int8 pool's
    quantizer and back before attention reads it."""
    import torch
    from skypilot_tpu_torch.models import decode
    s = len(ids)
    tokens = torch.tensor([ids], device=model.device)
    cache = decode.init_cache(cfg, 1, s, device=model.device)

    def write(c, new):
        if quantize:
            q, scale = decode._quant_kv(new)  # pylint: disable=protected-access
            new = q.float() * scale[..., None]
        c[:, :, :s] = new.to(c.dtype)

    with torch.no_grad():
        logits, _, _ = decode._scan_layers_and_unembed(  # pylint: disable=protected-access
            cfg, model, decode._embed(cfg, model, tokens),  # pylint: disable=protected-access
            torch.arange(s, device=tokens.device), cache['k'], cache['v'],
            write, use_flash=use_flash, all_positions=True)
    return logits[0].float()


def hold_tokens(what, cfg, model, prompt_ids, got, ref, quantized=False):
    """Greedy tokens `got`, each held at its own context (teacher
    forcing): under the logits A of one flash forward of prompt + got,
    every got[j] is A's argmax at its position or within 2 delta of it,
    delta being the largest |A - B| over the generated positions and the
    vocabulary, B the same forward's logits through the masked einsum
    (two exact paths of one function: either path's bf16 rounding moves
    a logit by about delta).  With `quantized` (an int8 pool) B's k/v go
    through the pool's quantizer, so delta holds its effect too.  `ref`,
    the reference path's tokens, says where the two part.  Returns
    (first j where got and ref part or None, tokens that are not A's
    argmax, the largest gap, delta)."""
    import torch
    if len(got) != len(ref):
        raise AssertionError(f'{what}: {len(got)} tokens, reference '
                             f'{len(ref)}')
    n = len(prompt_ids)
    ids = list(prompt_ids) + list(got[:-1])
    a = path_logits(cfg, model, ids, use_flash=True)[n - 1:]
    b = path_logits(cfg, model, ids, use_flash=False,
                    quantize=quantized)[n - 1:]
    delta = float((a - b).abs().max())
    picked = a.gather(1, torch.tensor(got, device=a.device)[:, None])[:, 0]
    gaps = a.max(dim=1).values - picked
    worst = float(gaps.max())
    if worst > 2 * delta:
        j = int(gaps.argmax())
        raise AssertionError(
            f'{what}: token {j} is {got[j]}, {worst:.4f} below the best '
            f'logit ({int(a[j].argmax())}) > 2 x path difference '
            f'{delta:.3g}')
    parted = next((j for j, (x, y) in enumerate(zip(got, ref)) if x != y),
                  None)
    return parted, int((gaps > 0).sum()), worst, delta


def hold_summary(holds) -> str:
    equal = sum(1 for h in holds if h[0] is None)
    parted = [h[0] for h in holds if h[0] is not None]
    return (f'{equal}/{len(holds)} equal to the reference path'
            + (f' (others part at tokens {parted})' if parted else '')
            + f'; all {len(holds)} held token by '
            f'token: {sum(h[1] for h in holds)} not the flash argmax, '
            f'largest gap {max(h[2] for h in holds):.3g} (2 delta >= '
            f'{2 * min(h[3] for h in holds):.3g})')


def dense_serving(cfg, model, dev, new_tokens):
    """ModelServer in the reference's default mode (continuous batching,
    no --kv-pages) over HTTP: 6 concurrent /generate requests,
    /generate_stream and /generate_text.  Engine work only: the greedy
    tokens are held after the window (`hold_dense`)."""
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    server = model_server.ModelServer(
        'llama3-8b', continuous_batching=True, max_len=1024, max_batch=8,
        params=model, device=dev)
    vocab = cfg.vocab_size
    prompts = [prompt(500 + i, n, vocab)
               for i, n in enumerate([5, 37, 64, 100, 250, 700])]
    port, stop = model_server.start_background(server)
    try:
        if server.engine.stats()['decode_kernel'] != 'dense':
            raise AssertionError('the server is not in dense mode')
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(port, {'prompt_ids': [prompts[i]],
                                     'max_new_tokens': new_tokens})
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        req = server.engine.submit(prompt(9, 100, vocab), new_tokens)
        req.result(timeout=600)
        ttft_ms = req.ttft_s * 1e3
        code, raw = post_raw(port, http_protocol.GENERATE_STREAM, {
            'prompt_ids': [prompts[1]], 'max_new_tokens': new_tokens})
        events = sse_events(raw)
        streamed = [json.loads(e)['token'] for e in events[:-1]]
        if code != 200 or events[-1] != '[DONE]':
            raise AssertionError(f'/generate_stream {code}: {events[-3:]}')
        text = {}
        for stream in (False, True):
            code, raw = post_raw(port, http_protocol.GENERATE_TEXT, {
                'prompt': 'The quick brown fox jumps over the lazy dog',
                'max_new_tokens': 16, 'stream': stream})
            if code != 200:
                raise AssertionError(f'/generate_text {code}: {raw[:200]}')
            text[stream] = (''.join(json.loads(e)['text']
                                    for e in sse_events(raw)[:-1])
                            if stream else json.loads(raw)['completion'])
        stats = server.engine.stats()
    finally:
        stop()
        server.close()
    tokens = []
    for (code, out), p in zip(results, prompts):
        if code != 200 or len(out['tokens'][0]) != new_tokens:
            raise AssertionError(f'/generate {code}: {out}')
        tokens.append(out['tokens'][0])
    if streamed != tokens[1]:
        raise AssertionError(f'/generate_stream {streamed} != /generate '
                             f'{tokens[1]}')
    if text[True] != text[False]:
        raise AssertionError(f'/generate_text stream {text[True]!r} != '
                             f'{text[False]!r}')
    return {'tokens_per_s': new_tokens * len(prompts) / wall, 'wall': wall,
            'ttft_ms': ttft_ms, 'ticks': stats['ticks'], 'prompts': prompts,
            'tokens': tokens}


def hold_dense(cfg, model, dense, new_tokens):
    """The dense engine's greedy tokens, held with decode.generate's as
    the reference path."""
    import torch
    from skypilot_tpu_torch.models import decode
    holds = []
    for p, got in zip(dense['prompts'], dense['tokens']):
        _, ref = decode.generate(cfg, model,
                                 torch.tensor([p], device=model.device),
                                 max_new_tokens=new_tokens, max_len=1024)
        holds.append(hold_tokens('dense engine vs decode.generate', cfg,
                                 model, p, got, ref[0].tolist()))
    return holds


def legacy_serving(cfg, model, dev, new_tokens, dense):
    """pipelined=False on the same model and prompts.  Engine work only:
    the tokens are held after the window, with the dense pipelined
    engine's as the reference path."""
    from skypilot_tpu_torch.serve import batching_engine
    engine = batching_engine.ContinuousBatchingEngine(
        cfg, model, max_len=1024, slots=8, pipelined=False, device=dev)
    try:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, new_tokens) for p in dense['prompts']]
        got = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    return {'tokens_per_s': new_tokens * len(got) / wall, 'tokens': got}


def spec_past_one_bucket(cfg, model, dev, new_tokens, counters):
    """int8 + spec at 16 slots, k = 4: the verify tick has 80 rows, past
    one 64-row bucket.  Greedy tokens must equal spec-off's.  Returns
    (the launch counts of the spec-on run alone, its stats)."""
    from skypilot_tpu_torch.serve import batching_engine
    prompts = [prompt(600 + i, 12 + 21 * i, cfg.vocab_size)
               for i in range(16)]
    out, stats = {}, {}
    zero_counts(counters)
    for spec in (4, 0):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=1024, slots=16, kv_pages=1024,
            page_size=16, quantize_kv=True, spec_tokens=spec, device=dev)
        try:
            reqs = [engine.submit(p, new_tokens) for p in prompts]
            out[spec] = [r.result(timeout=600) for r in reqs]
            stats[spec] = engine.stats()
        finally:
            engine.stop()
        if spec:
            counts = read_counts(counters)
    if out[0] != out[4]:
        bad = [i for i, (a, b) in enumerate(zip(out[0], out[4])) if a != b]
        raise AssertionError(f'16 slots, k = 4: greedy spec-on != spec-off '
                             f'for prompts {bad}')
    return counts, stats[4]


def verify_tick_cost(cfg, model, dev):
    """Device and host ms of one int8 verify tick at 16 slots, k = 4
    (80 rows, two 64-row blocks), and of the same tick run as one call
    on the 128 padded rows (the blocks switched off for this timing):
    what the row blocks cost."""
    import torch
    from skypilot_tpu_torch.models import decode
    slots, k, ps, rows = 16, 4, 16, 64
    pool = decode.init_paged_cache(cfg, 1 + slots * rows, ps, slots, rows,
                                   quantize_kv=True, device=dev)
    for slot in range(slots):
        decode.paged_admit_slot(
            pool, slot, list(range(1 + slot * rows, 1 + (slot + 1) * rows)),
            5 + 45 * slot)
    state = decode.init_engine_state(slots, device=dev)
    for slot in range(slots):
        state = decode.admit_slot_state(state, slot, 1 + slot, 10 ** 6,
                                        [-1] * 16, [slot, 0], 0.0, 0)
    drafts = torch.randint(0, cfg.vocab_size, (slots, k), device=dev,
                           dtype=torch.int32)

    def tick():
        decode.paged_spec_engine_step(cfg, model, state, pool, drafts)

    with torch.no_grad():
        blocked = timed_call(tick)
        by_blocks = decode._by_blocks  # pylint: disable=protected-access
        decode._by_blocks = lambda fn, x, blocked: fn(x)  # pylint: disable=protected-access
        try:
            one_call = timed_call(tick)
        finally:
            decode._by_blocks = by_blocks  # pylint: disable=protected-access
    return blocked, one_call


def tickets_at_zero(engines):
    """Every ticket counter reads 0, and the engines' streams each had
    their own."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention
    torch.cuda.synchronize()
    tickets = paged_attention._TICKETS  # pylint: disable=protected-access
    for key, counters in tickets.items():
        if int(counters.count_nonzero()):
            raise AssertionError(f'ticket counters {key} not at 0')
    keys = {(e.stream.device, e.stream.cuda_stream) for e in engines}
    if len(keys) != len(engines) or not keys <= set(tickets):
        raise AssertionError('the engines did not count in a ticket array '
                             'of their own stream each')


def handoff(cfg, model, dev, new_tokens, counters):
    """Prefill/decode disaggregation on one card: a prefill engine (paged
    bf16) exports a 100-token prompt through the binary frame; a decode
    engine (paged bf16, then an int8 pool) imports it and generates.
    Returns (the launch counts of that window, results).  Then, outside
    the window, each decode engine serves the prompt again while a
    single engine of its pool type serves it at once, each engine on its
    own CUDA stream: the decode engine's tokens must equal its window's,
    and every ticket counter must read 0 after."""
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import handoff as handoff_lib
    kw = dict(max_len=1024, slots=8, kv_pages=1024, page_size=16,
              device=dev)
    pools = {'bf16': False, 'int8': True}
    p = prompt(700, 100, cfg.vocab_size)
    engines = []

    def engine(**extra):
        engines.append(batching_engine.ContinuousBatchingEngine(
            cfg, model, **kw, **extra))
        return engines[-1]

    try:
        prefill_engine = engine()
        decode_engines = {pool: engine(quantize_kv=q)
                          for pool, q in pools.items()}
        singles = {'bf16': prefill_engine, 'int8': engine(quantize_kv=True)}
        out = {}
        zero_counts(counters)
        for pool, decode_engine in decode_engines.items():
            before = read_counts(counters)
            t0 = time.perf_counter()
            frame = prefill_engine.export_prefill(p, binary=True)
            export_ms = (time.perf_counter() - t0) * 1e3
            exported = read_counts(counters)
            decoded = handoff_lib.decode_binary(frame)
            t0 = time.perf_counter()
            got = decode_engine.import_pages(
                decoded['hashes'], decoded['page_size'], decoded['k'],
                decoded['v'])
            import_ms = (time.perf_counter() - t0) * 1e3
            if got != (6, 0):
                raise AssertionError(f'import: {got}, expected (6, 0)')
            via = decode_engine.generate(p, new_tokens)
            if decode_engine.stats()['prefix_cache_hits'] < 6:
                raise AssertionError('the import was not adopted')
            after = read_counts(counters)
            out[pool] = dict(
                via=via, frame_bytes=len(frame), export_ms=export_ms,
                import_ms=import_ms,
                export_launches={k: exported[k] - before[k]
                                 for k in before},
                import_launches={k: after[k] - exported[k] for k in before})
        counts = read_counts(counters)
        for pool, decode_engine in decode_engines.items():
            # One round of two engines' ticks on two streams at once.
            reqs = [decode_engine.submit(p, new_tokens),
                    singles[pool].submit(p, new_tokens)]
            again, ref = [r.result(timeout=600) for r in reqs]
            tickets_at_zero([decode_engine, singles[pool]])
            if again != out[pool]['via']:
                raise AssertionError(f'handoff ({pool} pool): the decode '
                                     'engine beside a second stream gave '
                                     'other tokens than alone')
            out[pool]['hold'] = hold_tokens(
                f'handoff ({pool} pool) vs one engine', cfg, model, p,
                out[pool]['via'], ref, quantized=pools[pool])
    finally:
        for e in engines:
            e.stop()
    return counts, out


# ------------------------------------------ phase 5: the replica front


BATCH_BUDGET = 8         # the batch class's max_new_tokens in this phase
FRONT_STREAMS = (5, 37, 64, 100, 250)
BUDGET_PROMPT = 24       # tokens; under the decode budget, 1 a piece


def http_post(port, path, body, headers=None):
    """(status, response headers, body bytes) of a JSON POST."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
    try:
        conn.request('POST', path, body=json.dumps(body).encode(),
                     headers=dict({'Content-Type': 'application/json'},
                                  **(headers or {})))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def open_stream(port, body, rid):
    """A socket that has sent one /generate_stream request."""
    import socket
    data = json.dumps(body).encode()
    sock = socket.create_connection(('127.0.0.1', port), timeout=600)
    sock.sendall(f'POST /generate_stream HTTP/1.1\r\nHost: x\r\n'
                 f'Content-Type: application/json\r\n'
                 f'Content-Length: {len(data)}\r\n'
                 f'X-SkyTPU-Request-Id: {rid}\r\n'
                 f'Connection: close\r\n\r\n'.encode() + data)
    return sock


def read_events(sock, raw, until):
    """Read the stream until `until(events)` holds or the socket ends;
    returns (raw bytes, SSE events)."""
    while not until(sse_events(raw)):
        chunk = sock.recv(65536)
        if not chunk:
            break
        raw += chunk
    return raw, sse_events(raw)


def stream_tokens(events) -> list:
    if not events or events[-1] != '[DONE]':
        raise AssertionError(f'stream did not end with [DONE]: {events[-3:]}')
    return [json.loads(e)['token'] for e in events[:-1]]


def wait_until(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f'{what}: not within {timeout} s')
        time.sleep(0.02)


def pages_in_slots(stats) -> int:
    """Pages held beyond the prefix cache's pinned ones."""
    return stats['kv_pages_used'] - stats['kv_pages_pinned']


def replica_front(cfg, model, dev, counters, new_tokens):
    """The replica front at llama3-8b on phase 4's weights: a paged
    server behind the asyncio front (`async_server.start_background`).
    The window, zeroed just before and read just after its engine work:
    greedy /generate (its TTFT), 5 concurrent /generate_stream
    (tokens/s), a batch-class request (SKYTPU_QOS_SPEC gives the class
    max_new_tokens BATCH_BUDGET), /role_budget decode then a 24-token
    prompt (a B3 chunk 0 of one token at the 16 bucket, then width-1
    continuations) then mixed, /drain with a stream in flight (/generate
    503 + Retry-After, the stream finishes), and a stream whose client
    hangs up after two events (busy slots and slot pages back to their
    baseline, the span 'cancelled').  After the window, the threaded
    front of a second server on the same weights serves the same
    prompts, new to it, unclamped: /generate, the streams and the drain
    stream must give its tokens; the batch request its first
    BATCH_BUDGET; the decode-budget prompt its tokens, or else each
    token held at its own context (its pieces ran the masked path where
    the reference's one prefill ran the flash kernel).  Returns (launch
    counts, printed numbers)."""
    import os
    from skypilot_tpu_torch.serve import async_server
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    vocab = cfg.vocab_size
    kw = dict(continuous_batching=True, kv_pages=1024, page_size=16,
              max_len=1024, max_batch=8, params=model, device=dev)
    single = prompt(800, 40, vocab)
    streams = [prompt(801 + i, n, vocab)
               for i, n in enumerate(FRONT_STREAMS)]
    batch_p = prompt(810, 60, vocab)
    budget_p = prompt(811, BUDGET_PROMPT, vocab)
    drain_p = prompt(812, 30, vocab)
    gone_p = prompt(813, 50, vocab)
    qos_header = {http_protocol.QOS_CLASS_HEADER: 'batch'}
    t_phase = time.perf_counter()
    os.environ['SKYTPU_QOS_SPEC'] = json.dumps(
        {'batch': {'max_new_tokens': BATCH_BUDGET}})
    got = {}
    try:
        server = model_server.ModelServer('llama3-8b', **kw)
        engine = server.engine
        port, stop = async_server.start_background(server)
        try:
            zero_counts(counters)
            t0 = time.perf_counter()
            code, _, raw = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [single], 'max_new_tokens': new_tokens},
                {http_protocol.REQUEST_ID_HEADER: 'front-1'})
            if code != 200:
                raise AssertionError(f'/generate {code}: {raw[:200]}')
            got['single'] = json.loads(raw)['tokens'][0]
            generate_s = time.perf_counter() - t0
            results = [None] * len(streams)

            def run(i):
                results[i] = http_post(port, http_protocol.GENERATE_STREAM, {
                    'prompt_ids': [streams[i]], 'max_new_tokens': new_tokens})
            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(streams))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            streams_s = time.perf_counter() - t0
            got['streams'] = []
            for code, headers, raw in results:
                if code != 200 or headers.get('Content-Type') != \
                        'text/event-stream':
                    raise AssertionError(f'/generate_stream {code}')
                got['streams'].append(stream_tokens(sse_events(raw)))
            code, _, raw = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [batch_p], 'max_new_tokens': new_tokens},
                qos_header)
            got['batch'] = json.loads(raw)['tokens'][0]
            code, _, raw = http_post(port, http_protocol.ROLE_BUDGET,
                                     {'role': 'decode', 'version': 1})
            budget = json.loads(raw)
            if code != 200 or not budget['applied'] or \
                    budget['budget']['prefill_tokens'] != 1:
                raise AssertionError(f'/role_budget decode: {budget}')
            chunks0 = engine.stats()['prefill_chunks']
            t0 = time.perf_counter()
            code, _, raw = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [budget_p], 'max_new_tokens': 16})
            budget_s = time.perf_counter() - t0
            got['budget'] = json.loads(raw)['tokens'][0]
            budget_chunks = engine.stats()['prefill_chunks'] - chunks0
            if budget_chunks != BUDGET_PROMPT - 1:
                raise AssertionError(f'decode budget: {budget_chunks} '
                                     f'prefill pieces for {BUDGET_PROMPT} '
                                     f'tokens, expected {BUDGET_PROMPT - 1}')
            code, _, raw = http_post(port, http_protocol.ROLE_BUDGET,
                                     {'role': 'mixed', 'version': 2})
            if code != 200 or not json.loads(raw)['morphed']:
                raise AssertionError(f'/role_budget mixed: {raw[:200]}')
            # /drain while a stream is in flight.
            sock = open_stream(port, {'prompt_ids': [drain_p],
                                      'max_new_tokens': new_tokens},
                               'front-drain')
            raw, _ = read_events(sock, b'', lambda ev: len(ev) >= 1)
            code, _, body = http_post(port, http_protocol.DRAIN, {})
            if code != 200 or not json.loads(body)['draining']:
                raise AssertionError(f'/drain {code}: {body[:200]}')
            refused = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [single], 'max_new_tokens': 4})
            if refused[0] != 503 or 'Retry-After' not in refused[1]:
                raise AssertionError(f'draining /generate: {refused[0]} '
                                     f'{refused[1]}')
            raw, events = read_events(sock, raw,
                                      lambda ev: ev[-1:] == ['[DONE]'])
            sock.close()
            got['drain'] = stream_tokens(events)
            code, _, raw = http_post(port, http_protocol.ROLE_BUDGET, {
                'role': 'mixed', 'resume': True, 'version': 3})
            if code != 200 or json.loads(raw)['draining']:
                raise AssertionError(f'resume: {raw[:200]}')
            # A client that hangs up after two events.
            base = engine.stats()
            sock = open_stream(port, {'prompt_ids': [gone_p],
                                      'max_new_tokens': 600}, 'front-gone')
            read_events(sock, b'', lambda ev: len(ev) >= 2)
            sock.close()
            t0 = time.perf_counter()
            wait_until(lambda: engine.span('front-gone') is not None, 120,
                       'the hung-up stream finishing')
            wait_until(lambda: engine.stats()['busy_slots'] == 0 and
                       pages_in_slots(engine.stats()) ==
                       pages_in_slots(base), 120,
                       'slots and pages back to their baseline')
            freed_s = time.perf_counter() - t0
            gone = engine.span('front-gone')
            counts = read_counts(counters)
            if gone['status'] != 'cancelled' or gone['tokens'] >= 600:
                raise AssertionError(f'hung-up stream: {gone}')
            ttft_ms = engine.span('front-1')['ttft_ms']
            sentinel = engine.profile()['recompiles']
        finally:
            stop()
            server.close()
        del server, engine
        # The threaded front of a second server: the reference path.
        ref_server = model_server.ModelServer('llama3-8b', **kw)
        ref_port, ref_stop = model_server.start_background(ref_server)
        try:
            def ref_tokens(p, n):
                code, _, raw = http_post(ref_port, http_protocol.GENERATE,
                                         {'prompt_ids': [p],
                                          'max_new_tokens': n})
                if code != 200:
                    raise AssertionError(f'threaded /generate {code}')
                return json.loads(raw)['tokens'][0]
            ref = {'single': ref_tokens(single, new_tokens),
                   'streams': [ref_tokens(p, new_tokens) for p in streams],
                   'batch': ref_tokens(batch_p, new_tokens),
                   'budget': ref_tokens(budget_p, 16),
                   'drain': ref_tokens(drain_p, new_tokens)}
        finally:
            ref_stop()
            ref_server.close()
    finally:
        os.environ.pop('SKYTPU_QOS_SPEC', None)
    for key in ('single', 'streams', 'drain'):
        if got[key] != ref[key]:
            raise AssertionError(f'replica front {key}: async {got[key]} '
                                 f'!= threaded {ref[key]}')
    if got['batch'] != ref['batch'][:BATCH_BUDGET]:
        raise AssertionError(f'batch class: {got["batch"]} != the first '
                             f'{BATCH_BUDGET} of {ref["batch"]}')
    hold = (None if got['budget'] == ref['budget'] else
            hold_tokens('decode budget vs unclamped', cfg, model, budget_p,
                        got['budget'], ref['budget']))
    n_stream_tokens = sum(len(t) for t in got['streams'])
    return counts, dict(
        wall_s=time.perf_counter() - t_phase, generate_s=generate_s, ttft_ms=ttft_ms,
        streams_tokens_per_s=n_stream_tokens / streams_s,
        streams_s=streams_s, budget_s=budget_s, freed_s=freed_s,
        gone_tokens=gone['tokens'], budget_hold=hold,
        sentinel={n: (f['calls'], f['compiles'], f['steady_recompiles'])
                  for n, f in sentinel['fns'].items()
                  if n in ('prefill', 'prefill_chunk', 'step')})


# ------------------------------------------- phase 5b: real weights

REAL_LENGTHS = (5, 37, 64, 100, 250, 700)


def weight_bytes(model) -> int:
    """Bytes of every leaf of a model: parameters and buffers (an int8
    kernel's qvalue and scale)."""
    return sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))


def greedy_burst(server, bodies):
    """POST every body to /generate at once through the server's threaded
    front; -> (each body's greedy tokens, wall seconds)."""
    from skypilot_tpu_torch.serve import model_server
    port, stop = model_server.start_background(server)
    results = [None] * len(bodies)

    def run(i):
        results[i] = post(port, bodies[i])
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        stop()
    tokens = []
    for (code, out), body in zip(results, bodies):
        if code != 200 or len(out['tokens'][0]) != body['max_new_tokens']:
            raise AssertionError(f'/generate {code}: {out}')
        tokens.append(out['tokens'][0])
    return tokens, wall


def quantize_card_vs_cpu(dev):
    """quantize_params over a depth-1, full-width llama3-8b f32 tree on
    the card and the same call on the CPU: equal bytes, leaf for leaf."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import quantize
    from skypilot_tpu_torch.models.transformer import init_params
    cfg = configs.get_config('llama3-8b', n_layers=1, dtype=torch.float32)
    tree = convert.param_tree(init_params(cfg, seed=11, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = quantize.quantize_params(tree)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = convert._map_tree(lambda t: t.cpu(), tree)  # pylint: disable=protected-access
    del tree
    t0 = time.perf_counter()
    on_host = quantize.quantize_params(host)
    host_s = time.perf_counter() - t0
    leaves = n_int8 = 0

    def walk(a, b, path):
        nonlocal leaves, n_int8
        if isinstance(b, dict):
            if sorted(a) != sorted(b):
                raise AssertionError(f'quantize card vs CPU: keys at {path}')
            for k in b:
                walk(a[k], b[k], f'{path}/{k}')
            return
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError(
                f'quantize on the card != CPU at {path}: '
                f'{int((a.cpu() != b).sum())} of {b.numel()} differ')
        leaves += 1
        n_int8 += b.dtype == torch.int8
    walk(on_card, on_host, '')
    if n_int8 != 8:
        raise AssertionError(f'{n_int8} int8 leaves in a depth-1 tree')
    return {'leaves': leaves, 'int8_leaves': n_int8, 'card_s': card_s,
            'host_s': host_s}


def int8_weights(dev, counters, new_tokens):
    """The int8-weight server at full width and depth: its weights' bytes
    beside bf16's, the greedy burst held to the dequantized bf16 model's
    tokens (computed once, `convert.dequantize_model`), the int8 and
    bf16 ticks timed.  Launches are read around the server's engine work
    alone."""
    import torch
    from skypilot_tpu_torch import profile_decode
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.transformer import Transformer
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('llama3-8b')
    kw = dict(continuous_batching=True, kv_pages=1024, page_size=16,
              max_len=1024, max_batch=8, device=dev)
    bodies = [{'prompt_ids': [prompt(300 + i, n, cfg.vocab_size)],
               'max_new_tokens': new_tokens}
              for i, n in enumerate(REAL_LENGTHS)]
    zero_counts(counters)
    t0 = time.perf_counter()
    server = model_server.ModelServer('llama3-8b', quantize='int8', seed=0,
                                      **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    try:
        tokens, wall = greedy_burst(server, bodies)
    finally:
        server.close()
    launches = read_counts(counters)
    q8 = server.params
    del server
    out = {'init_s': init_s, 'tokens_per_s': new_tokens * len(bodies) / wall,
           'int8_gib': weight_bytes(q8) / 2**30,
           'bf16_gib': weight_bytes(Transformer(cfg, device='meta')) / 2**30}
    fp = convert.dequantize_model(q8)
    free_cuda()
    reference = model_server.ModelServer('llama3-8b', params=fp, **kw)
    try:
        ref_tokens, _ = greedy_burst(reference, bodies)
    finally:
        reference.close()
    del reference
    if tokens != ref_tokens:
        parted = [i for i, (a, b) in enumerate(zip(tokens, ref_tokens))
                  if a != b]
        raise AssertionError(f'int8 weights: greedy tokens of prompts '
                             f'{parted} differ from the dequantized bf16 '
                             f'model\'s')
    out['tick'] = {name: profile_decode.profile_tick(cfg, model, dev)
                   for name, model in (('int8', q8), ('bf16', fp))}
    del q8, fp
    free_cuda()
    return launches, out


SP_PIECES = ['▁hello', '▁world', '▁the', '▁quick', 'ing', '▁fox', 'hel',
             'lo', '▁', 'h', 'e', 'l', 'o', 'w', 'r', 'd', 't', 'q', 'u',
             'i', 'c', 'k', 'n', 'g', 'f', 'x']


def sp_model_bytes() -> bytes:
    """A tiny SentencePiece ModelProto (unigram): <unk>, <s>, </s>, word
    and character pieces, the 256 byte-fallback pieces."""
    import struct

    def varint(n):
        out = b''
        while True:
            b, n = n & 0x7F, n >> 7
            if n:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def piece(text, score, ptype=1):
        body = (b'\x0a' + varint(len(text.encode())) + text.encode() +
                b'\x15' + struct.pack('<f', score))
        if ptype != 1:
            body += b'\x18' + varint(ptype)
        return b'\x0a' + varint(len(body)) + body

    pieces = [piece('<unk>', 0.0, 2), piece('<s>', 0.0, 3),
              piece('</s>', 0.0, 3)]
    pieces += [piece(p, -rank / 4.0 - 1.0)
               for rank, p in enumerate(SP_PIECES)]
    pieces += [piece(f'<0x{b:02X}>', -100.0, 6) for b in range(256)]
    trainer = b'\x18' + varint(1)
    return b''.join(pieces) + b'\x12' + varint(len(trainer)) + trainer


def bf16_exact_model(cfg, seed, dev):
    """Seeded weights whose every value is a bf16 value (the f32 lm_head
    rounded through bf16), so a bf16 HF source or step holds them
    exactly."""
    import torch
    from skypilot_tpu_torch.models.transformer import init_params
    model = init_params(cfg, seed=seed, device=dev)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))
    return model


def write_hf_source(model, src) -> None:
    """The model as an HF Llama (or, with experts, Mixtral) checkpoint:
    HF names, [out, in] kernels, q/k rows in the rotate-half order,
    BF16, config.json, and a tiny SentencePiece tokenizer.model; written
    tensor by tensor with the port's own safetensors writer (no
    `transformers` needed)."""
    import os
    import torch
    from skypilot_tpu_torch.utils import safetensors_io
    cfg = model.cfg
    d, hd = cfg.d_model, cfg.head_dim

    def rotate_half_rows(kernel, heads):     # [d, h, hd] -> [h*hd, d]
        k = kernel.reshape(d, heads, hd)
        return torch.cat([k[..., 0::2], k[..., 1::2]], -1).reshape(
            d, heads * hd).t()

    leaves = [('model.embed_tokens.weight', lambda: model.embed.embedding),
              ('model.norm.weight', lambda: model.final_norm.scale),
              ('lm_head.weight', lambda: model.lm_head.kernel.t())]
    for i, layer in enumerate(model.layers):
        pre = f'model.layers.{i}.'
        leaves += [
            (pre + 'input_layernorm.weight',
             lambda x=layer: x.attn_norm.scale),
            (pre + 'post_attention_layernorm.weight',
             lambda x=layer: x.mlp_norm.scale),
            (pre + 'self_attn.q_proj.weight',
             lambda x=layer: rotate_half_rows(x.attn.q_proj.kernel,
                                              cfg.n_heads)),
            (pre + 'self_attn.k_proj.weight',
             lambda x=layer: rotate_half_rows(x.attn.k_proj.kernel,
                                              cfg.n_kv_heads)),
            (pre + 'self_attn.v_proj.weight',
             lambda x=layer: x.attn.v_proj.kernel.reshape(d, -1).t()),
            (pre + 'self_attn.o_proj.weight',
             lambda x=layer: x.attn.o_proj.kernel.reshape(-1, d).t()),
        ]
        if cfg.n_experts == 0:
            leaves += [(pre + f'mlp.{name}.weight',
                        lambda x=layer, n=name:
                        getattr(x.mlp, n).kernel.t())
                       for name in ('gate_proj', 'up_proj', 'down_proj')]
            continue
        moe = pre + 'block_sparse_moe.'
        leaves.append((moe + 'gate.weight',
                       lambda x=layer: x.moe_mlp.router.kernel.t()))
        for e in range(cfg.n_experts):
            leaves += [(moe + f'experts.{e}.{theirs}.weight',
                        lambda x=layer, n=ours, e=e:
                        getattr(x.moe_mlp, n)[e].t())
                       for ours, theirs in (('gate_proj', 'w1'),
                                            ('up_proj', 'w3'),
                                            ('down_proj', 'w2'))]
    specs = [(name, torch.bfloat16, tuple(fn().shape)) for name, fn in leaves]
    os.makedirs(src)
    safetensors_io.write_file(os.path.join(src, 'model.safetensors'), specs,
                              ((name, fn()) for name, fn in leaves))
    moe = ({'model_type': 'mixtral', 'num_local_experts': cfg.n_experts,
            'num_experts_per_tok': cfg.expert_top_k,
            'router_aux_loss_coef': cfg.router_aux_loss_coef}
           if cfg.n_experts else {'model_type': 'llama'})
    with open(os.path.join(src, 'config.json'), 'w', encoding='utf-8') as f:
        json.dump({**moe, 'vocab_size': cfg.vocab_size,
                   'hidden_size': d, 'intermediate_size': cfg.d_ff,
                   'num_hidden_layers': cfg.n_layers,
                   'num_attention_heads': cfg.n_heads,
                   'num_key_value_heads': cfg.n_kv_heads,
                   'max_position_embeddings': cfg.max_seq_len,
                   'rope_theta': cfg.rope_theta,
                   'rms_norm_eps': cfg.norm_eps,
                   'tie_word_embeddings': False,
                   'torch_dtype': 'bfloat16'}, f)
    with open(os.path.join(src, 'tokenizer.model'), 'wb') as f:
        f.write(sp_model_bytes())


def disk_bytes(path) -> int:
    import os
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def same_weights(a, b, what) -> None:
    """Fail unless two models hold the same leaves, bit for bit."""
    import torch
    from skypilot_tpu_torch.models import convert

    def walk(x, y, path):
        if isinstance(y, dict):
            for k in y:
                walk(x[k], y[k], f'{path}/{k}')
            return
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f'{what}: {path} differs')
    walk(convert.param_tree(a), convert.param_tree(b), '')


def generate_text(server, body):
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    port, stop = model_server.start_background(server)
    try:
        return json.loads(http_call(port, http_protocol.GENERATE_TEXT,
                                    body=body)[2])
    finally:
        stop()


def checkpoint_round_trip(dev, counters, new_tokens):
    """HF source -> import_weights.convert -> restore (bit-equal to the
    writer) -> ModelServer('auto') -> /generate, /generate_text -> step
    1 -> POST /weights_swap, at full width and depth 2.  Launches are
    read around the 'auto' server's life; the in-memory servers on the
    same weights run after the read."""
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.data import checkpoints
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import import_weights
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('llama3-8b', n_layers=2)
    kw = dict(continuous_batching=True, kv_pages=256, page_size=16,
              max_len=1024, max_batch=8, device=dev)
    bodies = [{'prompt_ids': [prompt(400 + i, n, cfg.vocab_size)],
               'max_new_tokens': new_tokens}
              for i, n in enumerate(REAL_LENGTHS[:4])]
    text_body = {'prompt': 'hello the quick fox', 'max_new_tokens': 16}
    root = tempfile.mkdtemp(prefix='skytpu_real_weights_')
    out = {}
    try:
        src, ckpt = f'{root}/hf', f'{root}/ckpt'
        writer = bf16_exact_model(cfg, 21, dev)
        t0 = time.perf_counter()
        write_hf_source(writer, src)
        out['source_s'] = time.perf_counter() - t0
        out['source_gb'] = disk_bytes(src) / 1e9
        t0 = time.perf_counter()
        converted = import_weights.convert(src, ckpt, dtype='bfloat16')
        out['convert_s'] = time.perf_counter() - t0
        out['peak_disk_gb'] = (disk_bytes(src) + disk_bytes(ckpt)) / 1e9
        shutil.rmtree(src)
        if converted != cfg:
            raise AssertionError(f'converted config {converted} != {cfg}')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = checkpoints.restore_params(ckpt, device=dev)
        torch.cuda.synchronize()
        out['restore_s'] = time.perf_counter() - t0
        same_weights(convert.from_jax_params(cfg, tree, device=dev), writer,
                     'the imported tree vs the model that wrote it')
        del tree
        free_cuda()

        zero_counts(counters)
        t0 = time.perf_counter()
        auto = model_server.ModelServer('auto', checkpoint_dir=ckpt, **kw)
        torch.cuda.synchronize()
        out['auto_init_s'] = time.perf_counter() - t0
        try:
            if auto.cfg != cfg:
                raise AssertionError(f'--model auto read {auto.cfg}')
            if type(auto.tokenizer).__name__ != 'SentencePieceTokenizer':
                raise AssertionError(f'tokenizer {auto.tokenizer}')
            tokens, _ = greedy_burst(auto, bodies)
            text = generate_text(auto, text_body)
            second = bf16_exact_model(cfg, 22, dev)
            tree = convert.param_tree(second)
            tree['lm_head']['kernel'] = tree['lm_head']['kernel'].to(
                torch.bfloat16)
            checkpoints.save_params(ckpt, 1, tree)
            del tree
            out['step1_gb'] = disk_bytes(f'{ckpt}/1') / 1e9
            out['peak_disk_gb'] = max(out['peak_disk_gb'],
                                      disk_bytes(ckpt) / 1e9)
            port, stop = model_server.start_background(auto)
            try:
                swapped = json.loads(http_call(
                    port, http_protocol.WEIGHTS_SWAP,
                    body={'checkpoint_dir': ckpt})[2])
            finally:
                stop()
            swapped_tokens, _ = greedy_burst(auto, bodies)
        finally:
            auto.close()
        launches = read_counts(counters)
        same_weights(auto.params, second, 'the swapped-in weights')
        del auto
        free_cuda()
        if (swapped['weight_version'], swapped['step']) != (1, 1):
            raise AssertionError(f'/weights_swap answered {swapped}')
        out['swap_restore_ms'] = swapped['restore_ms']
        for weights, got, what in ((writer, tokens, 'step 0'),
                                   (second, swapped_tokens, 'after swap')):
            fresh = model_server.ModelServer('auto', checkpoint_dir=ckpt,
                                             params=weights, **kw)
            try:
                want, _ = greedy_burst(fresh, bodies)
                if what == 'step 0':
                    ref_text = generate_text(fresh, text_body)
                    decoded = fresh.tokenizer.decode(text['tokens'])
            finally:
                fresh.close()
            if got != want:
                raise AssertionError(f'--model auto tokens ({what}) differ '
                                     'from the in-memory server\'s')
        if (text['tokens'] != ref_text['tokens'] or
                text['completion'] != decoded):
            raise AssertionError(f'/generate_text {text} vs in memory '
                                 f'{ref_text}, decode {decoded!r}')
        out['text_tokens'] = len(text['tokens'])
        del writer, second
        free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, out


def real_weights(dev, counters, new_tokens):
    """Phase 5b; returns {path: launch counts}."""
    paths = {}
    t_phase = time.perf_counter()
    q = quantize_card_vs_cpu(dev)
    log(f'quantize_params on the card == CPU, byte for byte: depth-1 '
        f'llama3-8b f32 tree, {q["leaves"]} leaves ({q["int8_leaves"]} '
        f'int8); {q["card_s"]:.2f} s on the card, {q["host_s"]:.2f} s on '
        f'the CPU')
    free_cuda()
    paths['int8 weights'], w = int8_weights(dev, counters, new_tokens)
    expect_launches('int8 weights', paths['int8 weights'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    ticks = {name: {k: t[k] for k in ('tick_ms', 'device_ms_per_tick',
                                      'device_idle_share',
                                      'kernels_per_tick')}
             for name, t in w['tick'].items()}
    log(f'int8 weights ({card()}): weights {w["int8_gib"]:.3f} GiB vs bf16 '
        f'{w["bf16_gib"]:.3f} GiB; init (seeded, quantized on the card '
        f'leaf by leaf) {w["init_s"]:.1f} s; 6 concurrent /generate '
        f'{w["tokens_per_s"]:.1f} tokens/s, greedy tokens equal to the '
        f'dequantized bf16 model\'s; paged tick (8 slots, profile_decode, '
        f'printed, not held) {json.dumps(ticks)}; top device ops int8 '
        f'{json.dumps(w["tick"]["int8"]["top_device_ops"][:6])}, bf16 '
        f'{json.dumps(w["tick"]["bf16"]["top_device_ops"][:4])}; launches '
        f'{json.dumps(paths["int8 weights"])}')
    paths['checkpoint'], c = checkpoint_round_trip(dev, counters, new_tokens)
    expect_launches('checkpoint', paths['checkpoint'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    log(f'checkpoint (llama3-8b width, depth 2, bf16): HF source '
        f'{c["source_gb"]:.2f} GB written in {c["source_s"]:.1f} s; '
        f'import_weights.convert {c["convert_s"]:.1f} s; restore to the '
        f'card {c["restore_s"]:.2f} s, bit-equal to the writer; --model '
        f'auto init {c["auto_init_s"]:.1f} s, greedy tokens and '
        f'/generate_text ({c["text_tokens"]} tokens) equal to an in-memory '
        f'server\'s; step 1 ({c["step1_gb"]:.2f} GB) swapped in '
        f'(restore_ms {c["swap_restore_ms"]}), weight_version 1, tokens '
        f'equal to a fresh server\'s; peak disk {c["peak_disk_gb"]:.2f} GB; '
        f'launches {json.dumps(paths["checkpoint"])}; the phase '
        f'{time.perf_counter() - t_phase:.1f} s')
    return paths


# ------------------------------------------------------------ phase 5c

MOE_LAYERS = 8           # Mixtral-8x7B's 32 layers cut to 8 (2.90 GB each)
MOE_LENGTHS = (5, 37, 64, 100, 250, 700)


@contextlib.contextmanager
def moe_as_served(n_prompt, drops=None):
    """decode._moe_mlp as the engine applies it to a teacher-forced
    sequence (prompt + generated tokens in one forward): the capacity
    dispatch over the prompt's rows (its prefill), the dense gather
    over each generated row (its ticks); `drops` collects each layer's
    dropped (token, expert) assignments of the prompt."""
    import torch
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.models import moe as moe_lib
    served = decode._moe_mlp  # pylint: disable=protected-access

    def moe_mlp(x, moe, cfg, capacity=False):
        b, s, d = x.shape
        head = served(x[:, :n_prompt], moe, cfg, capacity=capacity)
        if drops is not None:
            drops.append(moe_lib.dropped_tokens(
                x[0, :n_prompt].float() @ moe.router.kernel.float(), cfg))
        if s == n_prompt:
            return head
        tail = served(x[:, n_prompt:].reshape(-1, 1, d), moe, cfg)
        return torch.cat([head, tail.reshape(b, s - n_prompt, d)], 1)

    decode._moe_mlp = moe_mlp  # pylint: disable=protected-access
    try:
        yield
    finally:
        decode._moe_mlp = served  # pylint: disable=protected-access


def moe_window(model, dev, counters, new_tokens, **engine_kw):
    """One MoE serving window: ModelServer('mixtral-8x7b') cut to
    MOE_LAYERS on `model`, 6 concurrent greedy /generate requests of
    MOE_LENGTHS and one seeded sampled request, then the 100-token
    prompt again; launch counts zeroed just before the requests and
    read just after."""
    from skypilot_tpu_torch.serve import model_server
    server = model_server.ModelServer(
        'mixtral-8x7b', overrides={'n_layers': MOE_LAYERS},
        continuous_batching=True, max_len=1024, max_batch=8, params=model,
        device=dev, **engine_kw)
    vocab = server.cfg.vocab_size
    prompts = [prompt(700 + i, n, vocab) for i, n in enumerate(MOE_LENGTHS)]
    bodies = [{'prompt_ids': [p], 'max_new_tokens': new_tokens}
              for p in prompts]
    bodies.append({'prompt_ids': [prompt(720, 48, vocab)],
                   'max_new_tokens': new_tokens, 'temperature': 0.8,
                   'top_k': 40, 'seed': 7})
    try:
        zero_counts(counters)
        tokens, wall = greedy_burst(server, bodies)
        again, _ = greedy_burst(server, bodies[3:4])
        launches = read_counts(counters)
        stats = server.engine.stats()
    finally:
        server.close()
    if any(not 0 <= t < vocab for t in tokens[-1]):
        raise AssertionError(f'sampled tokens out of the vocab: {tokens[-1]}')
    if again[0] != tokens[3]:
        raise AssertionError('the repeated greedy prompt gave other tokens')
    want_b3 = (len(bodies) + 1) * MOE_LAYERS
    if launches['flash_fwd'] != want_b3:
        raise AssertionError(f'B3 ran {launches["flash_fwd"]} times, not once '
                             f'per prompt and layer ({want_b3})')
    if stats.get('prefix_cache_entries', 0) or stats.get(
            'prefix_cache_hits', 0):
        raise AssertionError(f'MoE pages were reused: {stats}')
    return launches, {'prompts': prompts, 'tokens': tokens[:len(prompts)],
                      'tokens_per_s': new_tokens * len(bodies) / wall,
                      'ticks': stats['ticks']}


def hold_moe(what, cfg, model, window, ref, quantized=False):
    """Every greedy token of a window held at its own context
    (`hold_tokens` under `moe_as_served`); -> (holds, each prompt's
    dropped assignments summed over the layers)."""
    holds, dropped = [], []
    for p, got, other in zip(window['prompts'], window['tokens'], ref):
        drops = []
        with moe_as_served(len(p), drops):
            holds.append(hold_tokens(what, cfg, model, p, got, other,
                                     quantized=quantized))
        # hold_tokens runs two forwards; each records every layer.
        dropped.append(sum(drops[:cfg.n_layers]))
    return holds, dropped


def moe_expert_cast_ms(model):
    """ms of one tick's f32 expert casts: the three stacks of one layer
    to f32 (what the s == 1 dense gather makes), times the layers.  CUDA
    events: three launches of ~1.5 ms each carry no host time worth
    separating (and a profiler window here, after the earlier phases'
    many, once saw no device events)."""
    import torch
    moe = model.layers[0].moe_mlp

    def cast():
        for name in ('gate_proj', 'up_proj', 'down_proj'):
            moe.stack(name, torch.float32)
    return time_ms(cast, iters=5, warmup=1) * model.cfg.n_layers


def moe_checkpoint(dev, counters, new_tokens):
    """A depth-1 Mixtral-width HF source (the port's writer) ->
    import_weights.convert -> ModelServer('auto') answers /generate;
    launches read around that server's life; after the read an
    in-memory server on the writer's weights must give the same
    tokens.  The directories are deleted as soon as they are read."""
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import import_weights
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('mixtral-8x7b', n_layers=1)
    kw = dict(continuous_batching=True, kv_pages=256, page_size=16,
              max_len=1024, max_batch=8, device=dev)
    bodies = [{'prompt_ids': [prompt(740 + i, n, cfg.vocab_size)],
               'max_new_tokens': new_tokens}
              for i, n in enumerate(MOE_LENGTHS[:4])]
    root = tempfile.mkdtemp(prefix='skytpu_moe_ckpt_')
    out = {}
    try:
        src, ckpt = f'{root}/hf', f'{root}/ckpt'
        writer = bf16_exact_model(cfg, 41, dev)
        t0 = time.perf_counter()
        write_hf_source(writer, src)
        out['source_s'] = time.perf_counter() - t0
        out['source_gb'] = disk_bytes(src) / 1e9
        t0 = time.perf_counter()
        converted = import_weights.convert(src, ckpt, dtype='bfloat16')
        out['convert_s'] = time.perf_counter() - t0
        shutil.rmtree(src)
        if converted != cfg:
            raise AssertionError(f'converted config {converted} != {cfg}')
        zero_counts(counters)
        auto = model_server.ModelServer('auto', checkpoint_dir=ckpt, **kw)
        try:
            tokens, _ = greedy_burst(auto, bodies)
        finally:
            auto.close()
        launches = read_counts(counters)
        same_weights(auto.params, writer, 'the restored Mixtral checkpoint')
        del auto
        fresh = model_server.ModelServer('auto', checkpoint_dir=ckpt,
                                         params=writer, **kw)
        shutil.rmtree(ckpt)
        try:
            want, _ = greedy_burst(fresh, bodies)
        finally:
            fresh.close()
        if tokens != want:
            raise AssertionError('--model auto (Mixtral) tokens differ from '
                                 'the in-memory server\'s')
        del writer, fresh
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()
    return launches, out


def moe_reference_check(dev):
    """Depth-1 f32 Mixtral width: GPU kernels vs the CPU plain versions,
    greedy tokens of 2 prompts, paged and dense engines."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    cfg = configs.get_config('mixtral-8x7b', n_layers=1,
                             dtype=torch.float32)
    gpu_model = init_params(cfg, seed=43, device=dev)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu')
    prompts = [prompt(760, 12, cfg.vocab_size),
               prompt(761, 40, cfg.vocab_size)]
    toks = {}
    for mode, kv_pages in (('paged', 32), ('dense', None)):
        for device, model in (('gpu', gpu_model), ('cpu', cpu_model)):
            engine = batching_engine.ContinuousBatchingEngine(
                cfg, model, max_len=128, slots=2, kv_pages=kv_pages,
                page_size=16, device=model.device)
            try:
                reqs = [engine.submit(p, 8) for p in prompts]
                toks[mode, device] = [r.result(timeout=600) for r in reqs]
            finally:
                engine.stop()
        if toks[mode, 'gpu'] != toks[mode, 'cpu']:
            raise AssertionError(f'MoE {mode}: GPU vs CPU greedy tokens '
                                 f'differ:\n{toks[mode, "gpu"]}\n'
                                 f'{toks[mode, "cpu"]}')
    del gpu_model, cpu_model
    free_cuda()


def moe_serving(dev, counters, new_tokens):
    """Phase 5c; returns {path: launch counts}."""
    import torch
    from skypilot_tpu_torch import profile_decode
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models.transformer import init_params
    t_phase = time.perf_counter()
    cfg = configs.get_config('mixtral-8x7b', n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=31, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gib = weight_bytes(model) / 2**30
    paged = dict(kv_pages=1024, page_size=16)
    paths, windows = {}, {}
    for name, kw, launched, idle in (
            ('moe paged', paged, ('paged_attention', 'flash_fwd'),
             ('paged_attention_int8',)),
            ('moe int8 pool', dict(paged, quantize_kv=True),
             ('paged_attention_int8', 'flash_fwd'), ('paged_attention',)),
            ('moe dense', {}, ('flash_fwd',),
             ('paged_attention', 'paged_attention_int8'))):
        paths[name], windows[name] = moe_window(model, dev, counters,
                                                new_tokens, **kw)
        expect_launches(name, paths[name], launched, idle)
    holds, dropped = {}, None
    for name, other in (('moe paged', 'moe dense'),
                        ('moe int8 pool', 'moe paged'),
                        ('moe dense', 'moe paged')):
        holds[name], drops = hold_moe(
            f'{name} greedy', cfg, model, windows[name],
            windows[other]['tokens'], quantized=name == 'moe int8 pool')
        dropped = dropped or drops
    tick = profile_decode.profile_tick(cfg, model, dev)
    cast_ms = moe_expert_cast_ms(model)
    del model
    free_cuda()
    paths['moe checkpoint'], ck = moe_checkpoint(dev, counters, new_tokens)
    expect_launches('moe checkpoint', paths['moe checkpoint'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    moe_reference_check(dev)
    summary = {k: tick[k] for k in ('tick_ms', 'device_ms_per_tick',
                                    'device_idle_share', 'kernels_per_tick')}
    top = [(k[:48], n, ms) for k, n, ms in tick['top_device_ops'][:6]]
    log(f'MoE (mixtral-8x7b width, depth {MOE_LAYERS}, bf16; {card()}): '
        f'weights {gib:.2f} GiB, seeded init {init_s:.1f} s; 7 concurrent '
        f'/generate (6 greedy of {list(MOE_LENGTHS)} tokens, 1 sampled) '
        + '; '.join(f'{n}: {w["tokens_per_s"]:.1f} tokens/s, {w["ticks"]} '
                    f'ticks, held: {hold_summary(holds[n])}'
                    for n, w in windows.items())
        + f'; the repeated 100-token prompt gave its tokens again, no '
        f'prefix entry; prefill dispatch dropped (token, expert) '
        f'assignments per prompt, summed over the layers: {dropped}; '
        f'paged tick at 8 slots (profile_decode, printed, not held) '
        f'{json.dumps(summary)}; f32 expert casts {cast_ms:.2f} ms a tick '
        f'(CUDA events; {cast_ms / tick["device_ms_per_tick"]:.1%} of the '
        f'device ms); '
        f'top device ops {json.dumps(top)}')
    log(f'MoE checkpoint (depth 1): HF source {ck["source_gb"]:.2f} GB '
        f'written in {ck["source_s"]:.1f} s, import_weights.convert '
        f'{ck["convert_s"]:.1f} s, --model auto greedy tokens equal to an '
        f'in-memory server\'s; depth-1 f32 GPU == CPU greedy tokens (paged '
        f'and dense); launches {json.dumps(paths)}; the phase '
        f'{time.perf_counter() - t_phase:.1f} s')
    return paths


# ------------------------------------------------------------ phase 7

TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 2048
WARMUP_STEPS, TIMED_STEPS = 2, 5
TRAIN_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')


def run_steps(dev, cfg, tcfg, batch, n_steps, state=None):
    """n_steps train_steps (a fresh seed-0 state unless given), each
    synchronised; -> (state, [(loss, grad_norm, ms)])."""
    import torch
    from skypilot_tpu_torch.models import train
    if state is None:
        state, _ = train.create_train_state(cfg, tcfg, device=dev, seed=0)
    out = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train.train_step(state, batch, tcfg)
        loss, norm = float(m['loss']), float(m['grad_norm'])
        torch.cuda.synchronize()
        out.append((loss, norm, (time.perf_counter() - t0) * 1e3))
    return state, out


def profile_step(state, batch, tcfg):
    """One profiled train_step, its wall time and its device time both
    from the one trace: -> dict of device kernel ms, the step's wall ms
    (its range, closed by a synchronize), the device's busy ms inside it
    (the union of its kernels' intervals), the idle share, the kernel
    count, ms by kernel group and the top kernels."""
    import torch
    from skypilot_tpu_torch.models import train
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function('chip_smoke_train_step'):
            train.train_step(state, batch, tcfg)
            torch.cuda.synchronize()

    def dev_us(e):
        return float(getattr(e, 'self_device_time_total', 0.0) or 0.0)
    step = [e for e in prof.events() if e.name == 'chip_smoke_train_step'
            and e.device_type != cuda]
    if len(step) != 1:
        raise AssertionError(f'train profile: {len(step)} step ranges')
    wall_us = step[0].time_range.end - step[0].time_range.start
    busy_us, until = 0.0, -math.inf
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events() if is_device_event(e)):
        busy_us += max(0.0, end - max(start, until))
        until = max(until, end)
    idle = 1 - busy_us / wall_us
    if not 0 <= idle <= 1:
        raise AssertionError(f'train profile: device busy {busy_us} us '
                             f'against a {wall_us} us step')
    events = [e for e in prof.key_averages() if is_device_event(e)]
    top = sorted(events, key=dev_us, reverse=True)[:16]
    groups = {}
    for e in events:
        group = kernel_group(e.key)
        groups[group] = groups.get(group, 0.0) + dev_us(e) / 1e3
    return dict(device_ms=sum(dev_us(e) for e in events) / 1e3,
                wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle=idle,
                n_kernels=sum(e.count for e in events),
                groups={k: round(v, 3) for k, v in sorted(groups.items())},
                top=[(e.key[:60], e.count, round(dev_us(e) / 1e3, 3))
                     for e in top])


def kernel_group(name: str) -> str:
    """A CUDA kernel's group in the step breakdown, from its name."""
    low = name.lower()
    if 'flash_' in low:
        return 'attention B3/B4/B5'
    if any(tag in low for tag in ('gemm', 'nvjet', 'xmma', 'cutlass')):
        if 'f32f32' in low or 'sgemm' in low:
            return 'f32 GEMM (lm_head)'
        return 'bf16 GEMM'
    if 'multi_tensor_apply' in low:
        return 'optimizer (foreach)'
    return 'other (elementwise, reductions, copies)'


def free_cuda():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_main_path(dev, counters):
    """llama3-8b at 4 layers: the unfused run (launch counts read around
    it), a profiled step, then fused CE + accum_steps=2 from the same
    initial weights.  -> launches of the run."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    cfg = configs.get_config('llama3-8b', n_layers=TRAIN_LAYERS)
    tcfg = train.TrainConfig()
    gen = torch.Generator().manual_seed(0)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ + 1),
                                     generator=gen).to(dev)}
    free_cuda()
    log(f'train: llama3-8b n_layers={TRAIN_LAYERS}, batch {TRAIN_BATCH} x '
        f'{TRAIN_SEQ}, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB '
        'allocated before')
    torch.cuda.reset_peak_memory_stats(dev)
    n_steps = WARMUP_STEPS + TIMED_STEPS
    zero_counts(counters)
    state, steps = run_steps(dev, cfg, tcfg, batch, n_steps)
    counts = read_counts(counters)
    launches = {name: counts[name] for name in TRAIN_KERNELS}
    peak = train.peak_memory_bytes(dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    losses = [x[0] for x in steps]
    step_ms = statistics.median(x[2] for x in steps[WARMUP_STEPS:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f'train: {n_params / 1e9:.3f} B parameters; losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; grad_norms '
        f'{" ".join(f"{x[1]:.3f}" for x in steps)}')
    log(f'train: step ms {" ".join(f"{x[2]:.1f}" for x in steps)}; median '
        f'of the {TIMED_STEPS} timed {step_ms:.1f} ms = '
        f'{tokens / step_ms * 1e3:.0f} tokens/s; peak memory '
        f'{peak / 2**30:.2f} GiB; launches {launches}')
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f'train: non-finite loss {losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'train: loss did not fall: {losses}')
    want = {'flash_fwd': 2 * TRAIN_LAYERS * n_steps,
            'flash_bwd_dq': TRAIN_LAYERS * n_steps,
            'flash_bwd_dkv': TRAIN_LAYERS * n_steps}
    if launches != want:
        raise AssertionError(f'train: launches {launches}, expected {want} '
                             f'(2L / L / L per step)')
    prof = profile_step(state, batch, tcfg)
    log(f'train profile: one profiled step of {prof["wall_ms"]:.1f} ms '
        f'wall, device busy {prof["busy_ms"]:.1f} ms of it (idle share '
        f'{prof["idle"]:.4f}), {prof["device_ms"]:.1f} ms of device '
        f'kernels ({prof["n_kernels"]} kernels); by group '
        f'{json.dumps(prof["groups"])}; top {json.dumps(prof["top"])}')
    del state
    free_cuda()

    fused = train.TrainConfig(fused_ce=True, accum_steps=2)
    torch.cuda.reset_peak_memory_stats(dev)
    state, fsteps = run_steps(dev, cfg, fused, batch, 2)
    log(f'train fused_ce + accum_steps=2: losses '
        f'{" ".join(f"{x[0]:.4f}" for x in fsteps)}, grad_norms '
        f'{" ".join(f"{x[1]:.3f}" for x in fsteps)}, step ms '
        f'{" ".join(f"{x[2]:.1f}" for x in fsteps)}, peak memory '
        f'{train.peak_memory_bytes(dev) / 2**30:.2f} GiB')
    for i, what in ((0, 'loss'), (1, 'grad_norm')):
        a, b = fsteps[0][i], steps[0][i]
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f'train: fused+accum step-1 {what} {a} vs '
                                 f'unfused {b}')
    del state
    free_cuda()
    return counts


def cli_check(counters):
    """`train_llama --model small`: -> launches of the run."""
    from skypilot_tpu_torch import train_llama
    with train_log_dir():
        zero_counts(counters)
        history = train_llama.main(['--model', 'small', '--steps', '3',
                                    '--batch-size', '8', '--seq-len', '512'])
        counts = read_counts(counters)
    launches = {name: counts[name] for name in TRAIN_KERNELS}
    losses = [h['loss'] for h in history]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f'train_llama small: non-finite loss {losses}')
    if min(launches.values()) <= 0:
        raise AssertionError(f'train_llama small: launches {launches}')
    log(f'train_llama --model small: losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; launches {launches}')
    free_cuda()
    return counts


# ----------------------------------------------------------- phase 7b

RESUME_STEPS = 5
RESUME_TOKENS = 4_194_304        # a 16 MB uint32 token file
RESUME_DISK_GB = 20.0            # 15.2 GB step + 2.5 GB HF source + init


@contextlib.contextmanager
def train_log_dir():
    """A summary.json directory of its own for the train_llama runs
    inside (a fresh callbacks singleton), deleted after; yields its
    path."""
    import os
    import shutil
    import tempfile
    from skypilot_tpu_torch.callbacks import base as callbacks
    log_dir = tempfile.mkdtemp(prefix='skytpu_train_logs_')
    before = os.environ.get(callbacks.ENV_LOG_DIR)
    os.environ[callbacks.ENV_LOG_DIR] = log_dir
    callbacks.reset()
    try:
        yield log_dir
    finally:
        callbacks.reset()
        if before is None:
            os.environ.pop(callbacks.ENV_LOG_DIR, None)
        else:
            os.environ[callbacks.ENV_LOG_DIR] = before
        shutil.rmtree(log_dir, ignore_errors=True)


class Tee:
    """sys.stdout that also keeps what was printed."""

    def __init__(self, out):
        self.out, self.kept = out, []

    def write(self, text):
        self.kept.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def resume_run(argv, ckpt=None):
    """train_llama.run(argv) with SKYTPU_CHECKPOINT_DIR=ckpt (or unset)
    and a summary of its own; -> (history, state, printed, summary)."""
    import os
    from skypilot_tpu_torch import train_llama
    from skypilot_tpu_torch.callbacks import base as callbacks
    from skypilot_tpu_torch.data import checkpoints
    if ckpt is None:
        os.environ.pop(checkpoints.ENV_CHECKPOINT_DIR, None)
    else:
        os.environ[checkpoints.ENV_CHECKPOINT_DIR] = ckpt
    try:
        with train_log_dir() as log_dir:
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                history, state = train_llama.run(argv)
            with open(f'{log_dir}/{callbacks.SUMMARY_FILE}',
                      encoding='utf-8') as f:
                summary = json.load(f)
    finally:
        os.environ.pop(checkpoints.ENV_CHECKPOINT_DIR, None)
    return history, state, ''.join(tee.kept), summary


def train_state_leaves(state):
    """{name: tensor} of every parameter, both AdamW moments and the
    optimizer's step count, plus the TrainState's step."""
    from skypilot_tpu_torch.models import train
    out = {'step': state.step}
    for path, p in train.param_paths(state.model):
        name = '/'.join(path)
        st = state.optimizer.state[p]
        out.update({name: p.detach(), f'mu/{name}': st['exp_avg'],
                    f'nu/{name}': st['exp_avg_sq'],
                    f'count/{name}': st['step']})
    return out


def same_train_state(a, b, what) -> None:
    """Fail unless two TrainStates hold the same leaves, bit for bit."""
    import torch
    la, lb = train_state_leaves(a), train_state_leaves(b)
    if sorted(la) != sorted(lb) or la['step'] != lb['step']:
        raise AssertionError(f'{what}: leaves or step differ')
    for name, x in la.items():
        if name == 'step':
            continue
        y = lb[name]
        if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f'{what}: {name} differs')


def training_resume(dev, counters):
    """Phase 7b: token file + converted init -> run U (5 steps), run A
    (1 step, saves step 0), run B (resumes at 1); -> (launches of the
    three runs, numbers to print)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from skypilot_tpu_torch.data import checkpoints
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import import_weights
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('llama3-8b', n_layers=1)
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix='skytpu_train_resume_')
    out = {'free_gb': shutil.disk_usage(root).free / 1e9}
    if out['free_gb'] < RESUME_DISK_GB:
        shutil.rmtree(root)
        raise AssertionError(f'training resume needs ~{RESUME_DISK_GB} GB '
                             f'of free disk under {root}: '
                             f'{out["free_gb"]:.1f} GB')
    try:
        tok, src = f'{root}/tokens.bin', f'{root}/hf'
        init, ckpt = f'{root}/init', f'{root}/ckpt'
        loader.write_token_file(tok, np.random.default_rng(17).integers(
            0, cfg.vocab_size, RESUME_TOKENS, dtype=np.uint32))
        writer = bf16_exact_model(cfg, 31, dev)
        write_hf_source(writer, src)
        del writer
        free_cuda()
        t0 = time.perf_counter()
        if import_weights.convert(src, init, dtype='bfloat16') != cfg:
            raise AssertionError('converted config differs')
        out['convert_s'] = time.perf_counter() - t0
        out['used_gb'] = disk_bytes(root) / 1e9
        shutil.rmtree(src)
        argv = ['--model', 'auto', '--init-from', init, '--data', tok,
                '--batch-size', str(TRAIN_BATCH), '--seq-len', str(TRAIN_SEQ),
                '--device', str(dev)]
        save_hist = checkpoints.checkpoint_save_hist()
        blocked = checkpoints.checkpoint_blocked_counter()

        zero_counts(counters)
        hist_u, state, _, sum_u = resume_run(
            argv + ['--steps', str(RESUME_STEPS)])
        del state
        free_cuda()
        saves, save_s, blocked_s = (save_hist.count, save_hist.sum,
                                    blocked.value)
        hist_a, state_a, printed_a, _ = resume_run(argv + ['--steps', '1'],
                                                   ckpt)
        out['save_s'] = save_hist.sum - save_s
        out['blocked_s'] = blocked.value - blocked_s
        if save_hist.count - saves != 1 or checkpoints.latest_step(
                ckpt) != 0:
            raise AssertionError(f'run A: {save_hist.count - saves} saves, '
                                 f'newest step '
                                 f'{checkpoints.latest_step(ckpt)}')
        out['step_gb'] = disk_bytes(f'{ckpt}/0') / 1e9
        out['used_gb'] = max(out['used_gb'], disk_bytes(root) / 1e9)
        fresh, _ = train.create_train_state(cfg, device=dev, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, start = checkpoints.restore_or_init(fresh, ckpt)
        torch.cuda.synchronize()
        out['restore_s'] = time.perf_counter() - t0
        if start != 1:
            raise AssertionError(f'restore_or_init start_step {start}')
        same_train_state(restored, state_a,
                         'restore_or_init vs run A\'s final state')
        served = convert.from_jax_params(cfg, convert.param_tree(
            state_a.model), device=dev)
        del fresh, restored, state_a
        free_cuda()
        hist_b, state, printed_b, sum_b = resume_run(
            argv + ['--steps', str(RESUME_STEPS)], ckpt)
        launches = read_counts(counters)
        del state
        free_cuda()

        for text, step in ((printed_a, 0), (printed_b, 1)):
            if f'resuming from step {step}' not in text:
                raise AssertionError(f'no "resuming from step {step}"')
        if [h['step'] for h in hist_b] != list(range(1, RESUME_STEPS)):
            raise AssertionError(f'run B ran {[h["step"] for h in hist_b]}')
        if hist_a[0]['loss'] != hist_u[0]['loss']:
            raise AssertionError(f'run A step 0 loss {hist_a[0]["loss"]} vs '
                                 f'U {hist_u[0]["loss"]}')
        rel = [abs(b['loss'] - u['loss']) / abs(u['loss'])
               for b, u in zip(hist_b, hist_u[1:])]
        out['max_rel'] = max(rel)
        out['bit_equal'] = all(b['loss'] == u['loss'] and
                               b['grad_norm'] == u['grad_norm']
                               for b, u in zip(hist_b, hist_u[1:]))
        if out['max_rel'] > 1e-5:
            raise AssertionError(f'run B losses vs U: {rel}')
        out['losses_u'] = [h['loss'] for h in hist_u]
        out['losses_ab'] = [h['loss'] for h in hist_a + hist_b]

        batches = loader.HostShardedBatches(
            loader.TokenDataset(tok), global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ)
        with loader.prefetch_to_device(batches.batches(0),
                                       device=dev) as prefetched:
            for step in range(2):
                got = next(prefetched)['tokens']
                want = torch.from_numpy(batches.batch_at(step)['tokens'])
                if (got.device != dev or got.dtype != torch.int32 or
                        not torch.equal(got.cpu(), want)):
                    raise AssertionError(f'prefetched batch {step} differs '
                                         'from batch_at')

        kw = dict(continuous_batching=True, kv_pages=256, page_size=16,
                  max_len=1024, max_batch=8, device=dev)
        bodies = [{'prompt_ids': [prompt(700 + i, n, cfg.vocab_size)],
                   'max_new_tokens': 16} for i, n in enumerate((37, 250))]
        auto = model_server.ModelServer('auto', checkpoint_dir=ckpt, **kw)
        try:
            tokens, _ = greedy_burst(auto, bodies)
        finally:
            auto.close()
        same_weights(auto.params, served, 'the served training step')
        del auto
        free_cuda()
        fresh = model_server.ModelServer('auto', checkpoint_dir=ckpt,
                                         params=served, **kw)
        try:
            want, _ = greedy_burst(fresh, bodies)
        finally:
            fresh.close()
        if tokens != want:
            raise AssertionError('the training step\'s server and the '
                                 'in-memory server differ')
        del fresh, served
        free_cuda()
        out['summary'] = {run: {k: s[k] for k in (
            'compute_seconds_per_step', 'data_wait_seconds',
            'prefetch_wait_seconds', 'peak_memory_bytes')}
            for run, s in (('U', sum_u), ('B', sum_b))}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out['wall_s'] = time.perf_counter() - t_phase
    return launches, out


def log_training_resume(r, launched) -> None:
    summary = {run: {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in x.items()} for run, x in r['summary'].items()}
    log(f'training resume ({card()}): llama3-8b width at depth 1, batch '
        f'{TRAIN_BATCH} x {TRAIN_SEQ}, --model auto --init-from --data; '
        f'losses U {" ".join(f"{x:.6f}" for x in r["losses_u"])}, A+B '
        f'{" ".join(f"{x:.6f}" for x in r["losses_ab"])}; A step 0 == U; '
        f'B steps 1-4 vs U largest relative difference {r["max_rel"]:.3g} '
        f'(bit-equal: {r["bit_equal"]}); restore_or_init bit-equal to run '
        f'A\'s final state; prefetched batches 0-1 == batch_at; the step\'s '
        f'server == an in-memory server on the same params (2 prompts)')
    log(f'training resume seconds ({card()}): convert {r["convert_s"]:.2f}; '
        f'checkpoint write {r["save_s"]:.2f} ({r["step_gb"]:.2f} GB step); '
        f'blocked {r["blocked_s"]:.3f}; restore {r["restore_s"]:.2f}; '
        f'summary.json {json.dumps(summary)}; free disk before '
        f'{r["free_gb"]:.1f} GB, used at peak {r["used_gb"]:.2f} GB; the '
        f'phase {r["wall_s"]:.1f} s; launches {json.dumps(launched)}')


# ------------------------------------------------------------ phase 8


def train_reference_check(dev):
    """Depth-1 f32 llama3-8b: loss and gradients, GPU vs CPU."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.models.transformer import init_params
    cfg = configs.get_config('llama3-8b', n_layers=1, dtype=torch.float32)
    gpu_model = init_params(cfg, seed=1, device=dev, trainable=True)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu', trainable=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 257),
                           generator=torch.Generator().manual_seed(3))
    loss = {}
    for model in (gpu_model, cpu_model):
        t = tokens.to(model.device)
        out = train.loss_fn(model(t[:, :-1]), t[:, 1:])
        out.backward()
        loss[model.device.type] = float(out.detach())
    if not abs(loss['cuda'] - loss['cpu']) <= 1e-3 * abs(loss['cpu']):
        raise AssertionError(f'train reference: loss GPU {loss["cuda"]} vs '
                             f'CPU {loss["cpu"]}')
    worst = (0.0, '')
    for (name, pg), (_, pc) in zip(gpu_model.named_parameters(),
                                   cpu_model.named_parameters()):
        ref = pc.grad
        rel = (float((pg.grad.cpu() - ref).abs().max()) /
               max(float(ref.abs().max()), 1e-30))
        if rel > 1e-3:
            raise AssertionError(f'train reference: {name} gradient GPU vs '
                                 f'CPU {rel:.3g} of max |CPU|')
        worst = max(worst, (rel, name))
    return loss, worst


def expect_launches(path, counts, launched, idle=()):
    """Fail unless every kernel in `launched` ran on the path and none
    in `idle` did."""
    missing = [n for n in launched if counts[n] <= 0]
    stray = [n for n in idle if counts[n] > 0]
    if missing or stray:
        raise AssertionError(f'{path}: kernels not launched {missing}, '
                             f'launched but not on this path {stray}')


def more_serving(cfg, model, dev, counters, new_tokens):
    """The paths each zeroed just before and read just after, around
    the engine work alone (the reference paths and the holds run after
    the read): the replica front, 16-slot speculation, dense serving
    over HTTP, the legacy loop, the KV handoff.  Returns {path: launch
    counts}."""
    paths = {}
    paths['replica front'], front = replica_front(cfg, model, dev, counters,
                                                  new_tokens)
    expect_launches('replica front', paths['replica front'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    hold = front['budget_hold']
    log(f'replica front ({card()}; host-clock times, printed, not held): '
        f'{front["wall_s"]:.1f} s for the phase with both servers and the '
        f'holds; async /generate {front["generate_s"] * 1e3:.1f} ms for '
        f'{new_tokens} tokens, TTFT {front["ttft_ms"]:.1f} ms; 5 '
        f'concurrent /generate_stream {front["streams_tokens_per_s"]:.1f} '
        f'tokens/s ({front["streams_s"]:.2f}s); greedy /generate, streams '
        f'and the stream /drain let finish equal to the threaded front; '
        f'batch class = the first {BATCH_BUDGET} unclamped tokens; decode '
        f'budget: {BUDGET_PROMPT - 1} one-token pieces, '
        f'{front["budget_s"] * 1e3:.1f} ms for the request, tokens '
        + ('equal to the unclamped run' if hold is None else
           f'held token by token ({hold_summary([hold])})')
        + f'; a client gone after two events: cancelled at '
        f'{front["gone_tokens"]} tokens, slots and pages back in '
        f'{front["freed_s"] * 1e3:.0f} ms; sentinel (calls, signatures, '
        f'steady) {json.dumps(front["sentinel"])} (the decode budget\'s '
        f'one-token chunk 0 and width-1 continuations are new signatures '
        f'by design, not recompiles); launches '
        f'{json.dumps(paths["replica front"])}')
    paths['spec beyond one bucket'], spec = spec_past_one_bucket(
        cfg, model, dev, new_tokens, counters)
    expect_launches('spec beyond one bucket',
                    paths['spec beyond one bucket'],
                    ('paged_attention_int8', 'flash_fwd'))
    blocked, one_call = verify_tick_cost(cfg, model, dev)
    log(f'int8 + spec(4) at 16 slots (80 rows): greedy equal to spec-off; '
        f'accept len {spec["spec_accept_len_mean"]}; verify tick in two '
        f'64-row blocks {blocked["ms"]:.3f} ms device '
        f'({blocked["ms_with_host"]:.3f} with host), as one 128-row call '
        f'{one_call["ms"]:.3f} ({one_call["ms_with_host"]:.3f})')

    zero_counts(counters)
    dense = dense_serving(cfg, model, dev, new_tokens)
    paths['dense serving'] = read_counts(counters)
    expect_launches('dense serving', paths['dense serving'], ('flash_fwd',),
                    ('paged_attention', 'paged_attention_int8'))
    holds = hold_dense(cfg, model, dense, new_tokens)
    log(f'dense http: {dense["tokens_per_s"]:.1f} tokens/s over 6 '
        f'concurrent requests ({dense["wall"]:.2f}s); TTFT (100-token '
        f'prompt, idle engine) {dense["ttft_ms"]:.1f} ms; ticks '
        f'{dense["ticks"]}; /generate_stream == /generate, '
        f'/generate_text streamed == whole; vs decode.generate: '
        f'{hold_summary(holds)}')

    zero_counts(counters)
    legacy = legacy_serving(cfg, model, dev, new_tokens, dense)
    paths['legacy'] = read_counts(counters)
    expect_launches('legacy', paths['legacy'], ('flash_fwd',),
                    ('paged_attention', 'paged_attention_int8'))
    holds = [hold_tokens('legacy vs pipelined', cfg, model, p, g, ref)
             for p, g, ref in zip(dense['prompts'], legacy['tokens'],
                                  dense['tokens'])]
    log(f'legacy (pipelined=False): {legacy["tokens_per_s"]:.1f} tokens/s; '
        f'vs the dense pipelined engine: {hold_summary(holds)}')

    paths['handoff'], moved = handoff(cfg, model, dev, new_tokens, counters)
    expect_launches('handoff', paths['handoff'],
                    ('flash_fwd', 'paged_attention', 'paged_attention_int8'))
    kernel = {'bf16': 'paged_attention', 'int8': 'paged_attention_int8'}
    for pool, r in moved.items():
        expect_launches(f'handoff export ({pool})', r['export_launches'],
                        ('flash_fwd',),
                        ('paged_attention', 'paged_attention_int8'))
        expect_launches(f'handoff import ({pool} pool)',
                        r['import_launches'], (kernel[pool],))
        exported = r['export_launches']['flash_fwd']
        imported = r['import_launches'][kernel[pool]]
        log(f'handoff into a {pool} pool: {r["frame_bytes"]} frame bytes, '
            f'export {r["export_ms"]:.1f} ms ({exported} B3), import '
            f'{r["import_ms"]:.1f} ms, then {imported} {kernel[pool]} '
            f'launches;'
            f' beside a second engine on another stream the same tokens, '
            f'every ticket counter at 0; vs one engine: '
            f'{hold_summary([r["hold"]])}')
    log(f'launches: {json.dumps(paths)}')
    return paths


def log_observability(obs) -> None:
    def spread(xs):
        return (f'{" / ".join(f"{x:.2f}" for x in xs)} '
                f'(range {max(xs) - min(xs):.2f})')
    log(f'observability (bf16 and int8 pools): /metrics deltas equal '
        f'engine.stats(), TTFT count +6; /spans one ordered engine segment '
        f'per id; /logs one access record per id; int8 pool '
        f'{obs["int8_ring"]} ticks in the ring; bf16 pool /profile '
        f'{obs["ring"]} ticks in the ring '
        f'(capacity {obs["ring_ticks"]}), tick ms p50 '
        f'{obs["tick_ms_p50"]:.2f} (min {obs["tick_ms_min"]:.2f}, max '
        f'{obs["tick_ms_max"]:.2f}), phase ms {json.dumps(obs["phases"])}, '
        f'memory watermark {obs["mem_watermark_gib"]:.2f} GiB')
    log(f'observability cost: modeled {obs["per_lap_us"]:.3f} us a lap, '
        f'{obs["laps_per_tick"]:.2f} laps a tick, {obs["overhead_ms"]:.3f} '
        f'ms over {obs["ticks"]} ticks; ring {obs["ring_bytes_per_tick"]:.0f}'
        f' JSON bytes a tick; host ms a tick (6 requests x 32 tokens, '
        f'off, on, on, off): plane on {spread(obs["host_ms_on"])}, off '
        f'{spread(obs["host_ms_off"])} (printed, not held)')
    log(f'observability device work: the wrapped step + prefill launch '
        f'the bare entries\' kernels on identical inputs '
        f'({obs["work"]["kernels_per_call"]} kernels a call, '
        f'{obs["work"]["distinct_kernels"]} distinct; B1/B2/B3 '
        f'{obs["work"]["launches"]} over 8 calls each; profiler windows '
        f'off the majority: {obs["work"]["windows_off_majority"]} of 16); '
        f'sentinel '
        f'(calls, signatures, steady): {json.dumps(obs["recompiles"])}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    try:
        from skypilot_tpu_torch.ops import _build
        from skypilot_tpu_torch.ops import attention
        from skypilot_tpu_torch.ops import paged_attention
    except ImportError as e:
        print(f'chip_smoke: the port is not importable: {e}',
              file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    log(card())
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'devices {torch.cuda.device_count()}')

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f}s '
        f'({", ".join(f"{k} {v:.1f}s" for k, v in built.items())})')
    compiled_report(_build)

    log('kernel parity (8B shapes):')
    results = {
        'paged_attention': check_paged(dev, quantized=False),
        'paged_attention_int8': check_paged(dev, quantized=True),
        'flash_fwd': check_flash(dev),
    }
    results.update(check_flash_bwd(dev))
    for name, r in results.items():
        log(f'  {name}: {kernel_summary(r)}')
    log(f'  flash_fwd at the 512-token serving chunk: '
        f'{kernel_summary(results["flash_fwd"]["serving_chunk"])}')
    for name in ('paged_attention', 'paged_attention_int8'):
        log(f'  {name} at the full batch (8 slots x 1000): '
            f'{kernel_summary(results[name]["full_batch"])}')
    counters = {'paged_attention': paged_attention.LAUNCHES,
                'paged_attention_int8': paged_attention.LAUNCHES,
                'flash_fwd': attention.LAUNCHES,
                'flash_bwd_dq': attention.LAUNCHES,
                'flash_bwd_dkv': attention.LAUNCHES}

    from skypilot_tpu_torch.serve import model_server
    new_tokens = 32
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    server = model_server.ModelServer(
        'llama3-8b', continuous_batching=True, kv_pages=1024,
        page_size=16, max_len=1024, max_batch=8, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f'llama3-8b init: {time.perf_counter() - t0:.1f}s, '
        f'{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB')
    try:
        tps, wall = serve_over_http(server, server.cfg.vocab_size,
                                    new_tokens)
        req = server.engine.submit(prompt(9, 100, server.cfg.vocab_size),
                                   new_tokens)
        req.result(timeout=600)
        stats = server.engine.stats()
        log(f'http: {tps:.1f} tokens/s over 6 concurrent requests '
            f'({wall:.2f}s); TTFT (100-token prompt, idle engine) '
            f'{req.ttft_s * 1e3:.1f} ms; prefix hits '
            f'{stats["prefix_cache_hits"]} pages; ticks {stats["ticks"]}')
        spec_stats = int8_spec_parity(server.cfg, server.params, dev,
                                      new_tokens)
        log(f'int8 + spec(4): greedy equal to spec-off; accept len '
            f'{spec_stats["spec_accept_len_mean"]}')
        paths = {'serving': read_counts(counters)}
        serving = ('paged_attention', 'paged_attention_int8', 'flash_fwd')
        launches = {name: paths['serving'][name] for name in serving}
        log(f'peak memory: '
            f'{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; '
            f'serving-path launches {launches}')
        missing = [name for name, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f'kernels not launched on the serving '
                                 f'path: {missing}')
        obs = observability(server, dev, new_tokens, counters)
        paths.update(obs['launches'])
        expect_launches('observability', paths['observability'],
                        ('paged_attention', 'flash_fwd'),
                        ('paged_attention_int8',))
        expect_launches('observability (int8 pool)',
                        paths['observability (int8 pool)'],
                        ('paged_attention_int8', 'flash_fwd'),
                        ('paged_attention',))
        log_observability(obs)
    finally:
        server.close()
    cfg, model = server.cfg, server.params
    del server
    free_cuda()
    paths.update(more_serving(cfg, model, dev, counters, new_tokens))
    del model
    free_cuda()
    paths.update(real_weights(dev, counters, new_tokens))
    free_cuda()
    paths.update(moe_serving(dev, counters, new_tokens))
    free_cuda()
    err = reference_check(dev)
    log(f'reference: depth-2 f32 llama3-8b GPU == CPU greedy tokens '
        f'(paged and dense engines); prefill logits max_abs_err {err:.3g}')

    paths['training'] = train_main_path(dev, counters)
    paths['train_llama small'] = cli_check(counters)
    paths['training resume'], resume = training_resume(dev, counters)
    launched = {name: paths['training resume'][name]
                for name in TRAIN_KERNELS}
    want = {'flash_fwd': 2 * 10, 'flash_bwd_dq': 10, 'flash_bwd_dkv': 10}
    if launched != want:
        raise AssertionError(f'training resume: launches {launched}, '
                             f'expected {want} (10 steps at depth 1)')
    log_training_resume(resume, launched)
    loss, (rel, name) = train_reference_check(dev)
    log(f'train reference: depth-1 f32 llama3-8b loss GPU '
        f'{loss["cuda"]:.6f} CPU {loss["cpu"]:.6f}; largest gradient '
        f'difference {rel:.3g} of max |CPU| ({name})')

    sources = {'paged_attention': 'skypilot_tpu_torch/csrc/paged_attention.cu',
               'paged_attention_int8':
                   'skypilot_tpu_torch/csrc/paged_attention.cu',
               'flash_fwd': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
               'flash_bwd_dq': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
               'flash_bwd_dkv': 'skypilot_tpu_torch/csrc/flash_bwd.cu'}
    replaces = {'paged_attention': 'skypilot_tpu/ops/paged_attention.py:104',
                'paged_attention_int8':
                    'skypilot_tpu/ops/paged_attention.py:138',
                'flash_fwd': 'skypilot_tpu/ops/attention.py:138',
                'flash_bwd_dq': 'skypilot_tpu/ops/attention.py:257',
                'flash_bwd_dkv': 'skypilot_tpu/ops/attention.py:306'}
    # `launches` counts the run of the path named by `path`: serving
    # for the decode kernels, "training resume" (this port's newest main
    # path: 10 steps at depth 1, 2L / L / L a step) for the flash
    # kernels.  `launches_by_path`
    # gives each driven path's own count; no two runs are added.
    main_path = {'paged_attention': 'serving',
                 'paged_attention_int8': 'serving',
                 'flash_fwd': 'training resume',
                 'flash_bwd_dq': 'training resume',
                 'flash_bwd_dkv': 'training resume'}
    kernels = [dict(name=name, route='cuda', source=sources[name],
                    replaces=replaces[name],
                    launches=paths[main_path[name]][name],
                    path=main_path[name],
                    launches_by_path={p: c[name] for p, c in paths.items()},
                    **results[name]) for name in results]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
