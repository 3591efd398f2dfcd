"""Where a decode tick's time goes: host clock vs device kernels.

    python -m skypilot_tpu_torch.profile_decode [--model llama3-8b]
        [--slots 8] [--ticks 20] [--quantize-kv | --dense]
        [--quantize int8] [--tensor N [--tensor-devices cuda:0,...]]
        [--out PATH]

Builds the model with seeded random weights on the GPU (int8 matmul
kernels with `--quantize int8`), a paged pool
with `slots` live slots at ragged depths (5 .. 700 tokens), and runs
`decode.paged_engine_step` the way the engine does; with `--dense` the
same slots in a dense slot cache (max_len 1024) and
`decode.engine_step`, the engine's default mode.  With `--tensor N`
the model is cut into N tensor ranks (models/tensor_parallel.py) over
`--tensor-devices` (default: `cuda:0` N times), each rank with its own
pool, and the tick runs every rank; the weights are drawn one leaf at a
time onto the ranks (`convert.init_tensor_parallel`), so a model
larger than one card (mixtral-8x7b at tensor 4 over four cards) never
sits on one whole.  Reports:

- tick_ms: host wall time per tick, each tick synchronised;
- device_ms_per_tick: summed CUDA kernel time per tick from
  torch.profiler, and the device idle share 1 - device / tick;
- kernels_per_tick: CUDA kernel launches per tick;
- the top operators by device time and by host time;
- prefill_ms: a 128-token flash prefill (one bucket).

Needs a CUDA device; prints the JSON (and writes it to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.parallel import mesh as mesh_lib


def _device_us(evt) -> float:
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _build_state(cfg, model, slots: int, quantize_kv: bool, dense: bool,
                 dev):
    ps, max_len = 16, 1024
    rows = max_len // ps
    lengths = [int(5 + i * 695 / max(1, slots - 1)) for i in range(slots)]
    if dense:
        pool = decode.init_slot_cache(cfg, slots, max_len, device=dev,
                                      model=model)
        pool['lengths'][:] = torch.tensor(lengths, dtype=torch.int32)
    else:
        pool = decode.init_paged_cache(cfg, 1 + slots * rows, ps, slots,
                                       rows, quantize_kv=quantize_kv,
                                       device=dev, model=model)
        for slot, length in enumerate(lengths):
            row = list(range(1 + slot * rows, 1 + (slot + 1) * rows))
            decode.paged_admit_slot(pool, slot, row, length)
    state = decode.init_engine_state(slots, device=dev)
    for slot in range(slots):
        state = decode.admit_slot_state(state, slot, 1 + slot, 10 ** 6,
                                        [-1] * 16, [slot, 0], 0.0, 0)
    return pool, state, lengths


def profile_tick(cfg, model, dev, *, slots: int = 8, ticks: int = 20,
                 quantize_kv: bool = False, dense: bool = False,
                 n_prof: int = 5) -> dict:
    """Host ms, device ms, idle share and launches of `model`'s decode
    tick (module docstring), with a 128-token prefill's ms: `ticks`
    timed ticks after 3 warm-ups, then `n_prof` ticks under the
    profiler."""
    pool, state, lengths = _build_state(cfg, model, slots, quantize_kv,
                                        dense, dev)
    step = decode.engine_step if dense else decode.paged_engine_step

    def tick():
        nonlocal state, pool
        state, pool, _ = step(cfg, model, state, pool)
        state['tokens'].tolist()      # the engine's one host read

    with torch.no_grad():
        for _ in range(3):
            tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) * 1e3 / ticks

        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                tick()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device_us = sum(_device_us(e) for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        launches = sum(e.count for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        by_device = sorted(events, key=_device_us, reverse=True)[:12]
        by_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:12]

        prompt = torch.randint(0, cfg.vocab_size, (1, 128), device=dev)
        decode.prefill(cfg, model, prompt, max_len=1024)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode.prefill(cfg, model, prompt, max_len=1024)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3

    device_ms = device_us / 1e3 / n_prof
    return {
        'device': torch.cuda.get_device_name(0),
        'slots': slots, 'lengths': lengths,
        'tensor': tensor_parallel.degree(model),
        'quantize_kv': quantize_kv, 'dense': dense,
        'tick_ms': tick_ms,
        'device_ms_per_tick': device_ms,
        'device_idle_share': max(0.0, 1.0 - device_ms / tick_ms),
        'kernels_per_tick': launches / n_prof,
        'prefill_128_ms': prefill_ms,
        'top_device_ops': [(e.key, e.count / n_prof,
                            _device_us(e) / 1e3 / n_prof) for e in by_device],
        'top_host_ops': [(e.key, e.count / n_prof,
                          e.self_cpu_time_total / 1e3 / n_prof)
                         for e in by_host],
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='llama3-8b')
    parser.add_argument('--slots', type=int, default=8)
    parser.add_argument('--ticks', type=int, default=20)
    parser.add_argument('--quantize-kv', action='store_true')
    parser.add_argument('--quantize', default=None, choices=['int8'],
                        help='int8 weights (dequantized on every call).')
    parser.add_argument('--dense', action='store_true',
                        help='Dense slot cache and decode.engine_step.')
    parser.add_argument('--tensor', type=int, default=1,
                        help='Tensor ranks the model is cut into.')
    parser.add_argument('--tensor-devices', default=None,
                        help='Comma-separated devices of the ranks '
                             '(default: the first card, N times).')
    parser.add_argument('--out', default=None,
                        help='Also write the JSON to this file.')
    args = parser.parse_args(argv)
    if args.dense and args.quantize_kv:
        parser.error('--quantize-kv is a paged pool option')
    if args.tensor > 1 and args.quantize:
        parser.error('--quantize int8 with --tensor: quantize + tensor '
                     'sharding is not supported')
    dev = resolve_device('cuda')
    cfg = configs.get_config(args.model)
    if args.tensor > 1:
        devices = (args.tensor_devices.split(',') if args.tensor_devices
                   else [dev] * args.tensor)
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=args.tensor),
                                   devices)
        # Drawn one leaf at a time onto the ranks: a model too large for
        # one card never sits on it whole.
        model = convert.init_tensor_parallel(cfg, mesh, seed=0)
        dev = model.device
    else:
        model = init_params(cfg, seed=0, device=dev, quantize=args.quantize)
    result = dict(model=args.model, quantize=args.quantize,
                  **profile_tick(cfg, model, dev, slots=args.slots,
                                 ticks=args.ticks,
                                 quantize_kv=args.quantize_kv,
                                 dense=args.dense))
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w', encoding='utf-8') as f:
            f.write(text)
    return result


if __name__ == '__main__':
    main()
