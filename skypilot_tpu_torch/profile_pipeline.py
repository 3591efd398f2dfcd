"""Step time of pipelined training against one card, and the GPipe
bubble (parallel/pipeline.py).

    python -m skypilot_tpu_torch.profile_pipeline \\
        [--devices cuda:0,cuda:1,cuda:2,cuda:3] [--model llama3-8b]
        [--layers 8] [--batch 8] [--seq 1024] [--microbatches 1,2,4,8]
        [--steps 3] [--profile] [--out PATH] [--dist-backend gloo|nccl]

Trains the model's widths cut to `--layers` (bf16, remat, seeded
random weights, one repeated batch of `--batch` x `--seq` tokens) and
times `--steps` steps after one warm-up, each ended by a synchronise:

- the unsharded step on the first device at `--layers` and at half as
  many layers: their difference is L/2 layers' time, which gives a
  layer's forward + backward t and the rest of the step T_0 (embedding,
  head and loss, clip and AdamW);
- `pipeline.pipeline_train_step` with one stage on each device (S =
  the number of devices, L / S layers a stage) at each M in
  `--microbatches`.

A stage's layers take (L / S) t of device time whatever M is, and
GPipe leaves a stage idle for a share (S - 1) / (M + S - 1) of the
schedule, so the model of a pipelined step is T_0 + (L / S) t (M + S -
1) / M.  The measured bubble is 1 - (L / S) t / (T_M - T_0).  Each
pipelined step also reports its host ms (until the step returns,
before the synchronise), the params + moments stored on each distinct
device (`stored_bytes`: a copy of the embedding, final norm and head on
every stage's card, a stage's layers on its own), each card's peak
(`peak_bytes`, empty on CPU entries) and, with `--profile`, one
profiled step's busy ms on each card.  Prints one
JSON line (written to `--out` too) with the card's name and power
limit; a run on CPU entries says so in `device` and is not a device
measurement.

As one host of a gang (SKYTPU_NUM_HOSTS > 1 with the coordinator's
address, parallel/distributed.py; `--dist-backend`) the stages span
the hosts: `--devices` are this host's entries, one stage each, and S
is the number of every host's entries.  Each host passes its rows of
the global batch of `--batch` and runs its stages
(parallel/pipeline.py's host boundaries); the one-card runs are left
out (no host holds the whole model).  Each pipelined run also reports
its steps' losses, the boundary's bytes and ms a timed step
(`pipeline.take_boundary`: the sends and receives between hosts,
waits for the other host included; the warm-up, which forms the
communicators, left out), the bytes and ms reduced across hosts a
timed step, this host's launches of the flash kernels, and the state
digest after the run (`train.state_digest`: equal on every host where
the holders of each leaf agree); the JSON line starts with the host's
rank.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import time
from typing import Dict, List, Tuple

import torch

from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline

# The flash kernels a training step launches (B3, B4, B5).
TRAIN_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)


def _free(devices) -> None:
    gc.collect()
    if any(d.type == 'cuda' for d in devices):
        torch.cuda.empty_cache()


def _step_ms(state, step, batch, steps: int, devices, warmed=None
             ) -> Tuple[List[float], List[float], List[float]]:
    """(wall ms, host ms, losses) of `steps` steps after one warm-up
    (the losses of every step, the warm-up's first; `warmed()` is
    called once the warm-up has synchronised): the wall time ends with
    a synchronise, the host time when `step` returns (nothing in a step
    waits for the device, so a host time near the wall time says the
    host's launching is what bounds the step)."""
    wall, host, losses = [], [], []
    for i in range(steps + 1):
        _sync(devices)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        t1 = time.perf_counter()
        losses.append(float(metrics['loss']))
        _sync(devices)
        if i:
            wall.append((time.perf_counter() - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
        elif warmed is not None:
            warmed()
    return wall, host, losses


def _counters(state) -> Tuple[Tuple[float, int], Tuple[float, int]]:
    """((seconds, bytes) of the pipeline's host boundaries, (seconds,
    bytes) reduced across hosts) since the last call."""
    return (pipeline.take_boundary(),
            state.host_reduce.take() if state.host_reduce is not None
            else (0.0, 0))


def _busy_ms(state, step, batch, devices) -> Dict[str, float]:
    """One profiled step: {device: ms in which it ran a kernel or a
    copy (the union of its intervals)}, and 'wall' the step's ms."""
    cuda = torch.autograd.DeviceType.CUDA
    _sync(devices)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        _sync(devices)
        wall = (time.perf_counter() - t0) * 1e3
    spans: Dict[int, List[Tuple[float, float]]] = {}
    for e in prof.events():
        if (e.device_type == cuda and
                not getattr(e, 'is_user_annotation', False)):
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    out = {'wall': wall}
    for index, pairs in sorted(spans.items()):
        busy, until = 0.0, float('-inf')
        for start, end in sorted(pairs):
            busy += max(0.0, end - max(start, until))
            until = max(until, end)
        out[f'cuda:{index}'] = busy / 1e3
    return out


def card() -> str:
    """The first card's name and power limit, as nvidia-smi prints
    them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], check=True,
                          capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def batch_tokens(vocab_size: int, batch: int, seq: int) -> torch.Tensor:
    """The run's one global batch of tokens [batch, seq + 1]."""
    gen = torch.Generator().manual_seed(29)
    return torch.randint(0, vocab_size, (batch, seq + 1), generator=gen)


def profile(model: str, layers: int, batch: int, seq: int,
            microbatches: List[int], steps: int, devices,
            profile_steps: bool = False) -> Dict:
    devices = [torch.device(d) for d in devices]
    if any(d.type == 'cuda' for d in devices):
        torch.cuda.init()   # the peak counters below need the allocator
    hosts, rank = distributed.gang()
    n_stages = len(devices) * hosts
    if layers % n_stages or layers % 2:
        raise ValueError(f'--layers {layers} not divisible by 2 and by '
                         f'the {n_stages} stages')
    if batch % hosts:
        raise ValueError(f'--batch {batch} not divisible by the {hosts} '
                         'hosts')
    cfg = configs.get_config(model, n_layers=layers, remat=True)
    tokens = batch_tokens(cfg.vocab_size, batch, seq)
    one = {}
    # The one-card baseline needs the whole model on a card: on one
    # host only.
    for depth in ((layers, layers // 2) if hosts == 1 else ()):
        c = cfg.replace(n_layers=depth)
        state, _ = train.create_train_state(c, device=devices[0], seed=0)
        b = {'tokens': tokens.to(devices[0])}
        one[depth] = statistics.median(_step_ms(
            state, lambda st, x: train.train_step(st, x), b, steps,
            devices[:1])[0])
        del state
        _free(devices)
    t_layer = t_rest = None
    if one:
        t_layer = (one[layers] - one[layers // 2]) / (layers - layers // 2)
        t_rest = one[layers] - layers * t_layer
    mesh = mesh_lib.build_mesh(
        mesh_lib.MeshConfig(data=1, pipeline=n_stages), devices)
    rows = batch // hosts
    mine = {'tokens': tokens[rank * rows:(rank + 1) * rows]}
    runs, digest = {}, None
    cards = [d for d in mesh.distinct_devices() if d.type == 'cuda']
    for m in microbatches:
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        state, _ = pipeline.create_pipeline_train_state(
            cfg, mesh=mesh, batch_size=batch, seq_len=seq, seed=0)
        stored = [3 * b for b in state.shards.device_bytes()]
        step = pipeline.pipeline_train_step(cfg, mesh, m)
        launched = dict(attention.LAUNCHES)
        # The boundary and the reductions of the timed steps only (the
        # warm-up forms the communicators).
        ms, host, losses = _step_ms(state, step, mine, steps, devices,
                                    warmed=lambda: _counters(state))
        launched = {k: attention.LAUNCHES[k] - launched[k]
                    for k in TRAIN_KERNELS}
        (boundary_s, boundary_bytes), (reduce_s, reduce_bytes) = (
            _counters(state))
        peak = [torch.cuda.max_memory_allocated(d) for d in cards]
        busy = (_busy_ms(state, step, mine, devices)
                if profile_steps else None)
        if m == microbatches[-1] and hosts > 1:
            t0 = time.perf_counter()
            digest = (train.state_digest(state), time.perf_counter() - t0)
        del state
        _free(devices)
        t_m = statistics.median(ms)
        stage = None if t_layer is None else layers // n_stages * t_layer
        n = steps
        runs[m] = dict(
            step_ms=ms, median_ms=t_m, host_ms=host, busy_ms=busy,
            losses=losses, launches=launched,
            boundary_bytes=boundary_bytes / n,
            boundary_ms=boundary_s * 1e3 / n,
            reduce_bytes=reduce_bytes / n, reduce_ms=reduce_s * 1e3 / n,
            stored_bytes=stored, peak_bytes=peak,
            model_ms=(None if stage is None else
                      t_rest + stage * (m + n_stages - 1) / m),
            bubble_gpipe=(n_stages - 1) / (m + n_stages - 1),
            bubble_measured=(None if stage is None else
                             1 - stage / (t_m - t_rest)),
            speedup_vs_one_card=(None if not one else one[layers] / t_m))
    cuda = devices[0].type == 'cuda'
    report = dict(
        device=card() if cuda else 'cpu (not a device measurement)',
        devices=[str(d) for d in devices], model=model, layers=layers,
        batch=batch, seq=seq, stages=n_stages,
        one_card_ms={str(k): v for k, v in one.items()},
        layer_ms=t_layer, rest_ms=t_rest,
        pipeline={str(m): r for m, r in runs.items()})
    if hosts > 1:
        report = dict(host=rank, hosts=hosts,
                      backend=distributed.group_backend(),
                      digest=digest[0], digest_s=digest[1], **report)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--devices', default=None,
                        help='comma-separated devices, one stage each '
                             '(default: every visible CUDA device)')
    parser.add_argument('--model', default='llama3-8b')
    parser.add_argument('--layers', type=int, default=8)
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--seq', type=int, default=1024)
    parser.add_argument('--microbatches', default='1,2,4,8')
    parser.add_argument('--steps', type=int, default=3)
    parser.add_argument('--profile', action='store_true',
                        help='one more step a run under torch.profiler: '
                             'each card\'s busy ms')
    parser.add_argument('--out', default=None)
    parser.add_argument('--dist-backend', default=None,
                        choices=distributed.BACKENDS,
                        help='backend of the hosts\' group in a gang '
                             '(default nccl on cards, gloo on the CPU)')
    args = parser.parse_args(argv)
    devices = (args.devices.split(',') if args.devices else
               mesh_lib.default_devices())
    from skypilot_tpu_torch.device import resolve_device  # pylint: disable=import-outside-toplevel
    for dev in dict.fromkeys(devices):
        resolve_device(dev)
    distributed.initialize_from_env(backend=args.dist_backend,
                                    device=devices[0])
    report = profile(args.model, args.layers, args.batch, args.seq,
                     [int(m) for m in args.microbatches.split(',')],
                     args.steps, devices, args.profile)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, 'w', encoding='utf-8') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    try:
        raise SystemExit(main())
    finally:
        distributed.shutdown()
