"""Train or finetune a Llama-style model with the port's training step
(`examples/train_llama.py`).

    python -m skypilot_tpu_torch.train_llama --model small --steps 20
    python -m skypilot_tpu_torch.train_llama --model tiny --device cpu
    SKYTPU_CHECKPOINT_DIR=<ckpt> python -m skypilot_tpu_torch.train_llama \
        --model auto --init-from <converted dir> --data <tokens.bin>
    python -m skypilot_tpu_torch.train_llama --model small \
        --mesh-devices cuda:0,cuda:0,cuda:0,cuda:0 --fsdp 2 --sequence 2 \
        --preflight
    python -m skypilot_tpu_torch.train_llama --model tiny --device cpu \
        --mesh-devices cpu,cpu,cpu,cpu --sequence 2 --tensor 2
    SKYTPU_NUM_HOSTS=2 SKYTPU_HOST_RANK=<0|1> \
        SKYTPU_COORDINATOR_ADDRESS=<host 0>:<port> \
        python -m skypilot_tpu_torch.train_llama --model small

- The mesh, as the reference builds it: `MeshConfig(data=-1, fsdp=,
  sequence=, tensor=)` over the device list (parallel/mesh.py), the
  [dcn, ici] axes, with the slices of SKYTPU_NUM_SLICES.  The list is
  every visible card (one CPU entry with `--device cpu`), or
  `--mesh-devices a,b,...`, which may repeat a device (several mesh
  positions on one card, as the reference's virtual devices).
  `--sp-mode ring|ulysses` picks the sequence-parallel attention for
  `--sequence` > 1; `--tensor` > 1 splits heads, kv heads, d_ff and
  vocab over the tensor ranks (column- and row-parallel layers, the
  vocab-parallel embedding and loss; it must divide all four; an MoE
  model's expert stacks split on d_ff, the routing replicated).
  `--preflight` checks the mesh's collectives first
  (parallel/preflight.py).

- A gang (SKYTPU_NUM_HOSTS > 1 with SKYTPU_COORDINATOR_ADDRESS and
  SKYTPU_HOST_RANK, as the gang-exec layer exports them): the hosts
  join one `torch.distributed` group (parallel/distributed.py;
  `--dist-backend`, default nccl on cards and gloo on the CPU; gloo
  on cards only when named, as two hosts on one card need), and the
  mesh is laid out over every host's devices with 'data' across the
  hosts: each host keeps its own part (the other axes inside it),
  passes its rows of the global batch of `--batch-size` x hosts, which
  the step all-gathers to take the reference's microbatches, and the
  hosts sum each step's loss and gradients through the group, so
  every host steps the same bits.  An MoE model trains on several
  hosts with the reference's capacity dispatch over the global batch
  (each block's expert counts exchanged between the hosts).  The
  library's meshes also put 'pipeline' across hosts
  (models/train.py, parallel/pipeline.py); this command has no
  pipeline flag, as the reference's example has none.  An ICI axis
  across hosts raises (A17f-iii).  Host 0 alone writes checkpoints;
  every host resumes from host 0's step.

- `--model auto` reads the shape from `--init-from`'s model_config.json
  (models/import_weights.py writes it).
- `--init-from`: a converted checkpoint whose params start the finetune
  (`train.load_pretrained_params`; fresh optimizer moments).
- The checkpoint contract: with SKYTPU_CHECKPOINT_DIR set, an
  `AsyncCheckpointManager` saves every 10th step (step 0 included), and
  `restore_or_init` resumes from the newest step, which takes precedence
  over `--init-from` once there is one.  The directory also gets the
  model_config.json, so `--model auto --checkpoint-dir` serves it.
- `--data`: a SKYTOK1 token file (data/loader.py), batch `step` =
  `HostShardedBatches.batch_at(step)` (this host's rows of the global
  batch), so a resumed run sees the batches an uninterrupted one would,
  copied to the device ahead of the step (data/prefetch.py).  Without
  it: one global batch of random tokens seeded by the start step (the
  same on every host, which takes its rows), repeated every step as the
  example does.
- `--layers N` keeps the preset's widths at N layers (a depth cut).
- Step telemetry through `callbacks` (summary.json in
  SKYTPU_BENCHMARK_LOG_DIR); after the first step, the peak memory of
  each of the mesh's cards is printed, and on a mesh the params +
  moments stored on each distinct device (`ShardedParams.device_bytes`:
  a copy of each replicated block on every card that holds it).

Prints `step N: loss=... grad_norm=...` every 10 steps and at the last,
and at the end each step's ms on the host clock (every card of the mesh
synchronized before and after the step).  In a gang, every host prints
these, then one JSON line: {"host", "hosts", "backend", "losses",
"grad_norms", "step_ms", "reduce_ms" (the cross-host sums of each step,
CUDA events on a card), "reduce_bytes" (a step), "peak_bytes" (the
largest card's, null on the CPU), "launches" (every kernel's count,
ops/attention.py and ops/paged_attention.py), "digest" (`train.state_digest`: sha256 of the
parameters and moments) and "digest_s" (its seconds)}.
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
from typing import List, Optional, Tuple

import torch

from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import import_weights
from skypilot_tpu_torch.models import train
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import paged_attention
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import preflight
from skypilot_tpu_torch.parallel import sharding

SAVE_INTERVAL_STEPS = 10


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', default='tiny',
                        help=f'preset: {", ".join(sorted(configs.PRESETS))}'
                             "; or 'auto' (the shape from --init-from's "
                             'model_config.json)')
    parser.add_argument('--init-from', default=None,
                        help='converted checkpoint dir '
                             '(models/import_weights.py) to start the '
                             'finetune from; a resume from the checkpoint '
                             'contract takes precedence')
    parser.add_argument('--data', default=None,
                        help='SKYTOK1 token file (data/loader.py); random '
                             'tokens when omitted')
    parser.add_argument('--layers', type=int, default=None,
                        help="the preset's widths at this many layers")
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--seq-len', type=int, default=512)
    parser.add_argument('--fused-ce', action='store_true',
                        help='fused linear + CE loss (models/losses.py): '
                             'the [b, s, V] logits never exist')
    parser.add_argument('--accum-steps', type=int, default=1,
                        help='microbatch gradient accumulation (same loss '
                             'trajectory, lower peak memory)')
    parser.add_argument('--vocab-chunk', type=int, default=8192,
                        help='vocab chunk width for the fused CE')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (every visible card is the mesh's "
                             "device list) or 'cpu' (one entry)")
    parser.add_argument('--fsdp', type=int, default=1)
    parser.add_argument('--tensor', type=int, default=1)
    parser.add_argument('--sequence', type=int, default=1)
    parser.add_argument('--sp-mode', default='ring',
                        choices=['ring', 'ulysses'],
                        help='sequence-parallel strategy when --sequence '
                             '> 1 (ops/ring_attention vs '
                             'ops/ulysses_attention)')
    parser.add_argument('--preflight', action='store_true',
                        help='probe the mesh\'s collectives before training '
                             '(fail fast on a sick fabric)')
    parser.add_argument('--mesh-devices', default=None,
                        help='comma-separated devices of the mesh, in '
                             'position order; may repeat one (several '
                             'positions on one card)')
    parser.add_argument('--dist-backend', default=None,
                        choices=distributed.BACKENDS,
                        help='backend of the hosts\' group in a gang '
                             '(default nccl on cards, gloo on the CPU)')
    return parser


def _devices(args) -> List[torch.device]:
    if args.mesh_devices:
        return [resolve_device(d.strip())
                for d in args.mesh_devices.split(',')]
    return mesh_lib.default_devices(args.device)


def _mesh(args, devices) -> mesh_lib.Mesh:
    return mesh_lib.build_mesh(
        mesh_lib.MeshConfig(data=-1, fsdp=args.fsdp, sequence=args.sequence,
                            tensor=args.tensor),
        devices, num_slices=distributed.num_slices())


def host_batches(args, dataset: loader.TokenDataset
                 ) -> loader.HostShardedBatches:
    """This host's rows of the global batch of --batch-size x hosts,
    as `examples/train_llama.py` cuts them."""
    hosts, rank = distributed.gang()
    return loader.HostShardedBatches(
        dataset, global_batch=args.batch_size * hosts,
        seq_len=args.seq_len, host_rank=rank, num_hosts=hosts)


def random_batch(args, vocab_size: int, start_step: int) -> torch.Tensor:
    """This host's rows of one global batch of random tokens seeded by
    the start step (every host draws the same)."""
    hosts, rank = distributed.gang()
    gen = torch.Generator().manual_seed(start_step)
    tokens = torch.randint(0, vocab_size,
                           (args.batch_size * hosts, args.seq_len + 1),
                           generator=gen, dtype=torch.int64)
    return tokens[rank * args.batch_size:(rank + 1) * args.batch_size]


def _model_config(args) -> configs.ModelConfig:
    if args.model != 'auto':
        depth = {} if args.layers is None else {'n_layers': args.layers}
        return configs.get_config(args.model, **depth,
                                  sequence_parallel=args.sp_mode)
    if args.layers is not None:
        raise SystemExit('--layers cuts a preset; --model auto takes the '
                         'depth of its checkpoint')
    if not args.init_from:
        raise SystemExit('--model auto needs --init-from')
    cfg = import_weights.load_model_config(args.init_from)
    if cfg is None:
        raise SystemExit(f'No model_config.json under {args.init_from}')
    return cfg.replace(sequence_parallel=args.sp_mode)


def _sync(devices: List[torch.device]) -> None:
    for dev in devices:
        torch.cuda.synchronize(dev)


def run(argv: Optional[List[str]] = None
        ) -> Tuple[List[dict], train.TrainState]:
    """Runs the steps; -> (one {'step', 'loss', 'grad_norm'} per step
    run, the final TrainState)."""
    args = _parser().parse_args(argv)
    devices = _devices(args)
    distributed.initialize_from_env(backend=args.dist_backend,
                                    device=devices[0])
    mesh = _mesh(args, devices)
    device = mesh.devices[0]
    if mesh.hosts > 1:
        print(f'mesh: {mesh.global_shape} over {mesh.hosts * mesh.size} '
              f'devices ({mesh.hosts} hosts over '
              f'{distributed.group_backend()}; host {mesh.host_rank}: '
              f'{mesh.shape} over {len(mesh.distinct_devices())} '
              'device(s))', flush=True)
    else:
        print(f'mesh: {mesh.shape} over {len(mesh.distinct_devices())} '
              f'device(s) ({mesh.size} positions)', flush=True)
    if args.preflight:
        probe = preflight.probe_collectives(mesh)
        print(f'collective preflight: {probe}', flush=True)
        preflight.check_collectives(mesh, results=probe)
        print('collective preflight: healthy', flush=True)
    cfg = _model_config(args)
    tcfg = train.TrainConfig(fused_ce=args.fused_ce,
                             accum_steps=args.accum_steps,
                             vocab_chunk=args.vocab_chunk)
    state, _ = train.create_train_state(cfg, tcfg, mesh=mesh, seed=0)

    start_step = 0
    mgr = None
    if checkpoints.checkpoint_dir():
        # Saves run on a background writer (bounded in flight, retried
        # with backoff), off the step's critical path.
        mgr = checkpoints.AsyncCheckpointManager(
            save_interval_steps=SAVE_INTERVAL_STEPS)
        state, start_step = mgr.restore_or_init(state)
        print(f'resuming from step {start_step}', flush=True)
        if (distributed.is_primary() and
                import_weights.load_model_config(mgr.directory) is None):
            import_weights.save_model_config(mgr.directory, cfg)
    if start_step == 0 and args.init_from:
        # A real-weights finetune start; a resume above takes
        # precedence.
        state = train.load_pretrained_params(state, args.init_from)
        print(f'initialized params from {args.init_from}', flush=True)

    cb = callbacks.init(total_steps=args.steps,
                        tokens_per_step=args.batch_size * args.seq_len)
    prefetcher = None
    if args.data:
        # Batch `step` is a pure function of the step: a resume
        # continues at start_step with the batches an uninterrupted run
        # would see.  Step N+1's copy overlaps step N's compute.
        batches = host_batches(args, loader.TokenDataset(args.data))
        prefetcher = loader.prefetch_to_device(
            batches.batches(start_step=start_step),
            sharding=sharding.token_batch_sharding(mesh))
        batch_iter = prefetcher
    else:
        tokens = random_batch(args, cfg.vocab_size, start_step).to(device)
        batch_iter = itertools.repeat({'tokens': tokens})

    history, step_ms, reduce_ms = [], [], []
    reduce_bytes = 0
    cards = [d for d in mesh.distinct_devices() if d.type == 'cuda']
    for dev in cards:
        # The printed peak is this run's, not the process's so far.
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            batch = next(batch_iter)
            _sync(cards)
            t_step = time.perf_counter()
            with cb.step():
                state, metrics = train.train_step(state, batch, tcfg)
                loss = float(metrics['loss'])
                grad_norm = float(metrics['grad_norm'])
            _sync(cards)
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            if state.host_reduce is not None:
                seconds, reduce_bytes = state.host_reduce.take()
                reduce_ms.append(seconds * 1e3)
            history.append({'step': step, 'loss': loss,
                            'grad_norm': grad_norm})
            if step == start_step:
                peak = train.peak_memory_bytes(mesh)
                if peak is not None:
                    each = ', '.join(
                        f'{d} {torch.cuda.max_memory_allocated(d) / 1e9:.2f}'
                        for d in cards)
                    print(f'step peak memory: {peak / 1e9:.2f} GB ({each})',
                          flush=True)
                if state.shards is not None:
                    stored = ', '.join(
                        f'{d} {3 * b / 1e9:.2f}' for d, b in zip(
                            mesh.distinct_devices(),
                            state.shards.device_bytes()))
                    print(f'params + moments stored a device: {stored} GB',
                          flush=True)
            if step % 10 == 0 or step == args.steps - 1:
                print(f'step {step}: loss={loss:.4f} '
                      f'grad_norm={grad_norm:.3f}', flush=True)
            if mgr is not None:
                mgr.save(step, state)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if mgr is not None:
            mgr.close()  # wait-on-exit: drain the saves in flight
    cb.flush()
    print(f'done: {len(history)} steps in {time.perf_counter() - t0:.1f}s '
          f'on {device}', flush=True)
    print('step ms: ' + ' '.join(f'{ms:.1f}' for ms in step_ms), flush=True)
    if mesh.hosts > 1:
        t_digest = time.perf_counter()
        digest = train.state_digest(state)
        print(json.dumps({
            'host': mesh.host_rank, 'hosts': mesh.hosts,
            'backend': distributed.group_backend(),
            'losses': [h['loss'] for h in history],
            'grad_norms': [h['grad_norm'] for h in history],
            'step_ms': step_ms, 'reduce_ms': reduce_ms,
            'reduce_bytes': reduce_bytes,
            'peak_bytes': train.peak_memory_bytes(mesh),
            'launches': {**attention.LAUNCHES, **paged_attention.LAUNCHES},
            'digest': digest,
            'digest_s': time.perf_counter() - t_digest}), flush=True)
    return history, state


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Runs the steps; returns one {'step', 'loss', 'grad_norm'} per
    step run."""
    return run(argv)[0]


if __name__ == '__main__':
    try:
        main()
    finally:
        distributed.shutdown()
