"""Train or finetune a Llama-style model on one GPU with the port's
training step (`examples/train_llama.py` without meshes).

    python -m skypilot_tpu_torch.train_llama --model small --steps 20
    python -m skypilot_tpu_torch.train_llama --model tiny --device cpu
    SKYTPU_CHECKPOINT_DIR=<ckpt> python -m skypilot_tpu_torch.train_llama \
        --model auto --init-from <converted dir> --data <tokens.bin>

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
  `HostShardedBatches.batch_at(step)`, so a resumed run sees the batches
  an uninterrupted one would, copied to the device ahead of the step
  (data/prefetch.py).  Without it: one batch of random tokens seeded by
  the start step, repeated every step as the example does.
- Step telemetry through `callbacks` (summary.json in
  SKYTPU_BENCHMARK_LOG_DIR); the peak device memory after the first
  step is printed.

Prints `step N: loss=... grad_norm=...` every 10 steps and at the last.
Meshes (--fsdp/--tensor/--sequence > 1) and the collective preflight
come with a later slice of the port and raise here.
"""
from __future__ import annotations

import argparse
import itertools
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
    parser.add_argument('--device', default='cuda')
    # The example's multi-device flags: refused, not ignored.
    parser.add_argument('--fsdp', type=int, default=1)
    parser.add_argument('--tensor', type=int, default=1)
    parser.add_argument('--sequence', type=int, default=1)
    parser.add_argument('--preflight', action='store_true')
    return parser


def _refuse_later_slice(args) -> None:
    later = [f'--{name} {getattr(args, name)}'
             for name in ('fsdp', 'tensor', 'sequence')
             if getattr(args, name) > 1]
    if args.preflight:
        later.append('--preflight')
    if later:
        raise NotImplementedError(
            f'{", ".join(later)}: meshes and the collective preflight '
            'come with a later slice of the port (one GPU here)')


def _model_config(args) -> configs.ModelConfig:
    if args.model != 'auto':
        return configs.get_config(args.model)
    if not args.init_from:
        raise SystemExit('--model auto needs --init-from')
    cfg = import_weights.load_model_config(args.init_from)
    if cfg is None:
        raise SystemExit(f'No model_config.json under {args.init_from}')
    return cfg


def run(argv: Optional[List[str]] = None
        ) -> Tuple[List[dict], train.TrainState]:
    """Runs the steps; -> (one {'step', 'loss', 'grad_norm'} per step
    run, the final TrainState)."""
    args = _parser().parse_args(argv)
    _refuse_later_slice(args)
    device = resolve_device(args.device)
    cfg = _model_config(args)
    tcfg = train.TrainConfig(fused_ce=args.fused_ce,
                             accum_steps=args.accum_steps,
                             vocab_chunk=args.vocab_chunk)
    state, _ = train.create_train_state(cfg, tcfg, device=device, seed=0)

    start_step = 0
    mgr = None
    if checkpoints.checkpoint_dir():
        # Saves run on a background writer (bounded in flight, retried
        # with backoff), off the step's critical path.
        mgr = checkpoints.AsyncCheckpointManager(
            save_interval_steps=SAVE_INTERVAL_STEPS)
        state, start_step = mgr.restore_or_init(state)
        print(f'resuming from step {start_step}', flush=True)
        if import_weights.load_model_config(mgr.directory) is None:
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
        batches = loader.HostShardedBatches(
            loader.TokenDataset(args.data), global_batch=args.batch_size,
            seq_len=args.seq_len)
        prefetcher = loader.prefetch_to_device(
            batches.batches(start_step=start_step), device=device)
        batch_iter = prefetcher
    else:
        gen = torch.Generator().manual_seed(start_step)
        tokens = torch.randint(0, cfg.vocab_size,
                               (args.batch_size, args.seq_len + 1),
                               generator=gen, dtype=torch.int64).to(device)
        batch_iter = itertools.repeat({'tokens': tokens})

    history = []
    if device.type == 'cuda':
        # The printed peak is this run's, not the process's so far.
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            batch = next(batch_iter)
            with cb.step():
                state, metrics = train.train_step(state, batch, tcfg)
                loss = float(metrics['loss'])
                grad_norm = float(metrics['grad_norm'])
            history.append({'step': step, 'loss': loss,
                            'grad_norm': grad_norm})
            if step == start_step:
                peak = train.peak_memory_bytes(device)
                if peak is not None:
                    print(f'step peak memory: {peak / 1e9:.2f} GB',
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
    return history, state


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Runs the steps; returns one {'step', 'loss', 'grad_norm'} per
    step run."""
    return run(argv)[0]


if __name__ == '__main__':
    main()
