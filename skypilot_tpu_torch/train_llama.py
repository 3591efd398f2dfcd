"""Train a Llama-style model on one GPU with the port's training step
(the single-GPU subset of `examples/train_llama.py`).

    python -m skypilot_tpu_torch.train_llama --model small --steps 20
    python -m skypilot_tpu_torch.train_llama --model tiny --device cpu

Seeded random weights and one batch of random tokens, repeated every
step as the example does, so the loss falls as the model memorises it.
Prints `step N: loss=... grad_norm=...` every 10 steps and at the last.
Meshes (--fsdp/--tensor/--sequence > 1), token files (--data),
converted checkpoints (--init-from), the collective preflight and the
checkpoint contract come with a later slice of the port and raise here.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import train


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', default='tiny',
                        help=f'preset: {", ".join(sorted(configs.PRESETS))}')
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
    # The example's multi-device and data flags: refused, not ignored.
    parser.add_argument('--fsdp', type=int, default=1)
    parser.add_argument('--tensor', type=int, default=1)
    parser.add_argument('--sequence', type=int, default=1)
    parser.add_argument('--data', default=None)
    parser.add_argument('--init-from', default=None)
    parser.add_argument('--preflight', action='store_true')
    return parser


def _refuse_later_slice(args) -> None:
    later = [f'--{name} {getattr(args, name)}'
             for name in ('fsdp', 'tensor', 'sequence')
             if getattr(args, name) > 1]
    if args.data:
        later.append('--data')
    if args.init_from:
        later.append('--init-from')
    if args.preflight:
        later.append('--preflight')
    if os.environ.get('SKYTPU_CHECKPOINT_DIR'):
        later.append('a checkpoint directory (SKYTPU_CHECKPOINT_DIR)')
    if later:
        raise NotImplementedError(
            f'{", ".join(later)}: meshes, token files, converted '
            'checkpoints, the preflight and checkpointing come with a '
            'later slice of the port (one GPU, random tokens here)')


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Runs the steps; returns one {'step', 'loss', 'grad_norm'} per
    step."""
    args = _parser().parse_args(argv)
    _refuse_later_slice(args)
    device = resolve_device(args.device)
    cfg = configs.get_config(args.model)
    tcfg = train.TrainConfig(fused_ce=args.fused_ce,
                             accum_steps=args.accum_steps,
                             vocab_chunk=args.vocab_chunk)
    state, _ = train.create_train_state(cfg, tcfg, device=device, seed=0)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size,
                           (args.batch_size, args.seq_len + 1),
                           generator=gen, dtype=torch.int64).to(device)
    batch = {'tokens': tokens}
    history = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        state, metrics = train.train_step(state, batch, tcfg)
        loss = float(metrics['loss'])
        grad_norm = float(metrics['grad_norm'])
        history.append({'step': step, 'loss': loss, 'grad_norm': grad_norm})
        if step % 10 == 0 or step == args.steps - 1:
            print(f'step {step}: loss={loss:.4f} grad_norm={grad_norm:.3f}',
                  flush=True)
    print(f'done: {args.steps} steps in {time.perf_counter() - t0:.1f}s on '
          f'{device}', flush=True)
    return history


if __name__ == '__main__':
    main()
