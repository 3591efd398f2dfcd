"""Training step for the model family on one GPU (mirrors
`skypilot_tpu/models/train.py`).

The reference jit-compiles a sharded step over an optax chain; the port
runs eagerly on one device: `create_train_state` builds a trainable
`Transformer` (f32 master parameters, cfg.dtype compute) and an AdamW
optimizer, and `train_step` takes one optimizer step.  Unlike the
reference's pure step, `train_step` UPDATES THE STATE IN PLACE (the
parameters, the optimizer's moments, the step count) and returns the
same object, so the f32 state never exists twice on the card.

Attention's gradient runs the flash backward kernels (ops/attention.py)
on CUDA tensors; the loss is `loss_fn` or, with `fused_ce`, the fused
linear + CE of models/losses.py; each layer is rematerialised per
cfg.remat / cfg.remat_policy (models/transformer.py).

Meshes, `jit_train_step`, `abstract_train_state` and
`load_pretrained_params` (sharding, checkpoints) come with a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import losses
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.models.transformer import init_params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # Fused linear + CE (models/losses.py): the forward returns the
    # final hidden states and the lm-head kernel and the loss computes
    # vocab chunks on the fly, so the [b, s, V] logits never exist.
    fused_ce: bool = False
    # Vocab chunk width for the fused CE.
    vocab_chunk: int = 8192
    # Microbatch gradient accumulation: the batch is split into
    # accum_steps microbatches whose SUMMED NLL gradients accumulate and
    # are normalised by the full batch's denominator, so accum_steps=k
    # matches one big batch while activations stay at one microbatch.
    accum_steps: int = 1


@dataclasses.dataclass
class TrainState:
    """step, the trainable model and its optimizer (updated in place by
    `train_step`), and the global-norm clip that precedes the optimizer,
    fixed when the state is made as the reference's chain fixes it."""
    step: int
    model: Transformer
    optimizer: torch.optim.Optimizer
    grad_clip: float


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g_norm is the square root of
    the sum of squares over every element (optax's global_norm), and
    every gradient is scaled by max_norm / g_norm when g_norm >=
    max_norm (no epsilon, unlike torch's clip_grad_norm_).  Returns the
    pre-clip g_norm, a 0-dim f32 tensor on the device (no host sync)."""
    g_norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.to(torch.float32)) for g in grads]))
    scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return g_norm


def make_optimizer(params, tcfg: TrainConfig) -> torch.optim.AdamW:
    """The update half of the reference chain
    `optax.chain(clip_by_global_norm(grad_clip), adamw(...))`, whose
    clip `train_step` applies first (`clip_by_global_norm_`).  torch's
    AdamW with eps 1e-8 has optax.adamw's numerics: bias-corrected
    moments, m_hat / (sqrt(v_hat) + eps), and decoupled weight decay
    lr * wd * p on every leaf (optax's default mask)."""
    return torch.optim.AdamW(params, lr=tcfg.learning_rate,
                             betas=(tcfg.b1, tcfg.b2), eps=1e-8,
                             weight_decay=tcfg.weight_decay)


def loss_fn(logits, targets, mask=None, reduction: str = 'mean'):
    """Next-token cross entropy; logits [b, s, V], targets [b, s].  The
    full f32 log-softmax (the fused path in models/losses.py is pinned
    against it); 'sum' returns the raw summed NLL."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is not None:
        ll = ll * mask
    if reduction == 'sum':
        return -ll.sum()
    if mask is None:
        return -ll.mean()
    return -ll.sum() / torch.clamp(mask.sum(), min=1)


def create_train_state(cfg: ModelConfig,
                       tcfg: Optional[TrainConfig] = None, *,
                       device: Union[str, torch.device] = 'cuda',
                       seed: int = 0,
                       mesh=None) -> Tuple[TrainState, None]:
    """-> (state, None): seeded trainable parameters on `device` (the
    None stands where the reference returns its shardings)."""
    if mesh is not None:
        raise NotImplementedError(
            'create_train_state(mesh=...): sharded training over several '
            'GPUs comes with a later slice of the port')
    tcfg = tcfg or TrainConfig()
    model = init_params(cfg, seed=seed, device=resolve_device(device),
                        trainable=True)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.parameters(), tcfg),
                      grad_clip=tcfg.grad_clip), None


def _microbatch_nll(model, inputs, targets, mask, tcfg: TrainConfig):
    """Summed (unnormalised) NLL of one microbatch."""
    if tcfg.fused_ce:
        hidden, kernel = model(inputs, return_hidden=True)
        return losses.fused_linear_cross_entropy(
            hidden, kernel, targets, mask, vocab_chunk=tcfg.vocab_chunk,
            reduction='sum')
    return loss_fn(model(inputs), targets, mask, reduction='sum')


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               tcfg: Optional[TrainConfig] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step, in place.  batch = {'tokens': [b, s + 1]} or
    {'inputs', 'targets'} (+ optional 'mask').  With a TrainConfig,
    fused_ce routes the loss through models/losses.py and accum_steps > 1
    accumulates summed-NLL gradients over microbatches, normalised by
    the full batch's denominator.  Metrics: 'loss' and 'grad_norm'
    (before clipping), 0-dim tensors on the device."""
    if 'tokens' in batch:
        inputs = batch['tokens'][:, :-1]
        targets = batch['tokens'][:, 1:]
    else:
        inputs, targets = batch['inputs'], batch['targets']
    mask = batch.get('mask')
    model = state.model
    state.optimizer.zero_grad(set_to_none=True)

    if tcfg is None or (not tcfg.fused_ce and tcfg.accum_steps <= 1):
        loss = loss_fn(model(inputs), targets, mask)
        loss.backward()
    else:
        if mask is None:
            denom = torch.tensor(float(targets.numel()), device=inputs.device)
        else:
            denom = torch.clamp(mask.sum(), min=1).to(torch.float32)
        accum = max(tcfg.accum_steps, 1)
        b = inputs.shape[0]
        if b % accum:
            raise ValueError(f'batch size {b} not divisible by accum_steps '
                             f'{accum}')
        mb = b // accum
        nll = torch.zeros((), device=inputs.device)
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            part = _microbatch_nll(model, inputs[rows], targets[rows],
                                   None if mask is None else mask[rows],
                                   tcfg)
            part.backward()
            nll = nll + part.detach()
        loss = nll / denom
        with torch.no_grad():
            for p in model.parameters():
                p.grad.div_(denom.to(p.grad.dtype))

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    grad_norm = clip_by_global_norm_(grads, state.grad_clip)
    state.optimizer.step()
    state.step += 1
    return state, {'loss': loss.detach(), 'grad_norm': grad_norm}


def peak_memory_bytes(device: Union[str, torch.device] = 'cuda'
                      ) -> Optional[int]:
    """Peak bytes allocated on a CUDA device since the last
    torch.cuda.reset_peak_memory_stats (the port's counterpart of the
    reference's compiled_peak_memory); None for the CPU, which keeps no
    such count."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return None
    return int(torch.cuda.max_memory_allocated(dev))
