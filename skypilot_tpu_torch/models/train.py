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

Checkpoints: `snapshot` turns a TrainState into host copies of its
leaves (the params, the AdamW moments by tree path, the optimizer's
count, the step) for data/checkpoints.py to write, `load_train_step`
puts a saved step back in place, and `load_pretrained_params` starts a
finetune from a params-only checkpoint (an import) with fresh moments.

Meshes, `jit_train_step` and `abstract_train_state` come with a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import losses
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.utils import safetensors_io


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
    reference's compiled_peak_memory, measured rather than compiled),
    fed to the training telemetry (callbacks.record_peak_memory:
    skytpu_train_peak_memory_bytes and summary.json); None for the CPU,
    which keeps no such count."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return None
    peak = int(torch.cuda.max_memory_allocated(dev))
    callbacks.record_peak_memory(peak)
    return peak


# ------------------------------------------------------------- checkpoints


def param_paths(model: Transformer) -> List[Tuple[Tuple[str, ...],
                                                   torch.nn.Parameter]]:
    """(tree path, parameter) for every parameter of a trainable model,
    in `convert.param_tree`'s order (the unstacked `layer_{i}` layout);
    raises unless they are exactly model.parameters()."""
    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from walk(value, prefix + (key,))
            else:
                yield prefix + (key,), value
    pairs = list(walk(convert.param_tree(model), ()))
    if ({id(p) for _, p in pairs} != {id(p) for p in model.parameters()} or
            len(pairs) != len(list(model.parameters()))):
        raise ValueError('param_tree does not cover the model\'s '
                         'parameters one to one')
    return pairs


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to('cpu', copy=True)


@torch.no_grad()
def snapshot(state: TrainState) -> checkpoints.TrainSnapshot:
    """Host copies of the state's leaves, all taken before this returns
    (`train_step` updates the state in place, so a snapshot that
    aliased it would change under a writer thread).  A parameter the
    optimizer has not stepped yet has zero moments, as AdamW's lazy
    state starts."""
    params, mu, nu, counts = [], [], [], set()
    for path, p in param_paths(state.model):
        params.append((path, _host_copy(p)))
        st = state.optimizer.state.get(p)
        if st:
            mu.append((path, _host_copy(st['exp_avg'])))
            nu.append((path, _host_copy(st['exp_avg_sq'])))
            counts.add(int(st['step']))
        else:
            mu.append((path, torch.zeros(p.shape, dtype=p.dtype)))
            nu.append((path, torch.zeros(p.shape, dtype=p.dtype)))
            counts.add(0)
    if len(counts) != 1:
        raise ValueError(f'optimizer step counts differ across '
                         f'parameters: {sorted(counts)}')
    return checkpoints.TrainSnapshot(params=params, mu=mu, nu=nu,
                                     count=counts.pop(),
                                     train_step=state.step)


@torch.no_grad()
def load_train_step(state: TrainState, params, moments, *, count: int,
                    train_step: int) -> TrainState:
    """Put a saved training step back into `state` in place: every
    parameter, AdamW's exp_avg / exp_avg_sq and its step count (exactly:
    the bias correction of the next step reads it), and state.step.
    `params` / `moments` are the step's open safetensors readers; every
    name, dtype and shape is checked before anything is written."""
    pairs = param_paths(state.model)
    want = {}
    for path, p in pairs:
        name = '/'.join(path)
        spec = (safetensors_io.dtype_name(p.dtype),
                tuple(p.shape))
        want[(params, name)] = spec
        want[(moments, f'mu/{name}')] = spec
        want[(moments, f'nu/{name}')] = spec
    have = {(reader, name): (reader.dtype(name), reader.shape(name))
            for reader in (params, moments) for name in reader.keys()}
    if have != want:
        diff = sorted(f'{r.path}:{n} {have.get((r, n))} vs model '
                      f'{want.get((r, n))}' for r, n in set(have) | set(want)
                      if have.get((r, n)) != want.get((r, n)))
        raise ValueError(f'training step does not match this model '
                         f'(wrong model_config?): {diff[:4]}')
    for path, p in pairs:
        name = '/'.join(path)
        p.copy_(params.get_tensor(name))
        state.optimizer.state[p] = {
            # make_optimizer's AdamW (neither capturable nor fused) keeps
            # its step count as a 0-dim tensor of the default dtype on
            # the host.
            'step': torch.tensor(float(count)),
            'exp_avg': moments.get_tensor(f'mu/{name}').to(p.device),
            'exp_avg_sq': moments.get_tensor(f'nu/{name}').to(p.device),
        }
    state.step = train_step
    return state


@torch.no_grad()
def load_pretrained_params(state: TrainState, directory: str) -> TrainState:
    """Start a finetune from a converted checkpoint (import_weights) or
    any params-bearing step of this port's format: each leaf of the
    newest step streams through `restore_params`' leaf_fn straight into
    the existing f32 master parameter (cast to its dtype), so no second
    tree exists on the device.  The optimizer's moments stay fresh:
    this is init, not resume.  Either layer layout is read (stacked
    `layers/layer/...` or `layer_{i}`); the leaf count and every shape
    are checked before anything is copied, and int8 weights are
    refused."""
    step = checkpoints.latest_step(directory)
    if step is None:
        raise FileNotFoundError(f'No checkpoint under {directory}')
    specs = checkpoints.step_specs(directory, step)
    int8 = sorted(n for n in specs if n.split('/')[-1] == 'qvalue')
    if int8:
        raise ValueError(
            f'{directory} step {step} holds int8 weights ({int8[0]}, ...): '
            'a finetune starts from float weights; convert the HF source '
            'without quantization')
    targets = dict(param_paths(state.model))
    n_layers = state.model.cfg.n_layers
    stacked = any(n.startswith('layers/layer/') for n in specs)
    expected: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    for path, p in targets.items():
        if stacked and path[0].startswith('layer_'):
            if path[0] == 'layer_0':
                expected[('layers', 'layer') + path[1:]] = (
                    (n_layers,) + tuple(p.shape))
        else:
            expected[path] = tuple(p.shape)
    if len(specs) != len(expected):
        raise ValueError(
            f'Checkpoint has {len(specs)} arrays; model expects '
            f'{len(expected)} — wrong model_config for this state?')
    for name, (_, shape) in specs.items():
        want = expected.get(tuple(name.split('/')))
        if want is None:
            raise ValueError(f'Checkpoint array {name} is not in this model '
                             '— wrong model_config for this state?')
        if tuple(shape) != want:
            raise ValueError(f'Shape mismatch: checkpoint {tuple(shape)} '
                             f'vs model {want} ({name})')

    def copy_in(path: Tuple[str, ...], leaf: torch.Tensor) -> Any:
        if stacked and path[:2] == ('layers', 'layer'):
            for i in range(n_layers):
                targets[(f'layer_{i}',) + path[2:]].copy_(leaf[i])
        else:
            targets[path].copy_(leaf)
        return None

    checkpoints.restore_params(directory, device=state.model.device,
                               leaf_fn=copy_in, step=step)
    return state
