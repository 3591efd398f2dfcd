"""Streaming and fused cross-entropy (mirrors
`skypilot_tpu/models/losses.py`): the training hot path never builds
the [batch, seq, vocab] f32 log-softmax.

- `streaming_cross_entropy(logits, ...)`: takes existing logits and runs
  the log-softmax as an online logsumexp over vocab chunks; the
  backward writes d_logits chunk by chunk.
- `fused_linear_cross_entropy(hidden, kernel, ...)`: takes the final
  hidden states [b, s, d] and the lm-head kernel [d, V] and computes
  each vocab chunk's logits inside the same online logsumexp, so the
  [b, s, V] tensor exists in neither pass; the backward recomputes each
  chunk's logits and accumulates dx / dW per chunk.  Vocab-parallel
  when the kernel comes as the tensor ranks' column blocks: each rank
  runs its own chunks on its own device and the ranks' (max, sum,
  target logit) combine into the global logsumexp, which each rank's
  backward reads.

Both are `torch.autograd.Function`s (the reference's custom VJPs), so
autograd never keeps per-chunk logits.  The matmul dtype follows the
kernel's (the forward pre-casts it per cfg.logits_in_f32); the
logsumexp is always f32.  Their matmuls are torch.matmul, as the
reference leaves them to XLA.

Masking contract of train.loss_fn: mean over all targets when mask is
None, else sum(nll * mask) / max(sum(mask), 1); 'sum' returns the raw
summed NLL for microbatch accumulation.
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.models import tensor_parallel

DEFAULT_VOCAB_CHUNK = 8192


def _denominator(targets, mask):
    if mask is None:
        return torch.tensor(float(targets.numel()), dtype=torch.float32,
                            device=targets.device)
    return torch.clamp(mask.to(torch.float32).sum(), min=1.0)


def _chunks(vocab: int, vocab_chunk: int):
    """(col0, width) of each chunk: equal chunks, then the ragged tail."""
    chunk = min(vocab_chunk, vocab)
    n_full = vocab // chunk
    out = [(i * chunk, chunk) for i in range(n_full)]
    if vocab % chunk:
        out.append((n_full * chunk, vocab - n_full * chunk))
    return out


def _online_update(carry, logits_c, targets, col0: int):
    """One online-logsumexp step over a [..., c] f32 logits chunk whose
    columns are vocab ids [col0, col0 + c).  Carry: running max m,
    running sum of exp s (relative to m), target logit t."""
    m, s, t = carry
    c = logits_c.shape[-1]
    m_new = torch.maximum(m, logits_c.amax(dim=-1))
    # exp(-inf - finite) == 0 handles the first chunk's m == -inf.
    s_new = (s * torch.exp(m - m_new) +
             torch.exp(logits_c - m_new[..., None]).sum(dim=-1))
    local = targets - col0
    hit = (local >= 0) & (local < c)
    gathered = torch.gather(logits_c, -1,
                            local.clamp(0, c - 1)[..., None])[..., 0]
    return m_new, s_new, t + torch.where(hit, gathered, 0.0)


def _lse_and_target(chunk_logits, targets, vocab: int, vocab_chunk: int):
    """(lse, target logit) from chunk_logits(col0, width) -> f32
    [..., width], one chunk live at a time."""
    return _combine([_online_stats(chunk_logits, targets, vocab,
                                   vocab_chunk)], targets.device)


def _dprobs(logits_c, lse, targets, col0: int, coeff):
    """(softmax - onehot) * coeff for one f32 chunk."""
    p = torch.exp(logits_c - lse[..., None])
    local = targets - col0
    hit = (local >= 0) & (local < logits_c.shape[-1])
    onehot = torch.zeros_like(p)
    onehot.scatter_(-1, local.clamp(0, logits_c.shape[-1] - 1)[..., None],
                    hit[..., None].to(p.dtype))
    return (p - onehot) * coeff


class _StreamingNLLSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets, mask, vocab_chunk: int):
        # pylint: disable=arguments-differ
        lse, tgt = _lse_and_target(
            lambda c0, w: logits[..., c0:c0 + w].to(torch.float32),
            targets, logits.shape[-1], vocab_chunk)
        ctx.save_for_backward(logits, targets, mask, lse, tgt)
        ctx.vocab_chunk = vocab_chunk
        return torch.sum((lse - tgt) * mask)

    @staticmethod
    def backward(ctx, g):
        # pylint: disable=arguments-differ
        logits, targets, mask, lse, tgt = ctx.saved_tensors
        coeff = (g * mask)[..., None]
        dlogits = torch.empty_like(logits)
        for col0, width in _chunks(logits.shape[-1], ctx.vocab_chunk):
            logits_c = logits[..., col0:col0 + width].to(torch.float32)
            dlogits[..., col0:col0 + width] = _dprobs(
                logits_c, lse, targets, col0, coeff).to(logits.dtype)
        dmask = g * (lse - tgt) if ctx.needs_input_grad[2] else None
        return dlogits, None, dmask, None


class _FusedNLLSum(torch.autograd.Function):
    """The summed NLL from hidden states and the lm-head kernel, given
    as the column blocks [d, V_t] of the tensor ranks that hold them
    (one block: the whole kernel): each rank runs the online logsumexp
    over its own vocab chunks on its own device (hidden[t] there), the
    ranks' (max, sum, target logit) combine into the global lse on
    targets' device, and each rank's backward recomputes its chunks
    against that lse.  No device builds more than one [b, s, chunk]
    block of logits."""

    @staticmethod
    def forward(ctx, targets, mask, vocab_chunk: int, *args):
        # pylint: disable=arguments-differ
        n = len(args) // 2
        hiddens, kernels = args[:n], args[n:]
        offsets, stats = [], []
        col0 = 0
        for hidden, kernel in zip(hiddens, kernels):
            x = hidden.to(kernel.dtype)
            offsets.append(col0)
            stats.append(_online_stats(
                lambda c0, w, x=x, kernel=kernel: (
                    x @ kernel[:, c0:c0 + w]).to(torch.float32),
                targets.to(kernel.device) - col0, kernel.shape[-1],
                vocab_chunk))
            col0 += kernel.shape[-1]
        lse, tgt = _combine(stats, targets.device)
        ctx.save_for_backward(targets, mask, lse, tgt, *args)
        ctx.vocab_chunk = vocab_chunk
        ctx.offsets = offsets
        return torch.sum((lse - tgt) * mask)

    @staticmethod
    def backward(ctx, g):
        # pylint: disable=arguments-differ
        targets, mask, lse, tgt, *args = ctx.saved_tensors
        n = len(args) // 2
        coeff = (g * mask)[..., None]
        grads = []
        dkernels = []
        for hidden, kernel, col0 in zip(args[:n], args[n:], ctx.offsets):
            dev = kernel.device
            x = hidden.to(kernel.dtype)
            x32 = hidden.to(torch.float32).reshape(-1, hidden.shape[-1])
            lse_t, coeff_t = lse.to(dev), coeff.to(dev)
            local = targets.to(dev) - col0
            dx = torch.zeros(hidden.shape, dtype=torch.float32, device=dev)
            dkernel = torch.empty_like(kernel)
            for c0, width in _chunks(kernel.shape[-1], ctx.vocab_chunk):
                kernel_c = kernel[:, c0:c0 + width]
                scaled = _dprobs((x @ kernel_c).to(torch.float32), lse_t,
                                 local, c0, coeff_t)
                dx += scaled @ kernel_c.to(torch.float32).t()
                dkernel[:, c0:c0 + width] = (
                    x32.t() @ scaled.reshape(-1, width)).to(kernel.dtype)
            grads.append(dx.to(hidden.dtype))
            dkernels.append(dkernel)
        dmask = g * (lse - tgt) if ctx.needs_input_grad[1] else None
        return (None, dmask, None, *grads, *dkernels)


def _online_stats(chunk_logits, targets, vocab: int, vocab_chunk: int):
    """(running max, sum of exp relative to it, target logit) over one
    rank's columns, targets relative to its first column (a target
    outside them adds 0 to the target logit)."""
    carry = (torch.full(targets.shape, float('-inf'), device=targets.device),
             torch.zeros(targets.shape, device=targets.device),
             torch.zeros(targets.shape, device=targets.device))
    for col0, width in _chunks(vocab, vocab_chunk):
        carry = _online_update(carry, chunk_logits(col0, width), targets,
                               col0)
    return carry


def _combine(stats, device):
    """The ranks' (max, sum, target logit) -> (lse, target logit) on
    `device`: the max over ranks, each sum rescaled to it and added in
    rank order; one rank is its own lse."""
    if len(stats) == 1:
        m, s, t = stats[0]
        return m + torch.log(s), t
    stats = [[v.to(device) for v in st] for st in stats]
    m = stats[0][0]
    for st in stats[1:]:
        m = torch.maximum(m, st[0])
    s = torch.zeros_like(m)
    t = torch.zeros_like(m)
    for m_r, s_r, t_r in stats:
        s = s + s_r * torch.exp(m_r - m)
        t = t + t_r
    return m + torch.log(s), t


def _check_reduction(reduction: str) -> None:
    if reduction not in ('mean', 'sum'):
        raise ValueError(f"Unknown reduction {reduction!r}; "
                         "have 'mean', 'sum'.")


def _reduce(nll, targets, mask, reduction: str):
    return nll if reduction == 'sum' else nll / _denominator(targets, mask)


def _mask_or_ones(targets, mask):
    if mask is None:
        return torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    return mask.to(torch.float32)


def streaming_cross_entropy(logits, targets, mask=None, *,
                            vocab_chunk: int = DEFAULT_VOCAB_CHUNK,
                            reduction: str = 'mean'):
    """Exact chunked-vocab CE on existing logits [b, s, V]; drop-in for
    train.loss_fn (same masked and unmasked semantics)."""
    _check_reduction(reduction)
    nll = _StreamingNLLSum.apply(logits, targets.long(),
                                 _mask_or_ones(targets, mask), vocab_chunk)
    return _reduce(nll, targets, mask, reduction)


def fused_linear_cross_entropy(hidden, kernel, targets,
                               mask: Optional[torch.Tensor] = None, *,
                               vocab_chunk: int = DEFAULT_VOCAB_CHUNK,
                               reduction: str = 'mean'):
    """Exact CE from final hidden states [b, s, d] and the lm-head kernel
    [d, V]; per-chunk logits are computed on the fly (and recomputed in
    the backward), so the [b, s, V] tensor never exists.  For tied
    embeddings pass the transposed embedding (a view, not a copy).

    Vocab-parallel: `kernel` may be a list of the tensor ranks' column
    blocks [d, V / tp], in rank order, each on its rank's device; the
    hidden states are read there (one copy a card) and the ranks'
    partial logsumexps combine into the global one (`_FusedNLLSum`).
    The loss lands on targets' device."""
    kernels = list(kernel) if isinstance(kernel, (list, tuple)) else [kernel]
    if hidden.shape[-1] != kernels[0].shape[0]:
        raise ValueError(
            f'hidden d_model {hidden.shape[-1]} != kernel rows '
            f'{kernels[0].shape[0]} — pass the kernel as [d_model, vocab].')
    _check_reduction(reduction)
    hiddens = tensor_parallel.on_cards(hidden, [k.device for k in kernels])
    nll = _FusedNLLSum.apply(targets.long(), _mask_or_ones(targets, mask),
                             vocab_chunk, *hiddens, *kernels)
    return _reduce(nll, targets, mask, reduction)
