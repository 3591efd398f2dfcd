"""Per-request sampling plumbing for the batching engine (mirrors
`skypilot_tpu/serve/sampler.py`): submit-side validation of sampling
parameters, the per-slot admission write, and the n-gram drafter for
self-speculative decoding.  Token selection itself runs on the device
inside the tick (`models/decode.batched_sample`)."""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from skypilot_tpu_torch.models import decode


class NgramDrafter:
    """Prompt-lookup draft proposer: the next k tokens are the
    continuation of the most recent EARLIER occurrence of the current
    tail n-gram in the request's history (longest n first).  Misses pad
    with the last token (pads must be valid vocab ids)."""

    def __init__(self, prompt_ids: Iterable[int], *,
                 max_ngram: int = 3) -> None:
        self.history: List[int] = [int(t) for t in prompt_ids]
        self.max_ngram = int(max_ngram)

    def observe(self, tokens: Iterable[int]) -> None:
        self.history.extend(int(t) for t in tokens)

    def propose(self, k: int) -> List[int]:
        hist = self.history
        out: List[int] = []
        for n in range(min(self.max_ngram, len(hist) - 1), 0, -1):
            tail = hist[-n:]
            for i in range(len(hist) - n - 1, -1, -1):
                if hist[i:i + n] == tail:
                    out = hist[i + n:i + n + k]
                    break
            if out:
                break
        pad = hist[-1] if hist else 0
        out = out[:k]
        out.extend([pad] * (k - len(out)))
        return out


def validate_sampling(sampling: Optional[Any], *, max_top_k: int,
                      pipelined: bool = True) -> Tuple[float, int, int]:
    """-> (temperature, top_k, seed); raises ValueError on parameters
    the engine cannot honor."""
    temperature, top_k, seed = 0.0, 0, 0
    if sampling is not None:
        temperature = float(sampling.temperature)
        top_k = int(sampling.top_k)
        seed = int(getattr(sampling, 'seed', 0))
    if top_k < 0:
        raise ValueError(f'top_k must be >= 0, got {top_k}')
    if top_k > max_top_k:
        raise ValueError(f'top_k {top_k} > engine max_top_k {max_top_k}')
    if temperature > 0.0 and not pipelined:
        raise ValueError('the legacy (pipelined=False) loop serves greedy '
                         'decoding only')
    return temperature, top_k, seed


def validate_stop_ids(stop_ids: Iterable[int], max_stop_ids: int) -> None:
    n = len(tuple(stop_ids))
    if n > max_stop_ids:
        raise ValueError(f'{n} stop ids > engine max_stop_ids '
                         f'{max_stop_ids}')


class SlotSampler:
    """Per-slot admission helpers bound to one engine configuration."""

    def __init__(self, max_top_k: int, max_stop_ids: int) -> None:
        self.max_top_k = int(max_top_k)
        self.max_stop_ids = int(max_stop_ids)

    @staticmethod
    def key(seed: int) -> List[int]:
        """A fresh key stream: (seed, counter 0)."""
        return [int(seed), 0]

    def sample_one(self, logits, key, temperature: float,
                   top_k: int) -> int:
        """One token from single-row logits ([1, V] or [V]) and a draw
        key (seed, counter), with the math a tick uses (the MoE first
        token from prefill)."""
        dev = logits.device
        token = decode.batched_sample(
            logits.reshape(1, -1),
            torch.as_tensor(key, dtype=torch.int64, device=dev).reshape(1, 2),
            torch.tensor([temperature], dtype=torch.float32, device=dev),
            torch.tensor([top_k], dtype=torch.int32, device=dev),
            max_top_k=self.max_top_k)
        return int(token[0])

    def stop_row(self, stop_ids: Iterable[int]) -> List[int]:
        row = [-1] * self.max_stop_ids
        for i, sid in enumerate(sorted(stop_ids)):
            row[i] = sid
        return row

    def admit(self, state: Dict[str, Any], slot_id: int, token: int,
              remaining: int, stop_ids: Iterable[int], key,
              temperature: float, top_k: int) -> Dict[str, Any]:
        """Flip a slot live in a new state dict."""
        return decode.admit_slot_state(state, slot_id, token, remaining,
                                       self.stop_row(stop_ids), key,
                                       temperature, top_k)
