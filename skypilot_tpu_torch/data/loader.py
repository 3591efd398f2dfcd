"""Token data loading: memmap datasets and host-sharded resumable
batching (a copy of `skypilot_tpu/data/loader.py`, numpy only; the
files and batches are byte for byte the reference's).

- `write_token_file` / `TokenDataset`: a flat binary file of token ids
  (the 8-byte `SKYTOK1` magic, one itemsize byte, little-endian ids:
  uint16 when every id is below 2**16, else uint32), read through
  np.memmap: no copies, instant open, larger than RAM.
- `HostShardedBatches`: stateless batch addressing.  Batch `step` is a
  pure function of (seed, step, host_rank), so every host draws
  disjoint rows of one global batch with no coordination, and resuming
  from a checkpoint is "continue at step N": the loader is the data
  half of the checkpoint contract (data/checkpoints.py holds the model
  half).
- `DevicePrefetcher` / `prefetch_to_device` (re-exported from
  data/prefetch.py): stage upcoming batches on the device while the
  current step computes.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from skypilot_tpu_torch.data.prefetch import DevicePrefetcher
from skypilot_tpu_torch.data.prefetch import prefetch_to_device

__all__ = ['TokenDataset', 'HostShardedBatches', 'DevicePrefetcher',
           'prefetch_to_device', 'write_token_file', 'TokenFileError']

_MAGIC = b'SKYTOK1\n'
_DTYPES = {2: np.uint16, 4: np.uint32}


class TokenFileError(Exception):
    """A file that is not a SKYTOK1 token file (the reference raises
    its SkyTpuError here)."""


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a flat token file (8-byte magic + 1-byte itemsize +
    little-endian ids)."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f'tokens must be 1-D, got shape {tokens.shape}')
    itemsize = 2 if tokens.max(initial=0) < 2**16 else 4
    dtype = _DTYPES[itemsize]
    with open(path, 'wb') as f:
        f.write(_MAGIC)
        f.write(bytes([itemsize]))
        f.write(tokens.astype(dtype).tobytes())


class TokenDataset:
    """Flat token-id file, memory-mapped."""

    def __init__(self, path: str):
        with open(path, 'rb') as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise TokenFileError(f'{path} is not a SKYTOK1 token file.')
            itemsize = f.read(1)[0]
        if itemsize not in _DTYPES:
            raise TokenFileError(
                f'{path}: unsupported token itemsize {itemsize}.')
        self.path = path
        self._offset = len(_MAGIC) + 1
        self.tokens = np.memmap(path, dtype=_DTYPES[itemsize], mode='r',
                                offset=self._offset)

    def __len__(self) -> int:
        return len(self.tokens)

    def window(self, start: int, length: int) -> np.ndarray:
        return np.asarray(self.tokens[start:start + length])


class HostShardedBatches:
    """Stateless per-host batch stream over a TokenDataset.

    Yields {'tokens': [local_batch, seq_len + 1] int32}: the +1 column
    feeds the next-token shift in models/train.py.  Window starts are
    drawn per (seed, step) with a counter-based RNG, so any step's
    batch is rebuilt without replaying the stream.
    """

    def __init__(self, dataset: TokenDataset, *, global_batch: int,
                 seq_len: int, host_rank: int = 0, num_hosts: int = 1,
                 seed: int = 0):
        if global_batch % num_hosts:
            raise ValueError(f'global_batch {global_batch} not divisible '
                             f'by num_hosts {num_hosts}')
        if len(dataset) < seq_len + 1:
            raise ValueError(
                f'dataset has {len(dataset)} tokens; need at least '
                f'seq_len+1 = {seq_len + 1}')
        self.dataset = dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seq_len = seq_len
        self.host_rank = host_rank
        self.num_hosts = num_hosts
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for `step` (a pure function: resumable)."""
        rng = np.random.default_rng((self.seed, step))
        # Draw the global batch's starts, then slice this host's rows:
        # every host sees the same draw and takes a disjoint stripe.
        # Exclusive high: the last valid window start is
        # len - (seq_len + 1), so high = len - seq_len.
        starts = rng.integers(
            0, len(self.dataset) - self.seq_len,
            size=self.global_batch)
        lo = self.host_rank * self.local_batch
        rows = [self.dataset.window(s, self.seq_len + 1)
                for s in starts[lo:lo + self.local_batch]]
        return {'tokens': np.stack(rows).astype(np.int32)}

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
