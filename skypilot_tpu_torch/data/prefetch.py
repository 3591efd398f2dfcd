"""Double-buffered host -> device batch prefetch for the training loop
(the counterpart of `skypilot_tpu/data/prefetch.py`).

Step N+1's host -> device copy overlaps step N's compute: a background
thread takes each batch from the source iterator (a dict of numpy
arrays or tensors, as `HostShardedBatches` yields) and, on CUDA,
copies it from pinned host memory with `non_blocking=True` on a side
stream of its own and records an event there.  `__next__` makes the
caller's current stream wait on that event (the copy, not the host, is
waited for) and marks every tensor with `record_stream`, so the caching
allocator does not hand the memory back to the side stream while the
step still reads it.  On the CPU the batch is handed over as tensors as it is (numpy
arrays become tensors without a copy).  Token batches stay int32 on
the wire: the embedding takes int32 ids and the loss casts its
targets.

Guarantees (tests/test_torch_data.py, after tests/unit/test_prefetch.py):
- ordering: batches come out in exactly the order the source produced
  them;
- backpressure: at most `depth` batches are staged on the device ahead
  of the consumer; the producer parks, holding at most one more batch
  in host memory, until a `next()` frees a slot;
- error transparency: a producer exception surfaces on the consumer's
  next(), and keeps re-raising (no deadlock on a drained queue);
- exhaustion is repeatable (StopIteration on every later next()).

With `sharding=` (parallel/sharding.py `token_batch_sharding(mesh)`),
each array's rows are split over the batch ranks as the reference's
placement splits them (batch only: 'data' x 'fsdp') and each rank's
rows are copied to its device, one side stream per distinct device;
the batch comes out as {name: [one tensor per batch rank]}, which
`train.train_step` takes on that mesh.

The time the consumer blocks on an empty queue goes to
`callbacks.record_data_wait` (the summary's `prefetch_wait_seconds`
and `skytpu_train_data_wait_seconds_total`).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

from skypilot_tpu_torch.callbacks import base as callbacks
from skypilot_tpu_torch.device import device_scope
from skypilot_tpu_torch.device import resolve_device


class DevicePrefetcher:
    """Stage upcoming batches on `device` while the current one
    computes.  `close()` (or leaving a `with` block) stops the producer
    thread of a source that does not end."""

    def __init__(self, iterator: Iterator[Any],
                 device: Union[str, torch.device] = 'cuda',
                 depth: int = 2, sharding: Optional[Any] = None):
        if depth < 1:
            raise ValueError(f'depth must be >= 1, got {depth}')
        self._sharding = sharding
        if sharding is None:
            self._targets = [resolve_device(device)]
        else:
            # The batch ranks' devices, in block order.
            self._targets = [
                resolve_device(sharding.mesh.devices[pos])
                for pos in sharding.owners(2).values()]
        self.device = self._targets[0]
        self._iterator = iterator
        self._queue: 'queue.Queue[Any]' = queue.Queue()
        self._slots = threading.Semaphore(depth)
        self._stop = threading.Event()
        self._done = object()
        self._error = None
        self._streams = {dev: torch.cuda.Stream(dev)
                         for dev in dict.fromkeys(self._targets)
                         if dev.type == 'cuda'}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='skytpu-prefetch')
        self._thread.start()

    def _rows(self, t: torch.Tensor) -> List[torch.Tensor]:
        n = len(self._targets)
        if t.shape[0] % n:
            raise ValueError(f'batch of {t.shape[0]} rows does not split '
                             f'over {n} batch ranks')
        return list(t.split(t.shape[0] // n))

    def _put_on_device(self, batch: Dict[str, Any]):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self._sharding is None:
            pieces = {k: [t] for k, t in batch.items()}
        else:
            pieces = {k: self._rows(t) for k, t in batch.items()}
        if not self._streams:
            staged = {k: [p.to(dev) for p, dev in zip(ps, self._targets)]
                      for k, ps in pieces.items()}
            ready = []
        else:
            staged = {k: [] for k in pieces}
            for k, ps in pieces.items():
                for p, dev in zip(ps, self._targets):
                    with torch.cuda.stream(self._streams[dev]):
                        staged[k].append(p.pin_memory().to(
                            dev, non_blocking=True))
            ready = []
            for dev, stream in self._streams.items():
                event = torch.cuda.Event()
                event.record(stream)
                ready.append((dev, event))
        if self._sharding is None:
            staged = {k: ps[0] for k, ps in staged.items()}
        return staged, ready

    def _run(self) -> None:
        try:
            with device_scope(self.device):
                for batch in self._iterator:
                    self._slots.acquire()     # backpressure at depth
                    if self._stop.is_set():
                        return
                    self._queue.put(self._put_on_device(batch))
        except BaseException as e:  # pylint: disable=broad-except
            self._error = e
        finally:
            self._queue.put(self._done)

    def __iter__(self) -> 'DevicePrefetcher':
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        item = self._queue.get()
        waited = time.perf_counter() - t0
        if waited > 1e-4:
            # The consumer blocked: the producer (host read + copy) is
            # behind compute.
            callbacks.record_data_wait(waited)
        if item is self._done:
            # Put the sentinel back: the iterator protocol allows
            # repeated next() after exhaustion (it must keep raising,
            # not block on an empty queue).
            self._queue.put(self._done)
            if self._error is not None:
                raise self._error
            raise StopIteration
        self._slots.release()
        batch, ready = item
        for dev, event in ready:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            for value in batch.values():
                for t in (value if isinstance(value, list) else [value]):
                    if t.device == dev:
                        t.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the producer (it may be parked on a full queue) and
        join it."""
        self._stop.set()
        self._slots.release()
        self._thread.join(timeout=60)

    def __enter__(self) -> 'DevicePrefetcher':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_device(iterator: Iterator[Any], *,
                       device: Union[str, torch.device] = 'cuda',
                       depth: int = 2,
                       sharding: Optional[Any] = None) -> DevicePrefetcher:
    """`for batch in prefetch_to_device(src): ...` with step N+1's copy
    overlapping step N's compute; with `sharding`, each batch rank's
    rows on its device (module docstring)."""
    return DevicePrefetcher(iterator, device=device, depth=depth,
                            sharding=sharding)
