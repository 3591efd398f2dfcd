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

The time the consumer blocks on an empty queue goes to
`callbacks.record_data_wait` (the summary's `prefetch_wait_seconds`
and `skytpu_train_data_wait_seconds_total`).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, Union

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
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f'depth must be >= 1, got {depth}')
        self.device = resolve_device(device)
        self._iterator = iterator
        self._queue: 'queue.Queue[Any]' = queue.Queue()
        self._slots = threading.Semaphore(depth)
        self._stop = threading.Event()
        self._done = object()
        self._error = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == 'cuda' else None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='skytpu-prefetch')
        self._thread.start()

    def _put_on_device(self, batch: Dict[str, Any]):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self._stream is None:
            return batch, None
        with torch.cuda.stream(self._stream):
            staged = {k: t.pin_memory().to(self.device, non_blocking=True)
                      for k, t in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
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
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
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
                       depth: int = 2) -> DevicePrefetcher:
    """`for batch in prefetch_to_device(src): ...` with step N+1's copy
    overlapping step N's compute."""
    return DevicePrefetcher(iterator, device=device, depth=depth)
