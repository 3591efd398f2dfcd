"""The gang environment of a multi-host job and the `torch.distributed`
group over its hosts (mirrors `skypilot_tpu/parallel/distributed.py`).

The gang-exec layer exports SKYTPU_HOST_RANK, SKYTPU_NUM_HOSTS,
SKYTPU_NUM_SLICES and SKYTPU_COORDINATOR_ADDRESS on every host (the
names are the reference's, `skypilot_tpu/skylet/constants.py`; the port
keeps its own copy).  The reference brings up `jax.distributed` from
them; `initialize_from_env` brings up a `torch.distributed` process
group instead: one rank a host, SKYTPU_NUM_HOSTS ranks, its store at
the coordinator's address (host 0 listens there).  The group carries
the DCN 'data' axis only: each host runs its own device mesh
(parallel/mesh.py) and the hosts sum their gradients through the group
(`HostReduction`, models/train.py).

The backend is chosen, never fallen back to: 'nccl' for CUDA devices,
'gloo' for CPU entries, and 'gloo' on CUDA tensors only when the caller
names it (gloo stages them through host memory; two hosts that share
one card must use it, since NCCL refuses two ranks on one device).  A
host that cannot reach the coordinator raises once `timeout` has
passed; a collective that fails raises.
"""
from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

logger = logging.getLogger(__name__)

ENV_HOST_RANK = 'SKYTPU_HOST_RANK'          # global host rank, 0..N-1
ENV_NUM_HOSTS = 'SKYTPU_NUM_HOSTS'
ENV_NUM_SLICES = 'SKYTPU_NUM_SLICES'        # multislice (DCN) width
ENV_COORDINATOR_ADDRESS = 'SKYTPU_COORDINATOR_ADDRESS'  # host0_ip:port

BACKENDS = ('nccl', 'gloo')
# How long a host waits for the others: at start-up for the
# coordinator, later for each collective.
DEFAULT_TIMEOUT_S = 600.0
# The largest buffer one all-reduce moves, and how many are in flight
# at once: bound the staging memory (gloo copies each buffer through
# pinned host memory) while the buckets' copies and transfers overlap.
BUCKET_BYTES = 128 << 20
IN_FLIGHT = 4


def initialize_from_env(*, force: bool = False,
                        backend: Optional[str] = None,
                        device: Union[str, torch.device] = 'cuda',
                        timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the hosts' process group from SKYTPU_* env, if present.

    Idempotent; True if the group is (now) up, False when the job runs
    on one host (no coordinator or SKYTPU_NUM_HOSTS <= 1: nothing to
    do, every single-host path unchanged).  `device` is the host's
    first device; `backend` None means 'nccl' for a CUDA device and
    'gloo' for the CPU.  Under NCCL the device becomes the current
    card before the group forms."""
    if torch.distributed.is_initialized() and not force:
        return True
    coordinator = os.environ.get(ENV_COORDINATOR_ADDRESS)
    hosts = num_hosts()
    if coordinator is None or hosts <= 1:
        return False
    rank = host_rank()
    if not 0 <= rank < hosts:
        raise ValueError(f'{ENV_HOST_RANK}={rank} outside 0..{hosts - 1}')
    from skypilot_tpu_torch.device import resolve_device  # pylint: disable=import-outside-toplevel
    dev = resolve_device(device)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend not in BACKENDS:
        raise ValueError(f'backend {backend!r}: one of {BACKENDS}')
    if backend == 'nccl':
        if dev.type != 'cuda':
            raise ValueError(f'backend nccl needs CUDA devices, not {dev}')
        torch.cuda.set_device(dev)
    if force and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    address = (coordinator if '://' in coordinator
               else f'tcp://{coordinator}')
    torch.distributed.init_process_group(
        backend, init_method=address, world_size=hosts, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    logger.info('torch.distributed up: rank %d/%d backend %s coordinator '
                '%s', rank, hosts, backend, coordinator)
    return True


def shutdown() -> None:
    """Leave the group, if this process joined one."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def num_slices() -> int:
    return int(os.environ.get(ENV_NUM_SLICES, '1'))


def num_hosts() -> int:
    return int(os.environ.get(ENV_NUM_HOSTS, '1'))


def host_rank() -> int:
    return int(os.environ.get(ENV_HOST_RANK, '0'))


def gang() -> Tuple[int, int]:
    """(hosts, this host's rank) of the group this process joined, or
    (1, 0) without one."""
    if not torch.distributed.is_initialized():
        return 1, 0
    return torch.distributed.get_world_size(), torch.distributed.get_rank()


def group_backend() -> Optional[str]:
    """The group's backend, None without a group."""
    if not torch.distributed.is_initialized():
        return None
    return str(torch.distributed.get_backend())


def is_primary() -> bool:
    """Host 0 of the group, or the one host without one."""
    return gang()[1] == 0


def barrier() -> None:
    """Wait for every host (nothing without a group)."""
    if torch.distributed.is_initialized():
        torch.distributed.barrier()


def broadcast_object(obj: Any) -> Any:
    """Host 0's `obj` on every host (obj itself without a group)."""
    if not torch.distributed.is_initialized():
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


class _Bucket:
    """One all-reduce in flight: the pieces it sums, the contiguous
    buffer it reduces (the one piece itself, or the pieces packed) and,
    under NCCL for a buffer off the current card, the copy staged
    there (ProcessGroupNCCL takes one card a process)."""

    def __init__(self, pieces: List[torch.Tensor]) -> None:
        self.pieces = pieces
        self.flat = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        self.staged = None
        if group_backend() == 'nccl':
            card = torch.device('cuda', torch.cuda.current_device())
            if self.flat.device != card:
                self.staged = self.flat.to(card)
        self.work = torch.distributed.all_reduce(
            self.flat if self.staged is None else self.staged,
            async_op=True)

    def finish(self) -> None:
        """Wait for the sum (under NCCL, the current stream waits) and
        put it back into the pieces."""
        self.work.wait()
        if self.staged is not None:
            self.flat.copy_(self.staged)
        if len(self.pieces) > 1:
            for piece, part in zip(self.pieces, self.flat.split(
                    [p.numel() for p in self.pieces])):
                piece.copy_(part)


def _buckets(tensors: Sequence[torch.Tensor], cap: int):
    """Contiguous pieces of `tensors` (flat views, each tensor split
    into pieces of at most `cap` elements) grouped in order into
    buckets of at most `cap` elements."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        for piece in t.view(-1).split(cap):
            if bucket and size + piece.numel() > cap:
                yield bucket
                bucket, size = [], 0
            bucket.append(piece)
            size += piece.numel()
    if bucket:
        yield bucket


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> int:
    """Sum `tensors` over the hosts in place; -> the bytes reduced (0
    without a group).  Buckets by (device, dtype) of at most
    BUCKET_BYTES: pieces of one bucket are packed into one buffer,
    reduced and copied back; a bucket of one piece is reduced where it
    lies; up to IN_FLIGHT buckets are reduced at once.  No host sync is
    added (under NCCL the collectives are queued on the card; gloo's
    host transfers are waited for)."""
    if not torch.distributed.is_initialized():
        return 0
    groups: Dict[Tuple[torch.device, torch.dtype], List[torch.Tensor]] = {}
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError('all_reduce_sum_ reduces contiguous tensors in '
                             f'place; got strides {t.stride()}')
        groups.setdefault((t.device, t.dtype), []).append(t)
    total = 0
    pending: List[_Bucket] = []
    for ts in groups.values():
        size = ts[0].element_size()
        for pieces in _buckets(ts, max(1, BUCKET_BYTES // size)):
            pending.append(_Bucket(pieces))
            total += sum(p.numel() for p in pieces) * size
            if len(pending) >= IN_FLIGHT:
                pending.pop(0).finish()
    for bucket in pending:
        bucket.finish()
    return total


class HostReduction:
    """The cross-host sum of a training step (the DCN 'data' axis), with
    what it cost: `models.train` calls it once for the denominator and
    once for the loss and every gradient (each block's owner copy, so
    the bytes do not grow with the copies); `take()` gives the seconds
    and bytes since the last take.  On CUDA the time is CUDA events
    around the collectives on the current stream (read by `take`, after
    the caller synchronised), on the CPU the host clock."""

    def __init__(self) -> None:
        self._bytes = 0
        self._seconds = 0.0
        self._events: List[Tuple[Any, Any]] = []

    def __call__(self, tensors: Sequence[torch.Tensor]) -> None:
        tensors = list(tensors)
        dev = tensors[0].device
        if dev.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            self._bytes += all_reduce_sum_(tensors)
            end.record(torch.cuda.current_stream(dev))
            self._events.append((start, end))
            return
        t0 = time.perf_counter()
        self._bytes += all_reduce_sum_(tensors)
        self._seconds += time.perf_counter() - t0

    def take(self) -> Tuple[float, int]:
        """(seconds, bytes) reduced since the last take."""
        seconds = self._seconds + sum(
            start.elapsed_time(end) for start, end in self._events) / 1e3
        out = (seconds, self._bytes)
        self._bytes, self._seconds, self._events = 0, 0.0, []
        return out
