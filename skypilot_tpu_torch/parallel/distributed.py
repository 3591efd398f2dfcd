"""The gang environment of a multi-host job and the `torch.distributed`
group over its hosts (mirrors `skypilot_tpu/parallel/distributed.py`).

The gang-exec layer exports SKYTPU_HOST_RANK, SKYTPU_NUM_HOSTS,
SKYTPU_NUM_SLICES and SKYTPU_COORDINATOR_ADDRESS on every host (the
names are the reference's, `skypilot_tpu/skylet/constants.py`; the port
keeps its own copy).  The reference brings up `jax.distributed` from
them; `initialize_from_env` brings up a `torch.distributed` process
group instead: one rank a host, SKYTPU_NUM_HOSTS ranks, its store at
the coordinator's address (host 0 listens there).  The group carries
the DCN axes, 'data' and 'pipeline': each host runs its own device mesh
(parallel/mesh.py), the hosts at one pipeline coordinate sum their
gradients over their data group and the hosts of one data coordinate
pass a pipeline's boundary activations and their gradients from host
to host (`HostGroups`, `Transfer`; models/train.py and
parallel/pipeline.py).

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
    _GROUPS.clear()
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

    def __init__(self, pieces: List[torch.Tensor], group=None) -> None:
        self.pieces = pieces
        self.flat = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        self.staged = None
        if group_backend() == 'nccl':
            card = torch.device('cuda', torch.cuda.current_device())
            if self.flat.device != card:
                self.staged = self.flat.to(card)
        self.work = torch.distributed.all_reduce(
            self.flat if self.staged is None else self.staged,
            group=group, async_op=True)

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


def _size(group) -> int:
    return torch.distributed.get_world_size(group)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> int:
    """Sum `tensors` over the hosts of `group` (default: every host) in
    place; -> the bytes reduced (0 without a group, or over a group of
    one host).  Buckets by (device, dtype) of at most BUCKET_BYTES:
    pieces of one bucket are packed into one buffer, reduced and copied
    back; a bucket of one piece is reduced where it lies; up to
    IN_FLIGHT buckets are reduced at once.  No host sync is added
    (under NCCL the collectives are queued on the card; gloo's host
    transfers are waited for)."""
    if not torch.distributed.is_initialized() or group is SOLO:
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
            pending.append(_Bucket(pieces, group))
            total += sum(p.numel() for p in pieces) * size
            if len(pending) >= IN_FLIGHT:
                pending.pop(0).finish()
    for bucket in pending:
        bucket.finish()
    return total


def _wire_device() -> torch.device:
    """Where a collective moves a tensor: host memory under gloo (which
    does no point-to-point or gather on CUDA tensors), the current card
    under NCCL."""
    if group_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(_wire_device())


def all_gather(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """[n, *tensor.shape]: every host's `tensor` of `group` (default:
    every host) in rank order, on tensor's device (tensor[None] without
    a group, or over a group of one host).  For small tensors: the batch
    stripes and an MoE block's expert counts."""
    if not torch.distributed.is_initialized() or group is SOLO:
        return tensor[None]
    src = _wire(tensor.contiguous())
    out = [torch.empty_like(src) for _ in range(_size(group))]
    torch.distributed.all_gather(out, src, group=group)
    return torch.stack(out).to(tensor.device)


class Transfer:
    """Point-to-point sends and receives between hosts, each started at
    once and waited for together (`wait`), with the bytes moved and the
    seconds spent in them.  Under gloo a CUDA tensor is staged through
    host memory (gloo sends host buffers only); under NCCL each
    operation goes through `batch_isend_irecv`, so two hosts that send
    to each other cannot both block in a send."""

    def __init__(self) -> None:
        self._works: List[Any] = []
        self._landings: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._keep: List[torch.Tensor] = []
        self.bytes = 0
        self.seconds = 0.0

    def _start(self, op, tensor: torch.Tensor, peer: int) -> None:
        if group_backend() == 'nccl':
            self._works += torch.distributed.batch_isend_irecv(
                [torch.distributed.P2POp(op, tensor, peer)])
        else:
            self._works.append(op(tensor, peer))
        self.bytes += tensor.numel() * tensor.element_size()

    def send(self, tensor: torch.Tensor, dst: int) -> None:
        """Start sending `tensor` to host `dst` (a CUDA tensor staged
        through host memory waits for its stream first, outside the
        transfer's seconds)."""
        if tensor.device.type == 'cuda' and _wire_device() != tensor.device:
            torch.cuda.current_stream(tensor.device).synchronize()
        t0 = time.perf_counter()
        wire = _wire(tensor.detach().contiguous())
        self._keep.append(wire)
        self._start(torch.distributed.isend, wire, dst)
        self.seconds += time.perf_counter() - t0

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """Start receiving a tensor of `like`'s shape and dtype from
        host `src`; -> the tensor on like's device, filled by `wait`."""
        t0 = time.perf_counter()
        out = torch.empty_like(like)
        dev = _wire_device()
        wire = out if out.device == dev else torch.empty_like(out, device=dev)
        self._start(torch.distributed.irecv, wire, src)
        if wire is not out:
            self._landings.append((wire, out))
        self.seconds += time.perf_counter() - t0
        return out

    def wait(self) -> None:
        """Wait for every operation started so far."""
        t0 = time.perf_counter()
        for work in self._works:
            work.wait()
        for wire, out in self._landings:
            out.copy_(wire)
        self._works, self._landings, self._keep = [], [], []
        self.seconds += time.perf_counter() - t0


# A group of one host: nothing to reduce or gather.
SOLO = 'solo'


class HostGroups:
    """The two families of sub-groups of a gang laid out over a grid of
    (data, pipeline) hosts (`Mesh.host_grid`; host h at divmod(h,
    pipeline hosts)): the data group of each pipeline coordinate (the
    hosts that hold the same stages) and the pipeline group of each
    data coordinate.  Every host creates every group, in the same order
    (`torch.distributed.new_group` needs every rank, members or not);
    a family that spans every host is the default group (None), a group
    of one host `SOLO`."""

    def __init__(self, data_hosts: int, pipeline_hosts: int) -> None:
        self.grid = (int(data_hosts), int(pipeline_hosts))
        n = data_hosts * pipeline_hosts
        if torch.distributed.is_initialized() and _size(None) != n:
            raise ValueError(f'a grid of {data_hosts} x {pipeline_hosts} '
                             f'hosts in a group of {_size(None)}')
        self.data_ranks = [[d * pipeline_hosts + p for d in range(data_hosts)]
                           for p in range(pipeline_hosts)]
        self.pipeline_ranks = [[d * pipeline_hosts + p
                                for p in range(pipeline_hosts)]
                               for d in range(data_hosts)]
        self._data = [self._group(r, n) for r in self.data_ranks]
        self._pipeline = [self._group(r, n) for r in self.pipeline_ranks]

    @staticmethod
    def _group(ranks: List[int], n: int):
        if len(ranks) == 1:
            return SOLO
        if len(ranks) == n or not torch.distributed.is_initialized():
            return None
        return torch.distributed.new_group(ranks)

    def data(self, host: int):
        """The data group of host `host` (the hosts at its stages)."""
        return self._data[host % self.grid[1]]

    def pipeline(self, host: int):
        """The pipeline group of host `host` (its data coordinate)."""
        return self._pipeline[host // self.grid[1]]


_GROUPS: Dict[Tuple[int, int], HostGroups] = {}


def host_groups(data_hosts: int, pipeline_hosts: int) -> HostGroups:
    """The `HostGroups` of this grid, made once a process (every host
    makes them at the same point: its first step on the grid)."""
    key = (int(data_hosts), int(pipeline_hosts))
    if key not in _GROUPS:
        _GROUPS[key] = HostGroups(*key)
    return _GROUPS[key]


class HostReduction:
    """The cross-host sums of a training step, with what they cost:
    `models.train` calls it for the denominator, the loss and the
    gradients (each block's owner copy, so the bytes do not grow with
    the copies), over every host or over one of this host's sub-groups
    of the (data, pipeline) host grid (`HostGroups`, made at the first
    sum); `take()` gives the seconds and bytes since the last take,
    summed over every group.  On CUDA the time is CUDA events around the
    collectives on the current stream (read by `take`, after the caller
    synchronised), on the CPU the host clock."""

    def __init__(self, grid: Tuple[int, int], host: int) -> None:
        self.grid = tuple(grid)
        self.host = int(host)
        self._bytes = 0
        self._seconds = 0.0
        self._events: List[Tuple[Any, Any]] = []

    @property
    def groups(self) -> HostGroups:
        return host_groups(*self.grid)

    def group(self, over: str):
        """The group of `over`: 'hosts' (every host), 'data' or
        'pipeline' (this host's)."""
        if over == 'hosts':
            return None
        return getattr(self.groups, over)(self.host)

    def __call__(self, tensors: Sequence[torch.Tensor],
                 over: str = 'hosts') -> None:
        tensors = list(tensors)
        if not tensors:
            return
        group = self.group(over)
        dev = tensors[0].device
        if dev.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            self._bytes += all_reduce_sum_(tensors, group)
            end.record(torch.cuda.current_stream(dev))
            self._events.append((start, end))
            return
        t0 = time.perf_counter()
        self._bytes += all_reduce_sum_(tensors, group)
        self._seconds += time.perf_counter() - t0

    def take(self) -> Tuple[float, int]:
        """(seconds, bytes) reduced since the last take."""
        seconds = self._seconds + sum(
            start.elapsed_time(end) for start, end in self._events) / 1e3
        out = (seconds, self._bytes)
        self._bytes, self._seconds, self._events = 0, 0.0, []
        return out
