"""Slice-replica rank protocol (mirrors `skypilot_tpu/serve/coordinator.py`):
rank 0 drives, followers execute in lockstep.

A slice replica is a GANG of ranks that must dispatch identical steps
in the same order.  This module owns the host side: the scheduling
decisions rank 0 makes (admit this request into that slot, run a tick,
release a slot, shut down) reach every rank as a replicated command
log:

    rank 0 (SliceCoordinator)          rank 1..N-1 (followers)
      broadcast(cmd seq=k)  ───────▶     execute(cmd), ack(seq=k)
      wait for all acks      ◀───────     (dead rank = no ack)

Two follower transports:

- :class:`LocalRank`: an emulated host in this process (one thread and
  one queue per rank).  Rank 0's dispatch covers every position of the
  slice mesh (a device list that may repeat one card), so the rank
  runs the protocol itself (ordering, acks, death) and, given an
  executor (`slice_replica.FollowerExecutor`), replays each command on
  its own device state.
- :class:`TcpRank` / :func:`follower_serve`: JSON lines over TCP, the
  transport of a rank in another process: rank 0 accepts one
  connection per follower on the coordinator port, and each follower
  connects, executes and acks.

Failure semantics: a slice fails AS A UNIT.  A follower that raises,
disconnects or misses the ack deadline is DEAD; the next broadcast on
rank 0 raises :class:`RankDead`, the engine fails everything in flight
and `/health` turns 503 with `slice.degraded`, and the controller
replaces the replica.  Every rank's execution of a command, rank 0's
included (inline, before the followers'), is the `serve.rank_exec`
chaos site (chaos/injector.py): an injected raise is that rank's host
dying mid-command, and `where: {rank: 0}` kills the head.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import queue
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from skypilot_tpu_torch.chaos import injector as chaos_injector
from skypilot_tpu_torch.observability import logs as logs_lib
from skypilot_tpu_torch.observability import metrics as metrics_lib

logger = logging.getLogger(__name__)

# Per-rank tick executions, the "is every host keeping up" counter the
# `serve status --metrics` HOSTS column is backed by.
_M_RANK_TICKS = metrics_lib.counter(
    'skytpu_slice_rank_ticks_total',
    'Coordinated commands executed per slice rank.', ('rank',))
_M_RANK_DEATHS = metrics_lib.counter(
    'skytpu_slice_rank_deaths_total',
    'Slice ranks that died (raise/disconnect/ack timeout).', ('rank',))
_M_RANKS_ALIVE = metrics_lib.gauge(
    'skytpu_slice_ranks_alive',
    'Live ranks of the most recently constructed slice replica '
    '(including rank 0).')
_M_SYNC_SECONDS = metrics_lib.histogram(
    'skytpu_slice_sync_seconds',
    'Wall time per coordinated broadcast until every rank acked '
    '(the host-side slice synchronization overhead per tick).',
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.5))

# Command vocabulary.  ADMIT/RELEASE carry enough payload for a real
# follower to mirror rank 0's host-side bookkeeping; TICK is the hot
# one (one per engine tick).
CMD_TICK = 'tick'
CMD_ADMIT = 'admit'
CMD_PREFILL = 'prefill'
CMD_RELEASE = 'release'
CMD_SHUTDOWN = 'shutdown'

_ACK_TIMEOUT_S = 30.0


class RankDead(RuntimeError):
    """A slice rank died; the replica must fail as a unit."""

    def __init__(self, rank: int, reason: str) -> None:
        super().__init__(f'slice rank {rank} died: {reason}')
        self.rank = rank
        self.reason = reason


@dataclasses.dataclass
class Command:
    kind: str
    seq: int
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({'kind': self.kind, 'seq': self.seq,
                           'payload': self.payload})

    @classmethod
    def from_json(cls, line: str) -> 'Command':
        data = json.loads(line)
        return cls(kind=str(data['kind']), seq=int(data['seq']),
                   payload=dict(data.get('payload') or {}))


def _execute(rank: int, cmd: Command,
             executor: Optional[Callable[[Command], None]]) -> None:
    """One rank's execution of a command: the boundary where a rank's
    host process dies mid-command, the `serve.rank_exec` chaos site (an
    executor that raises is the same death).  An ADMIT replay carries
    its request id, bound into the rank's log records."""
    chaos_injector.inject('serve.rank_exec', rank=rank, command=cmd.kind)
    if executor is not None:
        rid = cmd.payload.get('request_id') if cmd.payload else None
        if rid is not None:
            with logs_lib.bind(request_id=str(rid)):
                executor(cmd)
        else:
            executor(cmd)


class RankChannel:
    """One follower as rank 0 sees it."""

    rank: int

    def send(self, cmd: Command) -> None:
        raise NotImplementedError

    def wait_ack(self, seq: int, timeout: float) -> None:
        """Blocks until the follower acked `seq`; raises RankDead."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalRank(RankChannel):
    """In-process emulated host: a daemon thread executing the command
    log.  Rank 0's dispatch covers every position of the slice mesh, so
    the executor defaults to a no-op: what runs then is the protocol
    itself (ordering, acks, death).  A FollowerExecutor replays each
    command on the rank's own state."""

    def __init__(self, rank: int,
                 executor: Optional[Callable[[Command], None]] = None
                 ) -> None:
        self.rank = rank
        self._executor = executor
        self._inbox: 'queue.Queue[Optional[Command]]' = queue.Queue()
        self._acked = -1
        self._dead: Optional[str] = None
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f'slice-rank-{rank}')
        self._thread.start()

    def _run(self) -> None:
        while True:
            cmd = self._inbox.get()
            if cmd is None:
                return
            try:
                _execute(self.rank, cmd, self._executor)
            except Exception as e:  # pylint: disable=broad-except
                with self._cond:
                    self._dead = f'{type(e).__name__}: {e}'
                    self._cond.notify_all()
                return
            _M_RANK_TICKS.labels(rank=str(self.rank)).inc()
            with self._cond:
                self._acked = cmd.seq
                self._cond.notify_all()

    def send(self, cmd: Command) -> None:
        self._inbox.put(cmd)

    def wait_ack(self, seq: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._acked < seq:
                if self._dead is not None:
                    raise RankDead(self.rank, self._dead)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RankDead(self.rank,
                                   f'ack timeout after {timeout}s')
                self._cond.wait(timeout=remaining)

    def close(self) -> None:
        self._inbox.put(None)
        self._thread.join(timeout=5)


class TcpRank(RankChannel):
    """A follower over TCP (JSON lines, one ack line per command) —
    the real-slice transport; rank 0 accepts one connection per rank
    on the coordinator port from the gang env contract."""

    def __init__(self, rank: int, conn: socket.socket) -> None:
        self.rank = rank
        self._conn = conn
        self._rfile = conn.makefile('r', encoding='utf-8')
        self._wfile = conn.makefile('w', encoding='utf-8')
        self._acked = -1
        self._dead: Optional[str] = None
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read_acks,
                                        daemon=True,
                                        name=f'slice-rank-{rank}-acks')
        self._reader.start()

    def _read_acks(self) -> None:
        try:
            for line in self._rfile:
                ack = json.loads(line)
                if ack.get('status') != 'ok':
                    with self._cond:
                        self._dead = str(ack.get('error') or
                                         'command failed')
                        self._cond.notify_all()
                    return
                _M_RANK_TICKS.labels(rank=str(self.rank)).inc()
                with self._cond:
                    self._acked = int(ack['seq'])
                    self._cond.notify_all()
        except (OSError, ValueError) as e:
            with self._cond:
                self._dead = f'connection lost: {e}'
                self._cond.notify_all()
            return
        with self._cond:
            if self._dead is None:
                self._dead = 'connection closed'
            self._cond.notify_all()

    def send(self, cmd: Command) -> None:
        try:
            self._wfile.write(cmd.to_json() + '\n')
            self._wfile.flush()
        except (OSError, ValueError) as e:
            with self._cond:
                if self._dead is None:
                    self._dead = f'send failed: {e}'
                self._cond.notify_all()

    def wait_ack(self, seq: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._acked < seq:
                if self._dead is not None:
                    raise RankDead(self.rank, self._dead)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RankDead(self.rank,
                                   f'ack timeout after {timeout}s')
                self._cond.wait(timeout=remaining)

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass


def follower_serve(sock: socket.socket, rank: int,
                   executor: Optional[Callable[[Command], None]] = None,
                   ) -> None:
    """Follower loop for a REAL rank process: read commands off the
    coordinator connection, execute, ack each seq.
    Returns on `shutdown` or when the coordinator goes away; raises
    nothing — a failed command is acked with its error (rank 0 turns
    that into RankDead), then the loop exits because this rank is no
    longer in lockstep."""
    rfile = sock.makefile('r', encoding='utf-8')
    wfile = sock.makefile('w', encoding='utf-8')
    try:
        for line in rfile:
            cmd = Command.from_json(line)
            try:
                _execute(rank, cmd, executor)
            except Exception as e:  # pylint: disable=broad-except
                wfile.write(json.dumps({
                    'seq': cmd.seq, 'status': 'error',
                    'error': f'{type(e).__name__}: {e}'}) + '\n')
                wfile.flush()
                return
            wfile.write(json.dumps({'seq': cmd.seq,
                                    'status': 'ok'}) + '\n')
            wfile.flush()
            if cmd.kind == CMD_SHUTDOWN:
                return
    except (OSError, ValueError):
        return


def accept_followers(port: int, num_followers: int,
                     timeout: float = 120.0) -> List[TcpRank]:
    """Rank 0 side of the TCP transport: accept one connection per
    follower rank (each identifies itself with a hello line)."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(('0.0.0.0', port))
    server.listen(num_followers)
    server.settimeout(timeout)
    channels: List[TcpRank] = []
    try:
        while len(channels) < num_followers:
            conn, _ = server.accept()
            hello = conn.makefile('r', encoding='utf-8').readline()
            rank = int(json.loads(hello)['rank'])
            channels.append(TcpRank(rank, conn))
    finally:
        server.close()
    return channels


def follower_connect(address: str, rank: int,
                     timeout: float = 120.0) -> socket.socket:
    """Follower side: connect to rank 0's coordinator port and say
    hello (host:port, e.g. from SKYTPU_COORDINATOR_ADDRESS + offset)."""
    host, _, port = address.rpartition(':')
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection((host or '127.0.0.1',
                                             int(port)), timeout=10)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)
    sock.sendall((json.dumps({'rank': rank}) + '\n').encode())
    return sock


class SliceCoordinator:
    """Rank 0's view of the gang: broadcast commands, collect acks,
    track rank health.  `num_hosts` includes rank 0 itself (whose
    dispatch follows each broadcast)."""

    def __init__(self, num_hosts: int,
                 channels: Optional[List[RankChannel]] = None,
                 ack_timeout: float = _ACK_TIMEOUT_S) -> None:
        if num_hosts < 1:
            raise ValueError(f'num_hosts must be >= 1, got {num_hosts}')
        self.num_hosts = int(num_hosts)
        self._ack_timeout = float(ack_timeout)
        if channels is None:
            channels = [LocalRank(rank)
                        for rank in range(1, self.num_hosts)]
        if len(channels) != self.num_hosts - 1:
            raise ValueError(
                f'{self.num_hosts} hosts need {self.num_hosts - 1} '
                f'follower channels, got {len(channels)}')
        self._channels = channels
        self._seq = 0
        self._dead: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._sync_total_s = 0.0
        self._sync_count = 0
        self._closed = False
        _M_RANKS_ALIVE.set(self.num_hosts)

    # ------------------------------------------------------------ health

    @property
    def dead_ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._dead)

    @property
    def degraded(self) -> bool:
        with self._lock:
            return bool(self._dead)

    def ranks_alive(self) -> int:
        with self._lock:
            return self.num_hosts - len(self._dead)

    def sync_ms_mean(self) -> float:
        with self._lock:
            if not self._sync_count:
                return 0.0
            return self._sync_total_s / self._sync_count * 1e3

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            dead = sorted(self._dead)
            syncs = self._sync_count
            mean_ms = (self._sync_total_s / syncs * 1e3) if syncs else 0.0
        return {
            'num_hosts': self.num_hosts,
            'ranks_alive': self.num_hosts - len(dead),
            'dead_ranks': dead,
            'degraded': bool(dead),
            'sync_count': syncs,
            'sync_ms_mean': round(mean_ms, 4),
        }

    # --------------------------------------------------------- broadcast

    def broadcast(self, kind: str, **payload: Any) -> float:
        """Execute one command on rank 0, send it to every follower and
        wait for all acks (rank 0 dispatches after this returns).  Returns the sync wall
        time (seconds).  Raises RankDead on the FIRST command after any
        rank died: the caller (the engine tick wrapper) fails the
        replica as a unit."""
        with self._lock:
            if self._dead:
                rank = sorted(self._dead)[0]
                raise RankDead(rank, self._dead[rank])
            self._seq += 1
            cmd = Command(kind=kind, seq=self._seq, payload=payload)
        t0 = time.perf_counter()
        # Rank 0 executes inline first (its device work is the caller's
        # dispatch after this returns; its chaos site fires here like
        # any other rank's).
        try:
            _execute(0, cmd, None)
        except Exception as e:  # pylint: disable=broad-except
            self._mark_dead(0, f'{type(e).__name__}: {e}')
            raise RankDead(0, f'{type(e).__name__}: {e}') from e
        for channel in self._channels:
            channel.send(cmd)
        for channel in self._channels:
            try:
                channel.wait_ack(cmd.seq, self._ack_timeout)
            except RankDead as e:
                self._mark_dead(e.rank, e.reason)
                raise
        dt = time.perf_counter() - t0
        with self._lock:
            self._sync_total_s += dt
            self._sync_count += 1
        _M_SYNC_SECONDS.observe(dt)
        return dt

    def _mark_dead(self, rank: int, reason: str) -> None:
        with self._lock:
            if rank in self._dead:
                return
            self._dead[rank] = reason
            alive = self.num_hosts - len(self._dead)
        _M_RANK_DEATHS.labels(rank=str(rank)).inc()
        _M_RANKS_ALIVE.set(alive)
        logger.warning(f'slice rank {rank} died ({reason}); replica '
                       f'degraded to {alive}/{self.num_hosts} ranks')

    def tick(self) -> float:
        return self.broadcast(CMD_TICK)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Best-effort shutdown command so real followers exit their
        # loops; dead ranks are already gone.
        try:
            with self._lock:
                self._seq += 1
                cmd = Command(kind=CMD_SHUTDOWN, seq=self._seq)
            for channel in self._channels:
                channel.send(cmd)
        except Exception:  # pylint: disable=broad-except
            pass
        for channel in self._channels:
            channel.close()
