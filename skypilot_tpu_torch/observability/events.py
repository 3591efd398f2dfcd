"""The flight recorder: event journal, control spans and fleet
instruments (a copy of `skypilot_tpu/observability/events.py`).

- :class:`EventJournal`: an append-only JSONL journal, one file per
  scope under ``$SKYTPU_HOME/events/`` (default ``~/.skytpu``), with
  size-based rotation to ``<path>.1`` (SKYTPU_EVENT_JOURNAL_MAX_BYTES)
  and a bounded in-process tail.  The port trains and serves, so its
  scopes are `training_journal()` (checkpoint saves, elastic resizes
  and resumes), ``serve.jsonl`` (`profiling.serve_journal`: the engine's
  profiling lifecycle and recompiles, page alloc/free, request and
  weight-swap events) and the chaos injector's ``chaos.jsonl``; the
  control-plane scopes are kept so that one home holds one layout.
- :class:`ControlSpan`: journals ``<name>_start`` / ``<name>_end``
  (status, duration) and mirrors the finished span into the Chrome
  timeline (utils/timeline.py).
- `format_timeline`, `to_chrome_trace_events`, `export_chrome_trace`:
  the journal rendered as text lines or a Chrome trace.
- Instruments (get-or-create accessors into the process-global
  registry, observability/metrics.py) under the reference's names,
  kinds, labels and buckets, the checkpoint ones among them
  (data/checkpoints.py re-exports those).

The file format is the reference's, record for record:

    {"ts": <epoch seconds>, "seq": <per-process counter>,
     "event": "<type>", ...free-form fields...}

so the reference's readers and invariant checkers replay what the port
writes.  Writes are best effort: an I/O error is logged at debug level
and swallowed, and `read` skips a corrupt line.
"""
from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.utils import timeline

logger = logging.getLogger(__name__)

# Per-journal size cap before rotation to `<path>.1` (one rotation
# kept: the current and the previous generation bound disk per scope).
DEFAULT_MAX_BYTES = 5 * 1024 * 1024
_MAX_BYTES_ENV = 'SKYTPU_EVENT_JOURNAL_MAX_BYTES'
# Events kept in the in-process tail per journal.
TAIL_LEN = 256

# Upper bounds (seconds) for control-plane waits: capacity grants and
# preemption recoveries run minutes to hours.
LONG_WAIT_BUCKETS = (1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                     1200.0, 1800.0, 3600.0, 7200.0)


def _max_bytes() -> int:
    try:
        return int(os.environ.get(_MAX_BYTES_ENV, DEFAULT_MAX_BYTES))
    except ValueError:
        return DEFAULT_MAX_BYTES


class EventJournal:
    """Append-only JSONL journal for one scope.

    Thread-safe; safe for concurrent appenders from several processes
    (O_APPEND line writes; ordering across processes is by timestamp).
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 tail_len: int = TAIL_LEN) -> None:
        self.path = path
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        self._tail: Deque[Dict[str, Any]] = collections.deque(
            maxlen=tail_len)
        self._seq = itertools.count()

    def append(self, event: str, **fields: Any) -> Dict[str, Any]:
        """Record one event; -> the record (the in-process tail gets it
        even when the disk write fails)."""
        record: Dict[str, Any] = {'ts': time.time(),
                                  'seq': next(self._seq),
                                  'event': event}
        record.update(fields)
        with self._lock:
            self._tail.append(record)
            try:
                self._maybe_rotate()
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                with open(self.path, 'a', encoding='utf-8') as f:
                    f.write(json.dumps(record, default=str) + '\n')
            except OSError as e:
                logger.debug('event journal append failed (%s): %s',
                             self.path, e)
        return record

    def _maybe_rotate(self) -> None:
        limit = self._max_bytes if self._max_bytes is not None \
            else _max_bytes()
        try:
            if os.path.getsize(self.path) < limit:
                return
        except OSError:
            return  # no file yet
        os.replace(self.path, self.path + '.1')

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last snapshot of the in-process tail."""
        with self._lock:
            events = list(self._tail)
        return events[-n:] if n else events

    def read(self) -> List[Dict[str, Any]]:
        """Every event on disk (the rotated generation first), ordered
        by ts.  Corrupt lines are skipped."""
        events: List[Dict[str, Any]] = []
        for path in (self.path + '.1', self.path):
            try:
                with open(path, encoding='utf-8') as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            events.append(json.loads(line))
                        except ValueError:
                            continue
            except OSError:
                continue
        events.sort(key=lambda e: e.get('ts', 0.0))
        return events


# ------------------------------------------------------------- registry

_journals: Dict[str, EventJournal] = {}
_journals_lock = threading.Lock()


def journal_root() -> str:
    """``$SKYTPU_HOME/events`` (the reference's `common_utils.skytpu_home`
    default, ``~/.skytpu``), read at every call."""
    home = os.path.expanduser(os.environ.get('SKYTPU_HOME', '~/.skytpu'))
    return os.path.join(home, 'events')


def get_journal(path: str) -> EventJournal:
    """Get-or-create the journal for `path` (one instance per path, so
    the in-process tail and seq counter are shared across call sites)."""
    with _journals_lock:
        journal = _journals.get(path)
        if journal is None:
            journal = EventJournal(path)
            _journals[path] = journal
        return journal


def cluster_journal(cluster_name: str) -> EventJournal:
    return get_journal(os.path.join(journal_root(), 'clusters',
                                    f'{cluster_name}.jsonl'))


def job_journal(job_id: int) -> EventJournal:
    return get_journal(os.path.join(journal_root(), 'managed_jobs',
                                    f'{job_id}.jsonl'))


def cluster_job_journal(job_id: int) -> EventJournal:
    return get_journal(os.path.join(journal_root(), 'cluster_jobs',
                                    f'{job_id}.jsonl'))


def skylet_journal() -> EventJournal:
    return get_journal(os.path.join(journal_root(), 'skylet.jsonl'))


def training_journal() -> EventJournal:
    """Training-side events on this host (async checkpoint saves,
    elastic resizes and resumes), shared by every process of one
    SKYTPU_HOME."""
    return get_journal(os.path.join(journal_root(), 'training.jsonl'))


# ----------------------------------------------------------------- spans


class ControlSpan:
    """Journal a phase as start/end events and mirror the finished span
    into the Chrome timeline.  A `_start` without its `_end` marks where
    a process died; the end carries duration and status ('ok' or the
    exception's class name).  `journal=None` records the timeline
    only."""

    def __init__(self, journal: Optional[EventJournal], name: str,
                 **fields: Any) -> None:
        self._journal = journal
        self._name = name
        self._fields = dict(fields)
        self._t0 = 0.0
        self._wall0 = 0.0

    def add(self, **fields: Any) -> None:
        """Fields discovered mid-span; they ride on the end event."""
        self._fields.update(fields)

    def __enter__(self) -> 'ControlSpan':
        self._t0 = time.monotonic()
        self._wall0 = time.time()
        if self._journal is not None:
            self._journal.append(f'{self._name}_start', **self._fields)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration = time.monotonic() - self._t0
        status = 'ok' if exc_type is None else exc_type.__name__
        fields = dict(self._fields)
        if exc is not None:
            fields.setdefault('error', str(exc)[:500])
        if self._journal is not None:
            self._journal.append(f'{self._name}_end', status=status,
                                 duration_s=round(duration, 6), **fields)
        timeline.add_complete_event(
            f'control:{self._name}', self._wall0, duration,
            args={'status': status, **{k: v for k, v in fields.items()
                                       if isinstance(v, (str, int,
                                                         float, bool))}},
            cat='control')
        return False


# ------------------------------------------------------------ rendering


def format_timeline(events: List[Dict[str, Any]]) -> List[str]:
    """Text lines: wall clock, offset from the first event, the event's
    name, then its other fields as k=v."""
    if not events:
        return []
    t0 = events[0].get('ts', 0.0)
    lines = []
    for e in events:
        ts = e.get('ts', 0.0)
        clock = time.strftime('%H:%M:%S', time.localtime(ts))
        ms = int((ts % 1) * 1000)
        extras = ' '.join(
            f'{k}={e[k]}' for k in e
            if k not in ('ts', 'seq', 'event') and e[k] is not None)
        lines.append(f'{clock}.{ms:03d}  +{ts - t0:8.3f}s  '
                     f'{e.get("event", "?"):<28s} {extras}'.rstrip())
    return lines


def to_chrome_trace_events(events: List[Dict[str, Any]]
                           ) -> List[Dict[str, Any]]:
    """Journal records -> Chrome trace events: an `*_end` record with a
    duration becomes an 'X' event placed at its start; anything else an
    instant marker."""
    out = []
    for e in events:
        name = e.get('event', '?')
        ts = float(e.get('ts', 0.0))
        args = {k: v for k, v in e.items()
                if k not in ('ts', 'seq', 'event')}
        if name.endswith('_end') and 'duration_s' in e:
            duration = float(e['duration_s'])
            out.append({'name': name[:-len('_end')], 'cat': 'control',
                        'ph': 'X',
                        'ts': int((ts - duration) * 1e6),
                        'dur': max(0, int(duration * 1e6)),
                        'pid': 0, 'tid': 0, 'args': args})
        else:
            out.append({'name': name, 'cat': 'control', 'ph': 'i',
                        's': 'p', 'ts': int(ts * 1e6),
                        'pid': 0, 'tid': 0, 'args': args})
    return out


def export_chrome_trace(events: List[Dict[str, Any]], path: str) -> None:
    timeline.write_trace(path, to_chrome_trace_events(events))


# ---------------------------------------------------------- instruments
# Get-or-create accessors: the registry resolves one name to one
# instrument however often they run.


def provision_attempts() -> metrics.Counter:
    return metrics.counter(
        'skytpu_provision_attempts_total',
        'Per-zone provision attempts made by the failover loop',
        labelnames=('cloud',))


def provision_failovers() -> metrics.Counter:
    return metrics.counter(
        'skytpu_provision_failover_total',
        'Provision attempts that failed and triggered failover, by '
        'failure class', labelnames=('reason',))


def provision_wait_hist() -> metrics.Histogram:
    return metrics.histogram(
        'skytpu_provision_wait_seconds',
        'Queued-resource capacity wait until granted or timed out',
        buckets=LONG_WAIT_BUCKETS)


def gang_ranks_gauge() -> metrics.Gauge:
    return metrics.gauge('skytpu_gang_ranks',
                         'Ranks in the most recent gang run')


def gang_rank_exits() -> metrics.Counter:
    return metrics.counter('skytpu_gang_rank_exits_total',
                           'Gang rank exits by return code',
                           labelnames=('code',))


def gang_abort_hist() -> metrics.Histogram:
    return metrics.histogram(
        'skytpu_gang_abort_seconds',
        'First rank failure to all surviving ranks terminated')


def skylet_tick_hist() -> metrics.Histogram:
    return metrics.histogram('skytpu_skylet_tick_seconds',
                             'Skylet event run() wall time',
                             labelnames=('event',))


def skylet_event_failures() -> metrics.Counter:
    return metrics.counter('skytpu_skylet_event_failures_total',
                           'Skylet event run() raised',
                           labelnames=('event',))


def jobs_preemptions() -> metrics.Counter:
    return metrics.counter(
        'skytpu_jobs_preemptions_total',
        'Managed-job cluster preemptions detected by the controller')


def jobs_recovery_hist() -> metrics.Histogram:
    return metrics.histogram(
        'skytpu_jobs_recovery_seconds',
        'Managed-job recovery duration (detection to relaunched)',
        buckets=LONG_WAIT_BUCKETS)


# Checkpoint saves run seconds to minutes (write + retries).
CHECKPOINT_SAVE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                           10.0, 30.0, 60.0, 120.0)


def checkpoint_save_hist() -> metrics.Histogram:
    return metrics.histogram(
        'skytpu_checkpoint_save_seconds',
        'Checkpoint save wall time (write + retries; off the step '
        'critical path for async saves)',
        buckets=CHECKPOINT_SAVE_BUCKETS)


def checkpoint_blocked_counter() -> metrics.Counter:
    return metrics.counter(
        'skytpu_checkpoint_blocked_seconds_total',
        'Seconds train steps spent blocked waiting on the bounded '
        'in-flight checkpoint save slot (nonzero means saves are '
        'slower than the save interval)')


def gang_resizes() -> metrics.Counter:
    return metrics.counter(
        'skytpu_gang_resizes_total',
        'Elastic gang resizes (shrink on partial preemption, expand '
        'when capacity returns)', labelnames=('direction',))
