"""Replica log plane: structured request-scoped logs (the replica half of
`skypilot_tpu/observability/logs.py`, copied).

Every log record the port emits under the `skypilot_tpu_torch` logger
is captured (once `install()` ran; the model server calls it) into a
bounded in-process ring of structured entries:

    {seq, ts, level, logger, msg,
     process, replica_id, role,      # who said it
     request_id, attempt}            # on whose behalf

The identity fields come from a **contextvar** that each serving layer
binds around the request it is handling (the HTTP front, the engine
worker admission), reusing the `X-SkyTPU-Request-Id` / `X-SkyTPU-Attempt`
propagation the tracing plane already ships — so a log line emitted
three processes away from the client still knows which request it
belongs to.  contextvars survive `await` boundaries natively; thread
handoffs (`run_in_executor`, the engine worker) re-bind explicitly.

The ring is exported over `GET /logs?since=&level=&request_id=&grep=
&limit=`; `since=` is an exact **seq cursor** (records with
`seq > since`), so paginating exporters never see a record twice and
never miss one that survived the ring bound.

`skytpu_log_records_total{level}` counts captured records and
`skytpu_http_requests_total{route,code}` served requests, under the
reference's names (the fleet aggregator scrapes both).  The
controller's error-spike alerts (`LogSpikeTracker`) are not a replica's
and are not copied.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import logging
import os
import re
import threading
from typing import Any, Deque, Dict, Iterator, List, Optional

from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.serve import http_protocol

# Default bound on the in-process record ring.  ~2k records of ~200
# bytes keeps the whole plane under a megabyte per process.
DEFAULT_RING_RECORDS = 2048

# The package logger whose records the ring captures.
PACKAGE_LOGGER = 'skypilot_tpu_torch'


def ring_records() -> int:
    try:
        return int(os.environ.get('SKYTPU_LOG_RING_RECORDS',
                                  str(DEFAULT_RING_RECORDS)))
    except ValueError:
        return DEFAULT_RING_RECORDS


# --------------------------------------------------------------- context

# One merged dict of bound fields (request_id/attempt/process/
# replica_id/role).  asyncio tasks inherit it at creation; executor
# threads need contextvars.copy_context().run (see wrap_context).
_CTX: 'contextvars.ContextVar[Optional[Dict[str, Any]]]' = \
    contextvars.ContextVar('skytpu_log_ctx', default=None)

# Process-level fallback identity: the normal one-server-per-process
# deployment sets it once at startup; tests hosting several "processes"
# in one interpreter rely on the contextvar binding instead.
_process_identity: Dict[str, Any] = {}


def set_process_identity(process: str,
                         replica_id: Optional[Any] = None,
                         role: Optional[str] = None) -> None:
    """Default identity stamped on records with no bound context."""
    _process_identity.clear()
    _process_identity['process'] = process
    if replica_id is not None:
        _process_identity['replica_id'] = replica_id
    if role is not None:
        _process_identity['role'] = role


@contextlib.contextmanager
def bind(request_id: Optional[str] = None,
         attempt: Optional[int] = None,
         process: Optional[str] = None,
         replica_id: Optional[Any] = None,
         role: Optional[str] = None) -> Iterator[None]:
    """Bind request/identity fields for log records emitted inside the
    context (merging over any outer binding; None fields inherit)."""
    merged = dict(_CTX.get() or {})
    for key, value in (('request_id', request_id), ('attempt', attempt),
                       ('process', process), ('replica_id', replica_id),
                       ('role', role)):
        if value is not None:
            merged[key] = value
    token = _CTX.set(merged)
    try:
        yield
    finally:
        _CTX.reset(token)


def current_context() -> Dict[str, Any]:
    """The fields a record emitted right now would carry (bound
    context over the process fallback)."""
    out = dict(_process_identity)
    out.update(_CTX.get() or {})
    return out


def wrap_context(fn):
    """Carry the CURRENT context into a thread-pool callable: asyncio's
    `run_in_executor` runs the function in a bare worker thread where
    contextvars reset to defaults — the classic request-id-loss bug."""
    ctx = contextvars.copy_context()
    return lambda *args, **kwargs: ctx.run(fn, *args, **kwargs)


# ------------------------------------------------------------------ ring

def parse_log_query(query: str) -> Dict[str, Any]:
    """`GET /logs` query args -> export kwargs; malformed values are
    ignored, not 400s (same degradation contract as
    tracing.parse_span_query — the CLI must survive version skew)."""
    from urllib.parse import parse_qs  # pylint: disable=import-outside-toplevel
    parsed = parse_qs(query or '')
    out: Dict[str, Any] = {}
    for key in ('request_id', 'level', 'grep'):
        if parsed.get(key):
            out[key] = parsed[key][0]
    for key in ('since', 'limit'):
        if parsed.get(key):
            try:
                value = float(parsed[key][0])
                out[key] = int(value) if key == 'limit' else value
            except ValueError:
                pass
    return out


def _level_no(level: Any) -> Optional[int]:
    """'warning' / 'WARNING' / '30' -> 30; unknown names -> None
    (filter ignored rather than rejected)."""
    if level is None:
        return None
    text = str(level).strip()
    if not text:
        return None
    try:
        return int(float(text))
    except ValueError:
        pass
    resolved = logging.getLevelName(text.upper())
    return resolved if isinstance(resolved, int) else None


class LogRecordRing:
    """Bounded ring of structured log records with exact `since=` seq
    pagination (strictly-after cursor; seq is unique + monotonic)."""

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self._records: Deque[Dict[str, Any]] = collections.deque(
            maxlen=maxlen if maxlen is not None else ring_records())
        self._lock = threading.Lock()
        self._seq = 0

    def add(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            record['seq'] = self._seq
            self._records.append(record)

    def export(self, since: Optional[float] = None,
               level: Any = None,
               request_id: Optional[str] = None,
               grep: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Matching records oldest-first; `since` is a seq cursor
        (records with seq > since), `level` a minimum severity,
        `grep` a regex (substring fallback on a bad pattern),
        `limit` keeps the newest n."""
        with self._lock:
            records = list(self._records)
        min_no = _level_no(level)
        pattern = None
        if grep:
            try:
                pattern = re.compile(grep)
            except re.error:
                pattern = None
        out = []
        for rec in records:
            if since is not None and rec['seq'] <= since:
                continue
            if min_no is not None and rec.get('levelno', 0) < min_no:
                continue
            if request_id is not None and \
                    rec.get('request_id') != request_id:
                continue
            if grep:
                msg = str(rec.get('msg', ''))
                if pattern is not None:
                    if not pattern.search(msg):
                        continue
                elif grep not in msg:
                    continue
            out.append(dict(rec))
        if limit is not None:
            out = out[-int(limit):]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


_global_ring: Optional[LogRecordRing] = None
_ring_lock = threading.Lock()


def get_ring() -> LogRecordRing:
    """The process-wide ring the installed handler writes to."""
    global _global_ring
    with _ring_lock:
        if _global_ring is None:
            _global_ring = LogRecordRing()
        return _global_ring


def reset_ring() -> LogRecordRing:
    """Swap in a fresh ring (tests; re-reads the env cap).  Handlers
    constructed without an explicit ring resolve through get_ring()
    on every emit, so they follow the swap."""
    global _global_ring
    with _ring_lock:
        _global_ring = LogRecordRing()
        return _global_ring


# --------------------------------------------------------------- metrics

def _records_counter():
    return metrics_lib.counter(
        'skytpu_log_records_total',
        'Log records captured by the structured handler, per level.',
        ('level',))


def _http_counter():
    return metrics_lib.counter(
        'skytpu_http_requests_total',
        'HTTP requests served by the serving fronts, per route and '
        'status code.', ('route', 'code'))


# -------------------------------------------------------------- handler

class StructuredLogHandler(logging.Handler):
    """Capture every framework record into the ring + level counter.

    emit() is on the path of every log call the process makes, so it
    does the minimum: getMessage, one dict, one deque append, one
    counter bump — and never raises (a broken observability plane must
    not take the serving plane with it)."""

    def __init__(self, ring: Optional[LogRecordRing] = None) -> None:
        super().__init__(level=logging.DEBUG)
        self._ring = ring

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry: Dict[str, Any] = {
                'ts': record.created,
                'level': record.levelname,
                'levelno': record.levelno,
                'logger': record.name,
                'msg': record.getMessage(),
            }
            entry.update(_process_identity)
            bound = _CTX.get()
            if bound:
                entry.update(bound)
            (self._ring or get_ring()).add(entry)
            _records_counter().labels(level=record.levelname).inc()
        except Exception:  # pylint: disable=broad-except
            pass


# ----------------------------------------------------------- access logs

# Scrape/probe hot paths whose per-request access lines log at DEBUG:
# the controller polls them every few seconds and the ring must not be
# wall-to-wall scrape noise.  Generation routes stay at INFO.
HEALTH_ROUTE = http_protocol.HEALTH
PROBE_ROUTES = (HEALTH_ROUTE, http_protocol.METRICS,
                http_protocol.SPANS, http_protocol.PROFILE,
                http_protocol.LOGS)


def access_log(logger: logging.Logger, method: str, route: str,
               code: int) -> None:
    """Count + log one served HTTP request.  `route` must be the
    matched route constant, never the raw path (label cardinality)."""
    try:
        _http_counter().labels(route=route, code=str(code)).inc()
    except Exception:  # pylint: disable=broad-except
        pass
    level = logging.DEBUG if route in PROBE_ROUTES else logging.INFO
    logger.log(level, f'{method} {route} -> {code}')


_install_lock = threading.Lock()


def install() -> logging.Logger:
    """Attach one StructuredLogHandler to the package logger (idempotent;
    the reference's sky_logging does the same at its first logger).  A
    package logger left at NOTSET is set to INFO, the reference's
    default, so INFO access lines reach the ring."""
    package = logging.getLogger(PACKAGE_LOGGER)
    with _install_lock:
        if not any(isinstance(h, StructuredLogHandler)
                   for h in package.handlers):
            package.addHandler(StructuredLogHandler())
        if package.level == logging.NOTSET:
            package.setLevel(logging.INFO)
    return package
