"""Request tracing: ids, per-request spans, and timeline emission (a copy
of `skypilot_tpu/observability/tracing.py`: the same span fields and
`to_dict()` / segment keys, so the reference's trace assembly reads the
port's `GET /spans`).

Answers "why was THIS request slow": every request carries an id (the
`X-SkyTPU-Request-Id` header, generated at the outermost layer that
sees the request — load balancer, else server front, else engine) and
the batching engine records a `RequestSpan` per request with the
phase breakdown a serving SLO decomposes into:

    queue_wait  — submit() until the engine pops the request
    prefill     — chunked prompt prefill (count + total seconds)
    ttft        — submit() until the first generated token
    itl         — inter-token gaps during decode (count/mean/max)
    total       — submit() until the request finished

Finished spans land in a bounded `SpanStore` (newest-first, surfaced
through `engine.stats()['recent_spans']` → `/health`) and are emitted
into the Chrome-trace timeline (utils/timeline.py) as `X` complete
events, so `SKYTPU_TIMELINE_FILE=trace.json` shows per-request
queue/prefill/decode bars next to the control-plane spans.

Span bookkeeping is mutation-from-one-thread (the engine worker) plus
read-from-any (stats()); the store's lock covers the handoff.

Fleet telemetry turns these per-process spans into *trace
segments*: every process exports its spans through `GET /spans` (the
replica fronts) / `GET /lb/spans` (the load balancer), each segment
tagged with process identity (`process`, `replica_id`, `role`) and the
LB `attempt` number, so `sky serve trace <request-id>` can stitch one
request's life across the disaggregated fleet
(observability/traces.py does the assembly).
"""
from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Any, Deque, Dict, List, Optional

from skypilot_tpu_torch.serve import http_protocol
from skypilot_tpu_torch.utils import timeline

# Propagated load_balancer -> model_server/async_server -> engine slot;
# servers echo it on the response so clients can correlate.
# (Re-exported from the canonical serve/http_protocol.py module.)
REQUEST_ID_HEADER = http_protocol.REQUEST_ID_HEADER

# Spans kept per store; old spans fall off (a replica serving millions
# of requests must not grow without bound).
DEFAULT_STORE_SIZE = 256
# Spans inlined into stats() -> /health (the store keeps more).
STATS_SPAN_LIMIT = 8


def new_request_id() -> str:
    """16 hex chars: unique enough per fleet, short enough for logs."""
    return uuid.uuid4().hex[:16]


def parse_span_query(query: str) -> Dict[str, Any]:
    """`GET /spans` / `GET /lb/spans` query args -> export kwargs
    (`since`, `request_id`, `limit`); malformed values are ignored,
    not 400s — the trace CLI must degrade, never fail, on version
    skew."""
    from urllib.parse import parse_qs  # pylint: disable=import-outside-toplevel
    parsed = parse_qs(query or '')
    out: Dict[str, Any] = {}
    if parsed.get('request_id'):
        out['request_id'] = parsed['request_id'][0]
    for key in ('since', 'limit'):
        if parsed.get(key):
            try:
                value = float(parsed[key][0])
                out[key] = int(value) if key == 'limit' else value
            except ValueError:
                pass
    return out


class RequestSpan:
    """Phase timings of one serving request (times are monotonic
    internally; wall-clock start is kept for the timeline)."""

    def __init__(self, request_id: Optional[str] = None) -> None:
        self.request_id = request_id or new_request_id()
        self.submit_wall = time.time()
        self._submit = time.monotonic()
        self.queue_wait_s: Optional[float] = None
        self.prefill_chunks = 0
        self.prefill_s = 0.0
        # Prompt pages adopted from the engine's prefix cache instead
        # of prefilled (paged-KV engines; 0 = cold / dense engine).
        self.prefix_hit_pages = 0
        # Router facts (disaggregated serving): which role pool the LB
        # picked, whether prefix affinity hit, and how long the KV
        # page handoff took.  None when the request bypassed the LB.
        self.routed_role: Optional[str] = None
        self.affinity_hit: Optional[bool] = None
        self.handoff_ms: Optional[float] = None
        # LB retry attempt that produced this span (X-SkyTPU-Attempt).
        # The router's one-shot same-role retry reuses the request id
        # on a SECOND replica; without the attempt tag the two
        # processes' spans conflate on assembly.  None = not LB-routed
        # (reads as attempt 0).
        self.attempt: Optional[int] = None
        # Multi-host slice replicas: mean coordinated-tick sync
        # overhead (rank-0 broadcast until every rank acked) while this
        # request was in flight.  None on single-host replicas.
        self.slice_sync_ms: Optional[float] = None
        # Self-speculative decoding (engines with --spec-tokens > 0):
        # verify ticks this request rode, draft tokens proposed for it,
        # and drafts accepted — the per-request acceptance story behind
        # the engine-level skytpu_engine_spec_* counters.  All stay 0
        # (and the dict fields absent) when spec decoding is off.
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # Which weight epoch served this request (live weight swap:
        # POST /weights_swap bumps the engine's epoch; every span
        # records the epoch in force at submit so batch output rows
        # can attribute each generation to a checkpoint).  None on
        # engines predating the swap path.
        self.weight_epoch: Optional[int] = None
        self.ttft_s: Optional[float] = None
        self._last_token: Optional[float] = None
        self.itl_count = 0
        self.itl_sum_s = 0.0
        self.itl_max_s = 0.0
        self.tokens = 0
        self.total_s: Optional[float] = None
        self.status: Optional[str] = None

    # ----------------------------------------------- recording (engine)

    def mark_admitted(self) -> None:
        if self.queue_wait_s is None:
            self.queue_wait_s = time.monotonic() - self._submit

    def mark_prefill_chunk(self, duration_s: float) -> None:
        self.prefill_chunks += 1
        self.prefill_s += duration_s

    def mark_token(self) -> Optional[float]:
        """Record one generated token; returns the inter-token gap in
        seconds (None for the first token — that one sets TTFT)."""
        now = time.monotonic()
        self.tokens += 1
        gap: Optional[float] = None
        if self.ttft_s is None:
            self.ttft_s = now - self._submit
        elif self._last_token is not None:
            gap = now - self._last_token
            self.itl_count += 1
            self.itl_sum_s += gap
            self.itl_max_s = max(self.itl_max_s, gap)
        self._last_token = now
        return gap

    def finish(self, status: str = 'ok') -> None:
        if self.total_s is not None:
            return  # idempotent like _Request._finish
        self.total_s = time.monotonic() - self._submit
        self.status = status
        self._emit_timeline()

    # ------------------------------------------------------------ output

    def to_dict(self) -> Dict[str, Any]:
        def ms(v: Optional[float]) -> Optional[float]:
            return None if v is None else round(v * 1e3, 3)

        itl_mean = (self.itl_sum_s / self.itl_count
                    if self.itl_count else None)
        out = {
            'request_id': self.request_id,
            'submit_time': self.submit_wall,
            'status': self.status,
            'queue_wait_ms': ms(self.queue_wait_s),
            'prefill_chunks': self.prefill_chunks,
            'prefill_ms': ms(self.prefill_s),
            'prefix_hit_pages': self.prefix_hit_pages,
            'ttft_ms': ms(self.ttft_s),
            'itl_mean_ms': ms(itl_mean),
            'itl_max_ms': ms(self.itl_max_s if self.itl_count else None),
            'tokens': self.tokens,
            'total_ms': ms(self.total_s),
        }
        # Router fields appear only for LB-routed requests: span dicts
        # predating disaggregation keep their exact shape.
        if self.routed_role is not None:
            out['routed_role'] = self.routed_role
        if self.affinity_hit is not None:
            out['affinity_hit'] = self.affinity_hit
        if self.handoff_ms is not None:
            out['handoff_ms'] = round(self.handoff_ms, 3)
        if self.slice_sync_ms is not None:
            out['slice_sync_ms'] = round(self.slice_sync_ms, 3)
        if self.attempt is not None:
            out['attempt'] = self.attempt
        if self.weight_epoch is not None:
            out['weight_epoch'] = self.weight_epoch
        if self.spec_steps:
            out['spec_steps'] = self.spec_steps
            out['spec_proposed'] = self.spec_proposed
            out['spec_accepted'] = self.spec_accepted
            # Mean tokens emitted per verify tick (>= 1.0; the verified
            # base token always emits, accepted drafts ride on top).
            out['spec_accept_mean'] = round(
                (self.spec_accepted + self.spec_steps) /
                self.spec_steps, 3)
        return out

    def segment(self, identity: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """This span as a trace segment: the cross-process exchange
        format of `GET /spans` (see observability/traces.py).  The
        phase sub-spans mirror `_emit_timeline`'s bars so the stitched
        waterfall and the live timeline agree."""
        seg: Dict[str, Any] = dict(identity or {})
        seg.setdefault('process', 'replica')
        seg.setdefault('name', 'engine')
        seg.update(self.to_dict())
        seg['attempt'] = self.attempt or 0
        seg['start'] = self.submit_wall
        seg['duration_ms'] = seg.pop('total_ms', None)
        phases: List[Dict[str, Any]] = []
        wall0 = self.submit_wall
        if self.queue_wait_s:
            phases.append({'name': 'queue', 'start': wall0,
                           'duration_ms': round(
                               self.queue_wait_s * 1e3, 3)})
        if self.prefill_s:
            phases.append({'name': 'prefill',
                           'start': wall0 + (self.queue_wait_s or 0.0),
                           'duration_ms': round(self.prefill_s * 1e3,
                                                3)})
        if self.ttft_s is not None and self.total_s is not None:
            phases.append({'name': 'decode',
                           'start': wall0 + self.ttft_s,
                           'duration_ms': round(
                               (self.total_s - self.ttft_s) * 1e3, 3)})
        seg['phases'] = phases
        return seg

    def _emit_timeline(self) -> None:
        if not timeline.enabled():
            return
        base = f'request:{self.request_id}'
        wall0 = self.submit_wall
        timeline.add_complete_event(
            base, wall0, self.total_s or 0.0,
            args={k: v for k, v in self.to_dict().items()
                  if v is not None})
        if self.queue_wait_s:
            timeline.add_complete_event(f'{base}/queue', wall0,
                                        self.queue_wait_s)
        if self.ttft_s is not None:
            # Prefill runs between admission and first token; the span
            # bar shows its aggregate (chunks interleave with ticks, so
            # a contiguous bar is an approximation labeled as such).
            if self.prefill_s:
                timeline.add_complete_event(
                    f'{base}/prefill',
                    wall0 + (self.queue_wait_s or 0.0), self.prefill_s,
                    args={'chunks': self.prefill_chunks})
            decode_s = (self.total_s or self.ttft_s) - self.ttft_s
            timeline.add_complete_event(
                f'{base}/decode', wall0 + self.ttft_s, decode_s,
                args={'tokens': self.tokens})


class SpanStore:
    """Bounded newest-first store of finished spans."""

    def __init__(self, maxlen: int = DEFAULT_STORE_SIZE) -> None:
        self._spans: Deque[RequestSpan] = collections.deque(
            maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, span: RequestSpan) -> None:
        with self._lock:
            self._spans.append(span)

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for span in reversed(self._spans):
                if span.request_id == request_id:
                    return span.to_dict()
        return None

    def recent(self, n: int = STATS_SPAN_LIMIT) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(self._spans)[-n:]
        return [s.to_dict() for s in reversed(spans)]

    def export(self, identity: Optional[Dict[str, Any]] = None,
               since: Optional[float] = None,
               request_id: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Finished spans as identity-tagged trace segments (the
        `GET /spans?since=&request_id=` payload), oldest first."""
        with self._lock:
            spans = list(self._spans)
        out = []
        for span in spans:
            if since is not None and span.submit_wall < since:
                continue
            if request_id is not None and \
                    span.request_id != request_id:
                continue
            out.append(span.segment(identity))
        if limit is not None:
            out = out[-int(limit):]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class SegmentStore:
    """Bounded store of already-built trace segments (plain dicts).

    The LB and the handoff endpoints record here: their work is not an
    engine request (no RequestSpan exists), but it IS a leg of some
    request's life — `/prefill_export` on the prefill replica, the
    route/handoff/attempt phases on the LB.  Same export contract as
    SpanStore so `sky serve trace` stitches both."""

    def __init__(self, maxlen: int = DEFAULT_STORE_SIZE) -> None:
        self._segments: Deque[Dict[str, Any]] = collections.deque(
            maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, segment: Dict[str, Any]) -> None:
        with self._lock:
            self._segments.append(segment)

    def export(self, since: Optional[float] = None,
               request_id: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            segments = list(self._segments)
        out = []
        for seg in segments:
            if since is not None and seg.get('start', 0.0) < since:
                continue
            if request_id is not None and \
                    seg.get('request_id') != request_id:
                continue
            out.append(dict(seg))
        if limit is not None:
            out = out[-int(limit):]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._segments)
